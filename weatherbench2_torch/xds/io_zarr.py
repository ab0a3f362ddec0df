"""Zarr v2 directory stores in plain numpy, for the PyTorch port.

The JAX package opens stores through tensorstore; the port's machines have
neither tensorstore nor a blosc codec, so this module reads and writes the
on-disk format itself: ``.zgroup``/``.zattrs``/``.zarray`` JSON, one file
per chunk, compressor ``null`` or ``zlib`` (stdlib).  It follows the same
xarray convention as ``weatherbench2_tpu/xds/io_zarr.py`` (an
``_ARRAY_DIMENSIONS`` attribute per array, CF-encoded datetimes as int64
with a ``units`` attribute, string arrays as JSON in the group attrs under
``_xds_string_arrays``), so stores written here open in the JAX package and
uncompressed JAX-written stores open here.  Local paths only.
"""
from __future__ import annotations

import itertools
import json
import os
import zlib
from typing import Any, Mapping, Optional

import numpy as np

from . import core

_CF_UNITS = {
    "nanoseconds": "ns",
    "microseconds": "us",
    "milliseconds": "ms",
    "seconds": "s",
    "minutes": "m",
    "hours": "h",
    "days": "D",
}

# Fallback classification for stores with no "coordinates" declarations.
KNOWN_COORD_NAMES = {
    "latitude", "longitude", "level", "time", "init_time", "valid_time",
    "lead_time", "prediction_timedelta", "dayofyear", "hour", "quantile",
    "realization", "number", "metric", "region", "bins", "zonal_wavenumber",
    "wavelength", "frequency",
}


def encode_cf(values: np.ndarray):
  """Encode datetime64/timedelta64 as (int64 ns, CF attrs)."""
  if np.issubdtype(values.dtype, np.datetime64):
    data = values.astype("datetime64[ns]").astype(np.int64)
    return data, {"units": "nanoseconds since 1970-01-01",
                  "calendar": "proleptic_gregorian"}
  if np.issubdtype(values.dtype, np.timedelta64):
    return values.astype("timedelta64[ns]").astype(np.int64), {
        "units": "nanoseconds"}
  return values, {}


def _offsets_to_ns(data: np.ndarray, step_ns: int) -> np.ndarray:
  """CF offsets × unit-in-ns → int64 ns; float NaN fills map to NaT."""
  if np.issubdtype(data.dtype, np.floating):
    ns = np.asarray(data, np.float64) * step_ns
    return np.where(np.isnan(ns), np.iinfo(np.int64).min,
                    np.round(ns)).astype(np.int64)
  return data.astype(np.int64) * step_ns


def decode_cf(data: np.ndarray, attrs: Mapping[str, Any]) -> np.ndarray:
  """CF-decode numeric offsets with a time ``units`` attribute."""
  units = attrs.get("units")
  if not isinstance(units, str):
    return data
  parts = units.split(" since ")
  if len(parts) == 2:
    np_unit = _CF_UNITS.get(parts[0].strip())
    if np_unit is None:
      return data
    epoch64 = np.datetime64(parts[1].strip().replace(" ", "T"), "ns")
    step_ns = int(np.timedelta64(1, np_unit) // np.timedelta64(1, "ns"))
    ns = _offsets_to_ns(data, step_ns)
    vals = (epoch64.astype(np.int64) + ns).astype("datetime64[ns]")
    if np.issubdtype(data.dtype, np.floating):
      vals = np.where(ns == np.iinfo(np.int64).min,
                      np.datetime64("NaT", "ns"), vals)
    return vals.astype("datetime64[ns]")
  np_unit = _CF_UNITS.get(units.strip())
  if np_unit is not None and data.dtype.kind in "iuf":
    step_ns = int(np.timedelta64(1, np_unit) // np.timedelta64(1, "ns"))
    return _offsets_to_ns(data, step_ns).astype("timedelta64[ns]")
  return data


def merged_cf_attrs(var_attrs, cf_attrs) -> dict:
  """A variable's attrs with fresh CF attrs that evict stale units."""
  out = dict(var_attrs)
  if cf_attrs:
    out.pop("units", None)
    out.pop("calendar", None)
    out.update(cf_attrs)
  return out


def _read_json(path: str):
  if not os.path.exists(path):
    return None
  with open(path) as f:
    return json.load(f)


def _write_json(path: str, obj) -> None:
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, "w") as f:
    f.write(json.dumps(obj, indent=2, default=str))


def _compressor_meta(compressor):
  if compressor in (None, "none"):
    return None
  if compressor == "zlib":
    return {"id": "zlib", "level": 1}
  raise ValueError(
      f"unknown compressor {compressor!r}; options: None, 'zlib'")


class ZarrArray:
  """One zarr v2 array on disk: metadata plus chunk-file reads and writes."""

  def __init__(self, store: str, name: str, meta: Mapping[str, Any]):
    self.store = store
    self.name = name
    self.path = os.path.join(store, name)
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") not in ("zlib", "gzip"):
      raise ValueError(
          f"zarr store {store!r} array {name!r} uses compressor "
          f"{comp.get('id')!r} ({comp}); this reader decodes only "
          "uncompressed and zlib/gzip chunks. Rewrite the store "
          "uncompressed (the JAX package writes one under "
          "WB2_ZARR_COMPRESSOR=none)."
      )
    if meta.get("filters"):
      raise ValueError(f"zarr store {store!r} array {name!r} uses filters "
                       f"{meta['filters']}, which this reader cannot decode")
    if meta.get("order", "C") != "C":
      raise ValueError(f"zarr store {store!r} array {name!r} is in "
                       "Fortran order, which this reader does not support")
    self.compressor = comp
    self.shape = tuple(int(s) for s in meta["shape"])
    self.chunks = tuple(int(c) for c in meta["chunks"]) or ()
    self.dtype = np.dtype(meta["dtype"])
    self.sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    if fill in ("NaN", "nan"):
      fill = np.nan
    elif fill in ("Infinity", "-Infinity"):
      fill = np.inf if fill == "Infinity" else -np.inf
    self.fill_value = 0 if fill is None else fill

  def _chunk_path(self, idx) -> str:
    key = self.sep.join(str(i) for i in idx) if idx else "0"
    return os.path.join(self.path, key)

  def _read_chunk(self, idx) -> np.ndarray:
    shape = self.chunks if self.shape else ()
    path = self._chunk_path(idx)
    if not os.path.exists(path):
      return np.full(shape, self.fill_value, dtype=self.dtype)
    with open(path, "rb") as f:
      raw = f.read()
    if self.compressor is not None:
      raw = zlib.decompress(raw, 31 if self.compressor["id"] == "gzip"
                            else 15)
    return np.frombuffer(raw, dtype=self.dtype).reshape(shape)

  def _write_chunk(self, idx, arr: np.ndarray) -> None:
    raw = np.ascontiguousarray(arr, dtype=self.dtype).tobytes()
    if self.compressor is not None:
      raw = zlib.compress(raw, self.compressor.get("level", 1))
    path = self._chunk_path(idx)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
      f.write(raw)
    os.replace(tmp, path)

  def _chunk_ranges(self, box):
    """Per-axis chunk indices overlapping the [lo, hi) box."""
    return [range(lo // c, -(-hi // c)) if hi > lo else range(0)
            for (lo, hi), c in zip(box, self.chunks)]

  def read_box(self, box) -> np.ndarray:
    """The [lo, hi) box (one pair per axis), reading only its chunks."""
    out = np.empty(tuple(hi - lo for lo, hi in box), dtype=self.dtype)
    if not self.shape:
      return self._read_chunk(()).copy()
    for idx in itertools.product(*self._chunk_ranges(box)):
      src, dst, whole = [], [], True
      for ax, i in enumerate(idx):
        c0 = i * self.chunks[ax]
        lo = max(box[ax][0], c0)
        hi = min(box[ax][1], c0 + self.chunks[ax])
        src.append(slice(lo - c0, hi - c0))
        dst.append(slice(lo - box[ax][0], hi - box[ax][0]))
        whole = whole and hi - lo == self.chunks[ax]
      target = out[tuple(dst)]
      path = self._chunk_path(idx)
      if (whole and self.compressor is None and target.flags.c_contiguous
          and os.path.exists(path)):
        # an uncompressed chunk that fills a contiguous part of the box:
        # read the file straight into place
        with open(path, "rb") as f:
          n = f.readinto(memoryview(target).cast("B"))
        if n != target.nbytes:
          raise ValueError(f"zarr chunk {path!r} holds {n} bytes, "
                           f"expected {target.nbytes}")
        continue
      target[...] = self._read_chunk(idx)[tuple(src)]
    return out

  def write_box(self, box, data: np.ndarray) -> None:
    """Write ``data`` into the [lo, hi) box; partial chunks read-modify-write."""
    data = np.asarray(data, dtype=self.dtype)
    if not self.shape:
      self._write_chunk((), data.reshape(()))
      return
    for idx in itertools.product(*self._chunk_ranges(box)):
      src, dst, full = [], [], True
      for ax, i in enumerate(idx):
        c0 = i * self.chunks[ax]
        c1 = min(c0 + self.chunks[ax], self.shape[ax])
        lo = max(box[ax][0], c0)
        hi = min(box[ax][1], c0 + self.chunks[ax])
        src.append(slice(lo - box[ax][0], hi - box[ax][0]))
        dst.append(slice(lo - c0, hi - c0))
        full = full and lo == c0 and hi == c1
      chunk = (np.full(self.chunks, self.fill_value, dtype=self.dtype)
               if full else self._read_chunk(idx).copy())
      chunk[tuple(dst)] = data[tuple(src)]
      self._write_chunk(idx, chunk)


def _basic_box(shape, key):
  """(box, post) for a key of ints/slices: the bounding box to read and the
  key that applies to the box (negative steps and ints stay numpy's)."""
  box, post = [], []
  for n, k in zip(shape, key):
    if isinstance(k, slice):
      r = range(n)[k]
      if not len(r):
        box.append((0, 0))
        post.append(slice(0, 0))
        continue
      lo, hi = min(r[0], r[-1]), max(r[0], r[-1]) + 1
      box.append((lo, hi))
      stop = r[-1] - lo + (1 if r.step > 0 else -1)
      post.append(slice(r[0] - lo, None if stop < 0 else stop, r.step))
    else:
      i = int(k) + (n if int(k) < 0 else 0)
      if not 0 <= i < n:
        raise IndexError(f"index {k} out of range for axis of size {n}")
      box.append((i, i + 1))
      post.append(0)
  return box, tuple(post)


class LazyArray(core.LazyArrayBase):
  """Lazily-sliced zarr array payload.

  A view is one ``range`` (kept axis) or ``int`` (dropped axis) per axis
  of the stored array.  Basic indexing composes ranges, so a chunk slice of
  a multi-GB variable costs nothing until it is materialized, and then only
  the chunk files under its bounding box are read.  Integer-array indexing
  reads the bounding box and gathers in numpy.  ``__array__`` applies the
  CF decode.
  """

  __slots__ = ("_arr", "_view", "_attrs", "dtype")

  def __init__(self, arr: ZarrArray, attrs, dtype, view=None):
    self._arr = arr
    self._attrs = attrs
    self.dtype = np.dtype(dtype)
    self._view = (tuple(range(n) for n in arr.shape) if view is None
                  else view)

  @property
  def shape(self):
    return tuple(len(v) for v in self._view if isinstance(v, range))

  @property
  def ndim(self):
    return len(self.shape)

  @property
  def size(self):
    return int(np.prod(self.shape)) if self.shape else 1

  def _materialize(self) -> np.ndarray:
    key = tuple(slice(v.start, v.stop if v.stop >= 0 else None, v.step)
                if isinstance(v, range) else v for v in self._view)
    box, post = _basic_box(self._arr.shape, key)
    return decode_cf(self._arr.read_box(box)[post], self._attrs)

  def __array__(self, dtype=None, copy=None):
    out = self._materialize()
    return out.astype(dtype) if dtype is not None else out

  def __getitem__(self, key):
    if not isinstance(key, tuple):
      key = (key,)
    if any(k is Ellipsis for k in key):
      i = key.index(Ellipsis)
      key = key[:i] + (slice(None),) * (self.ndim - len(key) + 1) + key[i + 1:]
    key = key + (slice(None),) * (self.ndim - len(key))
    if all(isinstance(k, (int, np.integer, slice)) for k in key):
      it = iter(key)
      view = tuple(v[next(it)] if isinstance(v, range) else v
                   for v in self._view)
      return LazyArray(self._arr, self._attrs, self.dtype, view)
    # advanced indexing: read the bounding slice, gather in numpy
    bound, inner = [], []
    for k in key:
      if isinstance(k, (int, np.integer, slice)):
        bound.append(k)
        if isinstance(k, slice):
          inner.append(slice(None))
        continue
      arr = np.asarray(k)
      if arr.dtype == bool:
        arr = np.nonzero(arr)[0]
      if arr.size == 0:
        bound.append(slice(0, 0))
        inner.append(slice(None))
        continue
      lo, hi = int(arr.min()), int(arr.max())
      bound.append(slice(lo, hi + 1))
      inner.append(arr - lo)
    return np.asarray(self[tuple(bound)])[tuple(inner)]

  def __repr__(self):
    return f"LazyArray(shape={self.shape}, dtype={self.dtype})"


def _var_chunks(shape, chunks_spec, dims):
  if chunks_spec is None:
    return [max(1, s) for s in shape]
  out = []
  for d, s in zip(dims, shape):
    c = chunks_spec.get(d, -1)
    out.append(s if c in (-1, None) else min(c, max(s, 1)))
  return [max(1, c) for c in out]


def _array_meta(shape, chunks, dtype, compressor, fill_value=None):
  return {
      "shape": list(shape),
      "chunks": list(chunks) if shape else [],
      "dtype": np.dtype(dtype).newbyteorder("<").str,
      "compressor": _compressor_meta(compressor),
      "fill_value": fill_value,
      "filters": None,
      "order": "C",
      "zarr_format": 2,
  }


class _StoreWriter:
  """Group-level bookkeeping shared by to_zarr and create_zarr_template."""

  def __init__(self, ds: core.Dataset, path: str, chunks, compressor):
    os.makedirs(path, exist_ok=True)
    self.path = path
    self.chunks = chunks
    self.compressor = compressor
    self.group_attrs: dict[str, Any] = dict(ds.attrs)
    self.string_arrays: dict[str, Any] = {}
    self.consolidated: dict[str, Any] = {".zgroup": {"zarr_format": 2}}
    self.nondim_coords = [n for n, v in ds.coords_dict().items()
                          if n not in v.dims]
    _write_json(os.path.join(path, ".zgroup"), {"zarr_format": 2})

  def create(self, name, var, is_coord, dtype, cf_attrs, chunks,
             fill_value=None) -> ZarrArray:
    meta = _array_meta(var.shape, chunks, dtype, self.compressor, fill_value)
    zattrs = {"_ARRAY_DIMENSIONS": list(var.dims),
              **merged_cf_attrs(var.attrs, cf_attrs)}
    if not is_coord and self.nondim_coords:
      zattrs.setdefault("coordinates", " ".join(self.nondim_coords))
    arr_dir = os.path.join(self.path, name)
    if os.path.isdir(arr_dir):
      for entry in os.listdir(arr_dir):
        os.remove(os.path.join(arr_dir, entry))
    _write_json(os.path.join(arr_dir, ".zarray"), meta)
    _write_json(os.path.join(arr_dir, ".zattrs"), zattrs)
    self.consolidated[f"{name}/.zarray"] = meta
    self.consolidated[f"{name}/.zattrs"] = zattrs
    return ZarrArray(self.path, name, meta)

  def add_string_array(self, name, var, values, is_coord):
    self.string_arrays[name] = {
        "dims": list(var.dims),
        "values": np.asarray(values, dtype=str).tolist(),
        "coord": is_coord,
    }

  def finish(self):
    if self.string_arrays:
      self.group_attrs["_xds_string_arrays"] = self.string_arrays
    _write_json(os.path.join(self.path, ".zattrs"), self.group_attrs)
    self.consolidated[".zattrs"] = self.group_attrs
    _write_json(os.path.join(self.path, ".zmetadata"),
                {"metadata": self.consolidated,
                 "zarr_consolidated_format": 1})


def to_zarr(
    ds: core.Dataset,
    path: str,
    chunks: Optional[Mapping[str, int]] = None,
    compressor=None,
) -> None:
  """Write a Dataset to a local zarr v2 store (uncompressed by default)."""
  w = _StoreWriter(ds, path, chunks, compressor)
  all_vars = [(n, v, True) for n, v in ds.coords_dict().items()]
  all_vars += [(n, v, False) for n, v in ds.variables_dict().items()]
  for name, var, is_coord in all_vars:
    values = core._to_numpy(var.data)
    if values.dtype.kind in ("U", "O", "S"):
      w.add_string_array(name, var, values, is_coord)
      continue
    data, cf_attrs = encode_cf(values)
    arr = w.create(name, var, is_coord, data.dtype, cf_attrs,
                   _var_chunks(data.shape, chunks, var.dims))
    arr.write_box([(0, n) for n in data.shape], data)
  w.finish()


def create_zarr_template(
    ds: core.Dataset,
    path: str,
    chunks: Optional[Mapping[str, int]] = None,
    compressor=None,
) -> None:
  """Create a store with coords written and data variables unwritten.

  Float variables get fill_value NaN, so unwritten regions read as NaN
  (the idempotent template + region-write output model).
  """
  w = _StoreWriter(ds, path, chunks, compressor)
  for name, var in ds.coords_dict().items():
    values = core._to_numpy(var.data)
    if values.dtype.kind in ("U", "O", "S"):
      w.add_string_array(name, var, values, True)
      continue
    data, cf_attrs = encode_cf(values)
    arr = w.create(name, var, True, data.dtype, cf_attrs,
                   [max(1, s) for s in data.shape])
    arr.write_box([(0, n) for n in data.shape], data)
  for name, var in ds.variables_dict().items():
    dtype = np.dtype(var.dtype)
    cf_attrs = {}
    if dtype.kind in "Mm":
      cf_attrs = encode_cf(np.zeros((), dtype))[1]
      dtype = np.dtype(np.int64)
    w.create(name, var, False, dtype, cf_attrs,
             _var_chunks(var.shape, chunks, var.dims),
             fill_value="NaN" if dtype.kind == "f" else None)
  w.finish()


def open_zarr_array(path: str, name: str) -> ZarrArray:
  meta = _read_json(os.path.join(path, name, ".zarray"))
  if meta is None:
    raise FileNotFoundError(f"no zarr array {name!r} in {path!r}")
  return ZarrArray(path, name, meta)


def open_zarr(path: str, lazy: bool = False) -> core.Dataset:
  """Open a local zarr v2 group as a Dataset.

  With ``lazy=True`` data variables are LazyArray views: coordinates load
  eagerly (they drive host-side selection), while variable bytes are read
  only when a concrete chunk-sized slice is materialized.
  """
  if not os.path.isdir(path):
    raise FileNotFoundError(f"zarr store {path!r} does not exist")
  consolidated = _read_json(os.path.join(path, ".zmetadata"))
  zarrays: dict[str, dict] = {}
  entries: dict[str, dict] = {}
  if consolidated is not None:
    meta = consolidated["metadata"]
    group_attrs = dict(meta.get(".zattrs", {}))
    for key, val in meta.items():
      if key.endswith("/.zattrs"):
        entries[key[:-len("/.zattrs")]] = val
      elif key.endswith("/.zarray"):
        zarrays[key[:-len("/.zarray")]] = val
  else:
    group_attrs = _read_json(os.path.join(path, ".zattrs")) or {}
    for name in sorted(os.listdir(path)):
      z = _read_json(os.path.join(path, name, ".zarray"))
      if z is not None:
        zarrays[name] = z
        entries[name] = _read_json(os.path.join(path, name, ".zattrs")) or {}

  string_arrays = group_attrs.pop("_xds_string_arrays", {})
  dim_names: set[str] = set()
  declared_coords: set[str] = set()
  has_declarations = False
  group_coords_attr = group_attrs.pop("coordinates", None)
  if group_coords_attr:
    has_declarations = True
    declared_coords.update(str(group_coords_attr).split())
  arrays: dict[str, tuple[ZarrArray, dict, tuple]] = {}
  for name, zattrs in entries.items():
    if "_ARRAY_DIMENSIONS" not in zattrs:
      continue
    attrs = dict(zattrs)
    dims = tuple(attrs.pop("_ARRAY_DIMENSIONS"))
    dim_names.update(dims)
    if attrs.get("coordinates") is not None:
      has_declarations = True
      declared_coords.update(str(attrs["coordinates"]).split())
    zmeta = zarrays.get(name) or _read_json(
        os.path.join(path, name, ".zarray"))
    arrays[name] = (ZarrArray(path, name, zmeta), attrs, dims)

  def is_coord_name(name: str) -> bool:
    # xarray rule: dimension coordinates by name; other coords only when
    # declared via the CF "coordinates" attribute
    if name in dim_names:
      return True
    if has_declarations:
      return name in declared_coords
    return name in KNOWN_COORD_NAMES

  def attrs_after_decode(attrs, decoded_dtype):
    # CF units consumed by the decode are encoding, not attributes
    if np.dtype(decoded_dtype).kind in "Mm":
      return {k: v for k, v in attrs.items() if k not in ("units", "calendar")}
    return dict(attrs)

  coords, data_vars = {}, {}
  for name, (arr, attrs, dims) in arrays.items():
    if lazy and not is_coord_name(name):
      dtype = decode_cf(np.zeros((), arr.dtype), attrs).dtype
      data = LazyArray(arr, attrs, dtype)
    else:
      data = decode_cf(arr.read_box([(0, n) for n in arr.shape]), attrs)
      dtype = data.dtype
    attrs = attrs_after_decode(attrs, dtype)
    attrs.pop("coordinates", None)
    v = core.Variable(dims, data, attrs)
    (coords if is_coord_name(name) else data_vars)[name] = v
  for name, spec in string_arrays.items():
    v = core.Variable(tuple(spec["dims"]),
                      np.asarray(spec["values"], dtype=object))
    is_coord = spec.get("coord")
    if is_coord or name in dim_names or (
        is_coord is None and name in KNOWN_COORD_NAMES):
      coords[name] = v
    else:
      data_vars[name] = v
  return core.Dataset(data_vars, coords=coords, attrs=group_attrs)

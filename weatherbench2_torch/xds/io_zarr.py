"""Zarr v2 directory stores in plain numpy, for the PyTorch port.

The JAX package opens stores through tensorstore; the port's machines have
no tensorstore, so this module reads and writes the on-disk format itself:
``.zgroup``/``.zattrs``/``.zarray`` JSON, one file per chunk.  Chunks are
read uncompressed, zlib or gzip (stdlib) or blosc with any of its codecs
and shuffles (the port's own C++ codec, ``xds/_codec.py``); they are written
uncompressed, zlib, blosc-lz4 or blosc-zstd, by default as the JAX package
writes them: ``WB2_ZARR_COMPRESSOR`` (``"zstd3"``, ``"lz4"``, ``"none"``),
else bit-shuffled zstd at clevel 3.  It follows the same xarray convention as
``weatherbench2_tpu/xds/io_zarr.py`` (an ``_ARRAY_DIMENSIONS`` attribute per
array, CF-encoded datetimes as int64 with a ``units`` attribute, string
arrays as JSON in the group attrs under ``_xds_string_arrays``), so stores
written here open in the JAX package and the JAX package's stores, in its
default bit-shuffled zstd too, open here.  Local paths only.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import zlib
from typing import Any, Mapping, Optional

import numpy as np

from . import _codec, core

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


# the counts that the calling thread's reads and decodes are added to
_TALLY = threading.local()


def tallied():
  """The counts of the calling thread's ``tally``, or None."""
  return getattr(_TALLY, "counts", None)


@contextlib.contextmanager
def tally(counts):
  """Add the calling thread's reads and decodes in the ``with`` block to
  ``counts`` (a ``tracing.Counts``: ``read_bytes``, ``read_s``,
  ``decode_bytes``, ``decode_s``) instead of to the tally it was in; None
  adds them to none.  A staging task adds its reads and decodes to the
  tally of the thread that made it, wherever it runs."""
  outer = tallied()
  _TALLY.counts = counts
  try:
    yield counts
  finally:
    _TALLY.counts = outer


class _Counter:
  """Bytes and seconds summed over every thread that counts; a counter
  with a ``key`` also adds them to the calling thread's tally."""

  key = None

  def __init__(self):
    self._lock = threading.Lock()
    self.bytes = 0
    self.seconds = 0.0

  def add(self, n: int, seconds: float = 0.0) -> None:
    counts = tallied() if self.key else None
    with self._lock:
      self.bytes += int(n)
      self.seconds += seconds
      if counts is not None:
        counts.add({f"{self.key}_bytes": int(n), f"{self.key}_s": seconds})

  def reset(self) -> None:
    """Zero the sums."""
    with self._lock:
      self.bytes = 0
      self.seconds = 0.0


class ReadCounter(_Counter):
  """Bytes read from chunk files and the seconds their opens and reads
  took (decoding is not in it), summed over every thread that reads."""

  key = "read"


class DecodeCounter(_Counter):
  """Bytes decoded from compressed chunks and the seconds the decoding took,
  summed over every thread that decodes (reading the file is not in it)."""

  key = "decode"


class WriteCounter(_Counter):
  """Files this module writes (chunks and metadata): ``bytes`` as stored
  and ``seconds`` of their opens, writes and renames, summed over every
  thread that writes; of the chunks, the decoded bytes (``decoded``), of
  those the bytes encoded straight from the caller's data with no staged
  chunk (``direct``), and the seconds their encoding took (``encode_s``)."""

  def __init__(self):
    super().__init__()
    self.decoded = 0
    self.direct = 0
    self.encode_s = 0.0

  def add_encoded(self, decoded: int, seconds: float,
                  direct: bool = False) -> None:
    with self._lock:
      self.decoded += int(decoded)
      if direct:
        self.direct += int(decoded)
      self.encode_s += seconds

  def reset(self) -> None:
    super().reset()
    with self._lock:
      self.decoded = 0
      self.direct = 0
      self.encode_s = 0.0


# every chunk-file read of this module counts here (the file's bytes, as
# stored), every decoded chunk in DECODES, and every file written in WRITES
READS = ReadCounter()
DECODES = DecodeCounter()
WRITES = WriteCounter()

BLOSC_CNAMES = ("blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd")
# the queue item of the blosc encoders the port's writer lacks
ENCODER_ITEM = "ROADMAP A.18 (blosclz, lz4hc, snappy and zlib encoders)"
MEMCPYED = 0x02  # blosc header flag: the chunk's bytes stored as they are

# the JAX package's compressor names (weatherbench2_tpu/xds/io_zarr.py)
_COMPRESSORS = {
    # bit-shuffled zstd: best ratio for smooth geophysical fields
    "zstd3": {"id": "blosc", "cname": "zstd", "clevel": 3, "shuffle": 2},
    # fast path: high-entropy data gains nothing from zstd
    "lz4": {"id": "blosc", "cname": "lz4", "clevel": 1, "shuffle": 0},
    "none": None,
}

# Of an uncompressed chunk, the rows a selection needs are read on their
# own when each is at least this long; shorter rows read the whole file.
MIN_PARTIAL_READ_BYTES = 4096


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


def _cf_encoded(attrs: Mapping[str, Any]) -> bool:
  """Whether ``decode_cf`` may give a payload with ``attrs`` other values
  than it holds (a time ``units``)."""
  units = attrs.get("units")
  return isinstance(units, str) and (
      units.split(" since ")[0].strip() in _CF_UNITS)


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
  text = json.dumps(obj, indent=2, default=str)
  t0 = time.perf_counter()
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, "w") as f:
    f.write(text)
  WRITES.add(len(text.encode()), time.perf_counter() - t0)


def default_compressor(compressor="default"):
  """A compressor name resolved to zarr metadata as the JAX package
  resolves it: "default" is ``WB2_ZARR_COMPRESSOR``, else "zstd3"; a dict
  or None passes through."""
  if compressor == "default":
    compressor = os.environ.get("WB2_ZARR_COMPRESSOR", "zstd3")
  if isinstance(compressor, str):
    try:
      return _COMPRESSORS[compressor]
    except KeyError:
      raise ValueError(
          f"unknown compressor {compressor!r}; "
          f"options: {sorted(_COMPRESSORS)}"
      ) from None
  return compressor


def _compressor_meta(compressor):
  """Zarr metadata of a writer's compressor: a name of
  ``default_compressor`` ("default", "zstd3", "lz4", "none"), None, the
  port's "zlib", or a blosc dict with cname lz4 or zstd, clevel 0-9 and
  shuffle 0-2."""
  if compressor == "zlib":
    return {"id": "zlib", "level": 1}
  compressor = default_compressor(compressor)
  if compressor is None:
    return None
  if isinstance(compressor, Mapping) and compressor.get("id") == "blosc":
    cname = compressor.get("cname", "lz4")
    if cname not in _codec.ENCODERS:
      raise ValueError(
          f"compressor {compressor!r}: the port writes blosc with "
          f"{' or '.join(_codec.ENCODERS)}; {cname} waits for {ENCODER_ITEM}")
    meta = {"id": "blosc", "cname": cname,
            "clevel": int(compressor.get("clevel", 5)),
            "shuffle": int(compressor.get("shuffle", 1)),
            "blocksize": int(compressor.get("blocksize", 0))}
    if meta["shuffle"] not in (0, 1, 2) or not 0 <= meta["clevel"] <= 9:
      raise ValueError(f"blosc compressor {compressor!r}: shuffle 0, 1 or "
                       "2 and clevel 0-9")
    return meta
  raise ValueError(
      f"unknown compressor {compressor!r}; options: "
      f"{sorted(_COMPRESSORS)}, 'default', None, 'zlib', "
      "{'id': 'blosc', 'cname': 'lz4'|'zstd', 'clevel': 0-9, "
      "'shuffle': 0|1|2}")


class ZarrArray:
  """One zarr v2 array on disk: metadata plus chunk-file reads and writes."""

  def __init__(self, store: str, name: str, meta: Mapping[str, Any]):
    self.store = store
    self.name = name
    self.path = os.path.join(store, name)
    self.where = f"zarr store {store!r} array {name!r}"
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") == "blosc":
      if comp.get("cname") not in BLOSC_CNAMES:
        raise ValueError(f"{self.where} uses blosc codec "
                         f"{comp.get('cname')!r}; this reader decodes "
                         f"{', '.join(BLOSC_CNAMES)}")
      _codec.library(self.where)  # built here, so a store fails at open
    elif comp is not None and comp.get("id") not in ("zlib", "gzip"):
      raise ValueError(
          f"{self.where} uses compressor {comp.get('id')!r} ({comp}); this "
          "reader decodes uncompressed, zlib, gzip and blosc chunks")
    if meta.get("filters"):
      raise ValueError(f"{self.where} uses filters {meta['filters']}, "
                       "which this reader cannot decode")
    if meta.get("order", "C") != "C":
      raise ValueError(f"{self.where} is in Fortran order, which this "
                       "reader does not support")
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
    out = np.empty(shape, dtype=self.dtype)
    self._read_into(path, out)
    return out

  def _read_into(self, path: str, out: np.ndarray) -> None:
    """``out[...] =`` the chunk file at ``path``, decoded in place: ``out``
    is C-contiguous and of the chunk's shape."""
    flat = out.reshape(-1).view(np.uint8)
    where = f"{self.where} chunk {os.path.basename(path)!r}"
    t0 = time.perf_counter()
    if self.compressor is None:
      with open(path, "rb") as f:
        n = f.readinto(flat)
      READS.add(n, time.perf_counter() - t0)
      if n != out.nbytes:
        raise ValueError(f"{where} holds {n} bytes, expected {out.nbytes}")
      return
    with open(path, "rb") as f:
      raw = f.read()
    t1 = time.perf_counter()
    READS.add(len(raw), t1 - t0)
    t0 = t1
    if self.compressor["id"] == "blosc":
      _codec.decode_into(raw, out, where)
    else:
      data = zlib.decompress(raw, 31 if self.compressor["id"] == "gzip"
                             else 15)
      if len(data) != out.nbytes:
        raise ValueError(f"{where} decodes to {len(data)} bytes, expected "
                         f"{out.nbytes}")
      flat[...] = np.frombuffer(data, np.uint8)
    DECODES.add(out.nbytes, time.perf_counter() - t0)

  def _write_chunk(self, idx, arr: np.ndarray, direct: bool = False) -> None:
    """Encode ``arr`` (the chunk's shape; read, never written) into the
    chunk file ``idx``; ``direct``: ``arr`` is the caller's data, not a
    staged chunk."""
    data = np.ascontiguousarray(arr, dtype=self.dtype)
    comp = self.compressor
    path = self._chunk_path(idx)
    t0 = time.perf_counter()
    if comp is None:
      raw = data.tobytes()
    elif comp["id"] == "blosc":
      try:  # the writer's own check: lz4 or zstd, shuffle 0-2
        meta = _compressor_meta(comp)
      except ValueError as err:
        raise ValueError(f"{self.where}: {err}") from None
      # LZ4's greedy encoder has one level: its clevel sets the blocksize
      raw = _codec.encode(
          data, meta["cname"], meta["clevel"], meta["shuffle"],
          meta["blocksize"],
          f"{self.where} chunk {os.path.basename(path)!r}")
    else:
      wbits = 31 if comp["id"] == "gzip" else 15
      enc = zlib.compressobj(comp.get("level", 1), zlib.DEFLATED, wbits)
      raw = enc.compress(data.tobytes()) + enc.flush()
    t1 = time.perf_counter()
    WRITES.add_encoded(data.nbytes, t1 - t0, direct)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
      f.write(raw)
    os.replace(tmp, path)
    WRITES.add(len(raw), time.perf_counter() - t1)

  def _chunk_ranges(self, box):
    """Per-axis chunk indices overlapping the [lo, hi) box."""
    return [range(lo // c, -(-hi // c)) if hi > lo else range(0)
            for (lo, hi), c in zip(box, self.chunks)]

  def read_box(self, box) -> np.ndarray:
    """The [lo, hi) box (one pair per axis), reading only its chunks."""
    return self.read_index([np.arange(lo, hi) for lo, hi in box])

  def read_index(self, index, out=None) -> np.ndarray:
    """The product of per-axis positions (sorted, unique int arrays): only
    the chunk files that hold them are read, and of an uncompressed chunk
    only the bytes of the rows selected (see ``_read_part``); into ``out``
    when given (of that shape and the array's type)."""
    if out is None:
      out = np.empty(tuple(len(ix) for ix in index), dtype=self.dtype)
    if not self.shape:
      return self._read_chunk(()).copy()
    if out.size == 0:
      return out
    per_axis = []
    for ix, c in zip(index, self.chunks):
      cid = np.asarray(ix, np.int64) // c
      cuts = np.flatnonzero(np.diff(cid)) + 1
      starts = np.concatenate([[0], cuts])
      stops = np.concatenate([cuts, [len(cid)]])
      per_axis.append([(int(cid[a]), int(a), int(b))
                       for a, b in zip(starts, stops)])
    for combo in itertools.product(*per_axis):
      idx = tuple(c for c, _, _ in combo)
      local = [np.asarray(index[ax][a:b], np.int64) - c * self.chunks[ax]
               for ax, (c, a, b) in enumerate(combo)]
      target = out[tuple(slice(a, b) for _, a, b in combo)]
      self._read_part(idx, local, target)
    return out

  def _read_part(self, idx, local, target: np.ndarray) -> None:
    """``target[...] =`` the chunk ``idx`` at the per-axis positions
    ``local``.  The trailing axes that are selected whole make contiguous
    rows.  Of an uncompressed chunk, or a blosc chunk stored raw, when a
    row is at least ``MIN_PARTIAL_READ_BYTES`` long, only the selected rows
    are read; of a compressed blosc chunk only the blocks that hold them
    are decoded."""
    path = self._chunk_path(idx)
    if not os.path.exists(path):
      target[...] = self.fill_value
      return
    full = [len(p) == c and (c == 0 or p[-1] == c - 1)
            for p, c in zip(local, self.chunks)]
    k = len(full)
    while k > 0 and full[k - 1]:
      k -= 1
    row = int(np.prod(self.chunks[k:])) if k < len(full) else 1
    row_bytes = row * self.dtype.itemsize
    if k == 0 and target.flags.c_contiguous:
      # the whole chunk, read (and decoded) straight into place
      self._read_into(path, target)
      return
    if 0 < k and (self.compressor is None or self.compressor["id"] == "blosc"):
      # C order: each combination of positions on the leading axes is one
      # row of the trailing ones
      rows = np.ravel_multi_index(np.ix_(*local[:k]),
                                  self.chunks[:k]).ravel()
      if self.compressor is None:
        buf = (self._read_rows(path, rows, row, 0)
               if row_bytes >= MIN_PARTIAL_READ_BYTES else None)
      else:
        buf = self._read_blosc_rows(path, rows, row)
      if buf is not None:
        # the trailing axes are selected whole: buf is the target's shape
        target[...] = buf.reshape(target.shape)
        return
    chunk = self._read_chunk(idx)
    # runs of positions as slices (a basic copy); other positions gather
    key = tuple(slice(int(p[0]), int(p[-1]) + 1)
                if p[-1] - p[0] + 1 == len(p) else p for p in local)
    arrays = [i for i, k in enumerate(key) if not isinstance(k, slice)]
    if len(arrays) > 1:
      key = np.ix_(*local)
    target[...] = chunk[key]

  def _read_rows(self, path: str, rows: np.ndarray, row: int,
                 offset: int) -> np.ndarray:
    """Rows ``rows`` (sorted) of ``row`` items of the chunk whose bytes
    start ``offset`` bytes into the file; consecutive rows read together."""
    row_bytes = row * self.dtype.itemsize
    buf = np.empty((len(rows), row), dtype=self.dtype)
    cuts = np.flatnonzero(np.diff(rows) != 1) + 1
    t0 = time.perf_counter()
    with open(path, "rb") as f:
      for a, b in zip(np.concatenate([[0], cuts]),
                      np.concatenate([cuts, [len(rows)]])):
        f.seek(offset + int(rows[a]) * row_bytes)
        dst = memoryview(buf[a:b]).cast("B")
        n = f.readinto(dst)
        if n != dst.nbytes:
          raise ValueError(f"zarr chunk {path!r} is shorter than its "
                           "array's chunk shape")
        t1 = time.perf_counter()
        READS.add(n, t1 - t0)
        t0 = t1
    return buf

  def _read_blosc_rows(self, path: str, rows: np.ndarray,
                       row: int) -> Optional[np.ndarray]:
    """Rows ``rows`` of a blosc chunk: of a chunk stored raw, the rows'
    bytes after the 16-byte header (None when they are shorter than
    ``MIN_PARTIAL_READ_BYTES``: the caller reads the file whole); else the
    file whole (its block table is in it) and only the blocks that hold the
    rows decoded, counted in ``DECODES``."""
    where = f"{self.where} chunk {os.path.basename(path)!r}"
    nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
    row_bytes = row * self.dtype.itemsize
    t0 = time.perf_counter()
    with open(path, "rb") as f:
      head = _codec.blosc_header(f.read(16))
      if head["nbytes"] != nbytes:
        raise ValueError(f"{where} decodes to {head['nbytes']} bytes, "
                         f"expected {nbytes}")
      if head["flags"] & MEMCPYED:
        if row_bytes < MIN_PARTIAL_READ_BYTES:
          return None
        READS.add(16, time.perf_counter() - t0)
        return self._read_rows(path, rows, row, 16)
      f.seek(0)
      raw = f.read()
    t1 = time.perf_counter()
    READS.add(len(raw), t1 - t0)
    t0 = t1
    bs = head["blocksize"]
    if bs <= 0:
      raise ValueError(f"{where}: blosc blocksize {bs}")
    # the blocks each row touches (+1 at its first, -1 after its last),
    # then runs of consecutive blocks
    start = rows.astype(np.int64) * row_bytes
    touch = np.zeros(-(-nbytes // bs) + 1, np.int64)
    np.add.at(touch, start // bs, 1)
    np.add.at(touch, (start + row_bytes - 1) // bs + 1, -1)
    need = np.cumsum(touch[:-1]) > 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], need, [0]])))
    chunk = np.empty(nbytes, np.uint8)
    decoded = 0
    for a, b in zip(edges[::2], edges[1::2]):
      part = chunk[a * bs:min(nbytes, b * bs)]
      _codec.decode_blocks_into(raw, int(a), int(b) - 1, part, where)
      decoded += part.nbytes
    DECODES.add(decoded, time.perf_counter() - t0)
    return chunk.view(self.dtype).reshape(-1, row)[rows]

  def write_box(self, box, data: np.ndarray) -> None:
    """Write ``data`` into the [lo, hi) box.  A chunk the box covers whole
    and that ends inside the array is encoded from ``data`` itself (counted
    in ``WRITES.direct``); one padded past the array's end is staged in a
    chunk of ``fill_value``; partial chunks read-modify-write."""
    data = np.asarray(data, dtype=self.dtype)
    if not self.shape:
      self._write_chunk((), data.reshape(()))
      return
    for idx in itertools.product(*self._chunk_ranges(box)):
      src, dst, full, inside = [], [], True, True
      for ax, i in enumerate(idx):
        c0 = i * self.chunks[ax]
        c1 = min(c0 + self.chunks[ax], self.shape[ax])
        lo = max(box[ax][0], c0)
        hi = min(box[ax][1], c0 + self.chunks[ax])
        src.append(slice(lo - box[ax][0], hi - box[ax][0]))
        dst.append(slice(lo - c0, hi - c0))
        full = full and lo == c0 and hi == c1
        inside = inside and c0 + self.chunks[ax] <= self.shape[ax]
      if full and inside:
        self._write_chunk(idx, data[tuple(src)], direct=True)
        continue
      chunk = (np.full(self.chunks, self.fill_value, dtype=self.dtype)
               if full else self._read_chunk(idx).copy())
      chunk[tuple(dst)] = data[tuple(src)]
      self._write_chunk(idx, chunk)


class LazyArray(core.LazyArrayBase):
  """Lazily-sliced zarr array payload.

  A view is one entry per axis of the stored array: a ``range`` or a 1-d
  int array of positions (kept axis), or an ``int`` (dropped axis).  Basic
  indexing composes the entries, and so does a single 1-d integer or
  boolean array with slices on every other axis: a chunk slice of a
  multi-GB variable, or the few times a gather picks, costs nothing until
  it is materialized, and then only the positions in the view are read
  (``ZarrArray.read_index``).  Other advanced keys read the bounding box
  and gather in numpy.  ``__array__`` applies the CF decode.
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
    return tuple(len(v) for v in self._view if not isinstance(v, int))

  @property
  def ndim(self):
    return len(self.shape)

  @property
  def size(self):
    return int(np.prod(self.shape)) if self.shape else 1

  def _plan(self):
    """Each axis's distinct positions in ascending order (what is read),
    where the view wants them (None: as read) and the int axes it drops."""
    index, order, drop = [], [], []
    for ax, v in enumerate(self._view):
      pos = np.atleast_1d(np.asarray(v, np.int64))
      uniq, inv = np.unique(pos, return_inverse=True)
      index.append(uniq)
      same = len(uniq) == len(pos) and bool(np.all(uniq == pos))
      order.append(None if same else inv.ravel())
      if isinstance(v, int):
        drop.append(ax)
    return index, order, drop

  @property
  def plain(self) -> bool:
    """Whether the view's values are its stored bytes as read: positions
    ascending and distinct on every axis, the stored type, no CF decode
    (``read_into`` takes it)."""
    return (bool(self._arr.shape) and self.dtype == self._arr.dtype
            and not _cf_encoded(self._attrs)
            and all(o is None for o in self._plan()[1]))

  def read_into(self, out: np.ndarray) -> None:
    """Read a ``plain`` view into ``out`` (C-contiguous, of its shape and
    type), with no array of its own in between."""
    if not (self.plain and out.flags.c_contiguous
            and out.shape == self.shape and out.dtype == self.dtype):
      raise ValueError(
          f"read_into takes a plain view and a C-contiguous {self.dtype} "
          f"array of shape {self.shape}, got {out.dtype} {out.shape}")
    index = self._plan()[0]
    self._arr.read_index(index, out.reshape([len(ix) for ix in index]))

  def _materialize(self) -> np.ndarray:
    # read each axis's distinct positions in ascending order, then put
    # them in the view's order (and repeats) and drop the int axes
    index, order, drop = self._plan()
    data = self._arr.read_index(index)
    for ax, inv in enumerate(order):
      if inv is not None:
        data = np.take(data, inv, axis=ax)
    if drop:
      data = data[tuple(0 if ax in drop else slice(None)
                        for ax in range(data.ndim))]
    return decode_cf(data, self._attrs)

  def __array__(self, dtype=None, copy=None):
    out = self._materialize()
    return out.astype(dtype) if dtype is not None else out

  def _compose(self, key):
    """The view after ``key``: ints, slices and at most one 1-d position
    array, one per kept axis."""
    it = iter(key)
    view = []
    for v in self._view:
      if isinstance(v, int):
        view.append(v)
        continue
      k = next(it)
      if isinstance(v, range) and not isinstance(k, np.ndarray):
        view.append(v[k])
        continue
      sub = np.asarray(v)[k]
      view.append(int(sub) if np.ndim(sub) == 0 else sub)
    return LazyArray(self._arr, self._attrs, self.dtype, tuple(view))

  def __getitem__(self, key):
    if not isinstance(key, tuple):
      key = (key,)
    if any(k is Ellipsis for k in key):
      i = key.index(Ellipsis)
      key = key[:i] + (slice(None),) * (self.ndim - len(key) + 1) + key[i + 1:]
    key = key + (slice(None),) * (self.ndim - len(key))
    key = tuple(int(k) if isinstance(k, np.integer) else k for k in key)
    if all(isinstance(k, (int, slice)) for k in key):
      return self._compose(key)
    advanced = [k for k in key if not isinstance(k, slice)]
    if len(advanced) == 1 and np.ndim(advanced[0]) == 1:
      arr = np.asarray(advanced[0])
      if arr.dtype == bool:
        arr = np.nonzero(arr)[0]
      if arr.dtype.kind in "iu":
        # one position array among slices: its axis stays in place, as in
        # numpy, and only its positions are read
        return self._compose(tuple(arr if not isinstance(k, slice) else k
                                   for k in key))
    # other advanced keys: read the bounding slice, gather in numpy
    bound, inner = [], []
    for k in key:
      if isinstance(k, (int, slice)):
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
      "dimension_separator": ".",
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
    compressor="default",
) -> None:
  """Write a Dataset to a local zarr v2 store, its chunks compressed as
  ``compressor`` says (``_compressor_meta``; by default the JAX package's:
  ``WB2_ZARR_COMPRESSOR``, else bit-shuffled zstd)."""
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
    compressor="default",
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


def write_region(arr: ZarrArray, key, data: np.ndarray) -> None:
  """Write ``data`` (CF-encoded here) at ``key`` (ints and unit-step
  slices; missing trailing axes whole) of ``arr``."""
  data, _ = encode_cf(np.asarray(data))
  key = tuple(key) + (slice(None),) * (len(arr.shape) - len(tuple(key)))
  box = []
  for n, k in zip(arr.shape, key):
    r = range(n)[k if isinstance(k, slice) else slice(k, k + 1)]
    if r.step != 1:
      raise ValueError("region writes take unit-step slices")
    box.append((r.start, r.stop) if len(r) else (0, 0))
  arr.write_box(box, data.reshape(tuple(hi - lo for lo, hi in box)))


def write_zarr_region(path: str, name: str, key, data: np.ndarray) -> None:
  """Write ``data`` at ``key`` of the array ``name`` of an existing store
  (one-shot: ``RegionWriter`` keeps its arrays open)."""
  write_region(open_zarr_array(path, name), key, data)


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

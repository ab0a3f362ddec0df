"""A minimal labeled-array data model for the PyTorch port.

``Variable``, ``DataArray`` and ``Dataset`` cover the subset of xarray
semantics that WeatherBench-style verification relies on: named dimensions,
label-based selection including vectorized (pointwise) indexing,
broadcasting by dimension name, NaN-aware and weighted reductions, and time
accessors.  Counterpart of ``weatherbench2_tpu/xds/core.py``.

  * Data payloads are ``numpy.ndarray`` on the host, lazy zarr views, or
    ``torch.Tensor`` on a device.  Arithmetic dispatches to torch as soon as
    an operand is a tensor (see ``_xp``), so metric code written against
    this API runs on the card without change.
  * Coordinates are always host-side numpy arrays (they carry datetime64 and
    string values): label-to-position resolution happens on the host and
    produces integer gather indices that run on the device.
  * Times use numpy ``datetime64``/``timedelta64`` only.
"""
from __future__ import annotations

from collections.abc import Iterable, Mapping, Sequence
import functools
import re
from typing import Any

import numpy as np

from . import _xp
from ._xp import is_tensor, to_numpy as _to_numpy


class LazyArrayBase:
  """Marker base for lazily-backed array payloads (see io_zarr.LazyArray).

  Implementations provide shape/dtype/ndim, basic-slicing __getitem__
  (returning a lazy view when possible, numpy otherwise), and __array__
  for materialization.
  """


class LazyStack(LazyArrayBase):
  """Same-shaped lazy payloads stacked along a new LEADING axis.

  Built by the pressure-level-suffix decode (evaluation.py) so a suffixed
  store opens without reading any data.  Basic indexing composes into part
  views; an integer or 1-d index on the stack axis picks parts; any other
  advanced key materializes and defers to numpy for exact semantics.
  """

  __slots__ = ("_parts", "dtype")

  def __init__(self, parts):
    parts = list(parts)
    if not parts:
      raise ValueError("LazyStack needs at least one part")
    shapes = {tuple(p.shape) for p in parts}
    if len(shapes) != 1:
      raise ValueError(f"mismatched part shapes: {sorted(shapes)}")
    self._parts = parts
    self.dtype = np.result_type(*[p.dtype for p in parts])

  @property
  def shape(self):
    return (len(self._parts),) + tuple(self._parts[0].shape)

  @property
  def ndim(self):
    return len(self.shape)

  @property
  def size(self):
    return int(np.prod(self.shape))

  def __getitem__(self, key):
    if not isinstance(key, tuple):
      key = (key,)
    if any(k is Ellipsis for k in key):
      i = key.index(Ellipsis)
      fill = (slice(None),) * (self.ndim - (len(key) - 1))
      key = key[:i] + fill + key[i + 1:]
    key = key + (slice(None),) * (self.ndim - len(key))
    k0, rest = key[0], key[1:]
    if any(not isinstance(r, slice) for r in rest) or isinstance(
        k0, (bool, np.bool_)):
      # advanced indexing inside the parts (or numpy's scalar-bool rule)
      # moves axes by numpy's placement rules: materialize for exactness
      return np.asarray(self)[key]
    rest_trivial = all(r == slice(None) for r in rest)

    def sub(p):
      return p if rest_trivial else p[rest]

    if isinstance(k0, (int, np.integer)):
      return sub(self._parts[int(k0)])
    if isinstance(k0, slice):
      parts = self._parts[k0]
    else:
      arr = np.asarray(k0)
      if arr.ndim != 1:
        return np.asarray(self)[key]
      if arr.dtype == bool:
        if arr.shape[0] != len(self._parts):
          raise IndexError(
              f"boolean index of length {arr.shape[0]} does not match "
              f"stack axis of length {len(self._parts)}"
          )
        arr = np.nonzero(arr)[0]
      parts = [self._parts[int(i)] for i in arr]
    parts = [sub(p) for p in parts]
    if parts and all(isinstance(p, LazyArrayBase) for p in parts):
      return LazyStack(parts)
    return np.stack([np.asarray(p) for p in parts], axis=0)

  def __array__(self, dtype=None, copy=None):
    out = np.stack([np.asarray(p) for p in self._parts], axis=0)
    return out.astype(dtype) if dtype is not None else out


def _asarray(data):
  if is_tensor(data) or isinstance(data, LazyArrayBase):
    return data
  return np.asarray(data)


def _host(data):
  """A lazy payload materialized; numpy and tensors pass through."""
  return np.asarray(data) if isinstance(data, LazyArrayBase) else data


# ---------------------------------------------------------------------------
# Time labels (numpy datetime64 / timedelta64 only)
# ---------------------------------------------------------------------------

_TIMEDELTA_UNITS = {
    "d": "D", "day": "D", "days": "D",
    "h": "h", "hr": "h", "hour": "h", "hours": "h",
    "m": "m", "min": "m", "minute": "m", "minutes": "m",
    "s": "s", "sec": "s", "second": "s", "seconds": "s",
    "ms": "ms", "us": "us", "ns": "ns",
}
_TIMEDELTA_RE = re.compile(r"^\s*([-+]?\d+)\s*([a-zA-Z]+)\s*$")


def to_timedelta64(label) -> np.timedelta64:
  """A timedelta64[ns] from '6 hours', '1 day', '12h', or a timedelta."""
  if isinstance(label, str):
    m = _TIMEDELTA_RE.match(label)
    unit = _TIMEDELTA_UNITS.get(m.group(2).lower()) if m else None
    if unit is None:
      raise ValueError(f"cannot parse timedelta {label!r}")
    return np.timedelta64(int(m.group(1)), unit).astype("timedelta64[ns]")
  return np.timedelta64(label).astype("timedelta64[ns]")


def _partial_string_bounds(label: str):
  """[start, stop) datetime64[ns] bounds of a partial ISO string.

  numpy infers the resolution of '2020', '2020-01', '2020-01-15',
  '2020-01-15T06' and finer; the interval is one unit of it, which is
  xarray's partial-string indexing.
  """
  start = np.datetime64(label.strip().replace(" ", "T"))
  return start.astype("datetime64[ns]"), (start + 1).astype("datetime64[ns]")


def _parse_datetime_label(label, dtype):
  """Parse a scalar label against a datetime64/timedelta64 index dtype."""
  if np.issubdtype(dtype, np.datetime64):
    if isinstance(label, str):
      return label  # handled by partial-string logic
    return np.datetime64(label).astype(dtype)
  if np.issubdtype(dtype, np.timedelta64):
    return to_timedelta64(label).astype(dtype)
  return label


class Index:
  """Label → position lookup over a 1-d coordinate array."""

  def __init__(self, values: np.ndarray):
    self.values = np.asarray(values)
    if self.values.ndim != 1:
      raise ValueError("index must be 1-d")
    self._lookup = None
    self._sorted_cache = None

  def _get_lookup(self):
    if self._lookup is None:
      self._lookup = {}
      for i, v in enumerate(self.values.tolist()):
        self._lookup.setdefault(v, i)
    return self._lookup

  def _sorted_view(self):
    if self._sorted_cache is None:
      vals = self.values
      if vals.dtype.kind in ("M", "m"):
        vals = vals.astype(np.int64)
      order = np.argsort(vals, kind="stable")
      self._sorted_cache = (vals[order], order)
    return self._sorted_cache

  def _positions_vectorized(self, flat: np.ndarray):
    """Exact label positions via searchsorted; None if dtype unsuitable."""
    if self.values.dtype.kind not in ("M", "m", "i", "u"):
      return None
    sorted_vals, order = self._sorted_view()
    q = flat.astype(np.int64, copy=False) if flat.dtype.kind in (
        "M", "m") else flat
    if q.dtype.kind not in ("i", "u"):
      return None
    pos = np.searchsorted(sorted_vals, q)
    pos_clipped = np.minimum(pos, len(sorted_vals) - 1)
    found = sorted_vals[pos_clipped] == q
    if not found.all():
      missing = np.asarray(flat)[~found]
      raise KeyError(f"label {missing.ravel()[0]!r} not found in index")
    return order[pos_clipped]

  def positions_for_labels(self, labels, method=None, tolerance=None):
    """Resolve an array of labels to integer positions."""
    if method not in (None, "nearest"):
      raise NotImplementedError(
          f"selection method {method!r} is not supported "
          "(only None and 'nearest')"
      )
    labels = np.asarray(labels)
    scalar = labels.ndim == 0
    flat = np.atleast_1d(labels)
    if np.issubdtype(self.values.dtype, np.datetime64):
      flat = flat.astype(self.values.dtype)
    elif np.issubdtype(self.values.dtype, np.timedelta64):
      if flat.dtype.kind == "U":
        flat = np.array([to_timedelta64(x) for x in flat.tolist()])
      flat = flat.astype(self.values.dtype)

    if method == "nearest":
      sorted_vals, order = self._sorted_view()
      if self.values.dtype.kind in ("M", "m"):
        vals = sorted_vals.astype(np.int64)
        q = flat.astype(self.values.dtype).astype(np.int64)
        tol = (None if tolerance is None else
               to_timedelta64(tolerance).astype(np.int64))
      else:
        vals = sorted_vals.astype(np.float64)
        q = flat.astype(np.float64)
        tol = None if tolerance is None else float(tolerance)
      pos = np.searchsorted(vals, q)
      pos = np.clip(pos, 1, len(vals) - 1)
      left = vals[pos - 1]
      right = vals[pos]
      # strict <: equidistant labels resolve to the LARGER value,
      # matching pandas get_indexer(method='nearest')
      pos = pos - (np.abs(q - left) < np.abs(right - q))
      if tol is not None:
        bad = np.abs(vals[pos] - q) > tol
        if np.any(bad):
          raise KeyError(
              f"labels {flat[bad]} not within tolerance {tolerance}"
          )
      result = order[pos]
    else:
      fast = self._positions_vectorized(flat.ravel())
      if fast is not None:
        result = fast.reshape(labels.shape)
        return int(result) if scalar else result
      lookup = self._get_lookup()
      result = np.empty(flat.size, dtype=np.int64)
      for i, v in enumerate(flat.ravel().tolist()):
        if v in lookup:
          result[i] = lookup[v]
          continue
        # approximate float equality for coordinate values
        matches = np.nonzero(np.isclose(self.values, v))[0] if (
            np.issubdtype(self.values.dtype, np.number)
            and isinstance(v, (int, float))
        ) else []
        if not len(matches):
          raise KeyError(f"label {v!r} not found in index")
        result[i] = matches[0]
    result = result.reshape(labels.shape)
    return int(result) if scalar else result

  def slice_positions(self, sl: slice) -> slice:
    """Label slice → positional slice (inclusive of both endpoints)."""
    vals = self.values
    increasing = len(vals) < 2 or bool(vals[0] <= vals[-1])

    def bound(label, side):
      if label is None:
        return None
      if np.issubdtype(vals.dtype, np.datetime64) and isinstance(label, str):
        lo, hi = _partial_string_bounds(label)
        if increasing:
          target = lo if side == "start" else hi
          return int(np.searchsorted(vals, target, side="left"))
        rev = vals[::-1]
        target = hi if side == "start" else lo
        return len(vals) - int(np.searchsorted(rev, target, side="left"))
      label = _parse_datetime_label(label, vals.dtype)
      if increasing:
        return int(np.searchsorted(
            vals, label, side="left" if side == "start" else "right"))
      rev = vals[::-1]
      return len(vals) - int(np.searchsorted(
          rev, label, side="right" if side == "start" else "left"))

    if sl.step is not None and not isinstance(sl.step, (int, np.integer)):
      raise TypeError("label-slice step must be an integer")
    return slice(bound(sl.start, "start"), bound(sl.stop, "stop"), sl.step)


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------


class Variable:
  """A named-dimension array: ``dims`` + data payload + attrs."""

  __slots__ = ("dims", "data", "attrs")

  def __init__(self, dims, data, attrs=None):
    if isinstance(dims, str):
      dims = (dims,)
    data = _asarray(data)
    dims = tuple(dims)
    if len(dims) != data.ndim:
      raise ValueError(
          f"dims {dims} do not match data of rank {data.ndim} "
          f"(shape {tuple(data.shape)})"
      )
    self.dims = dims
    self.data = data
    self.attrs = dict(attrs) if attrs else {}

  @property
  def shape(self):
    return tuple(self.data.shape)

  @property
  def dtype(self):
    return self.data.dtype

  @property
  def ndim(self):
    return self.data.ndim

  @property
  def size(self):
    return int(np.prod(self.shape)) if self.ndim else 1

  @property
  def sizes(self):
    return dict(zip(self.dims, self.shape))

  def copy(self, data=None):
    return Variable(self.dims, self.data if data is None else data, self.attrs)

  def __repr__(self):
    return f"Variable{self.dims} {self.dtype} {self.shape}"

  def transpose(self, *dims):
    if not dims:
      dims = self.dims[::-1]
    missing = [d for d in dims if d not in self.dims]
    if missing:
      raise ValueError(f"transpose: dims {missing} not found in {self.dims}")
    order = [self.dims.index(d) for d in dims]
    if len(order) != self.ndim:
      raise ValueError("transpose must list all dims")
    data = _host(self.data)
    return Variable(dims, _xp.namespace(data).transpose(data, order),
                    self.attrs)

  def rename_dims(self, mapping: Mapping[str, str]):
    return Variable(
        tuple(mapping.get(d, d) for d in self.dims), self.data, self.attrs
    )

  def expand_dims_var(self, dim: str, size: int = 1, axis: int = 0):
    data = _host(self.data)
    xp = _xp.namespace(data)
    if axis < 0:
      axis = self.ndim + 1 + axis
    data = xp.expand_dims(data, axis)
    if size != 1:
      shape = tuple(data.shape)
      data = xp.broadcast_to(data, shape[:axis] + (size,) + shape[axis + 1:])
    dims = list(self.dims)
    dims.insert(axis, dim)
    return Variable(tuple(dims), data, self.attrs)

  def broadcast_to_dims(self, dims: Sequence[str], sizes: Mapping[str, int]):
    """Transpose/reshape/broadcast this variable to the given dims order."""
    dims = tuple(dims)
    own = [d for d in dims if d in self.dims]
    v = self.transpose(*own) if tuple(own) != self.dims else self
    data = _host(v.data)
    shape = tuple(v.sizes.get(d, 1) for d in dims)
    data = data.reshape(shape)
    full = tuple(sizes[d] for d in dims)
    if shape != full:
      data = _xp.namespace(data).broadcast_to(data, full)
    return Variable(dims, data, self.attrs)

  def isel_var(self, indexers: Mapping[str, Any]):
    """Positional selection; values may be int, slice, or 1-d int arrays."""
    key = []
    dims = []
    for d in self.dims:
      if d in indexers:
        idx = indexers[d]
        key.append(idx)
        if isinstance(idx, slice) or np.ndim(idx) >= 1:
          dims.append(d)
      else:
        key.append(slice(None))
        dims.append(d)
    # Orthogonal indexing: numpy fancy indexing with multiple arrays is
    # pointwise, so apply array indexers one axis at a time.
    data = self.data
    arr_axes = [i for i, k in enumerate(key)
                if not isinstance(k, slice) and np.ndim(k) >= 1]
    int_axes = [i for i, k in enumerate(key)
                if not isinstance(k, slice) and np.ndim(k) == 0]
    # one shot only where numpy's advanced-index placement rule cannot
    # move the selected axis
    if not arr_axes or (len(arr_axes) == 1 and not int_axes):
      data = _xp.take(data, tuple(key))
    else:
      dropped = 0
      for ax_i, k in enumerate(key):
        if isinstance(k, slice) and k == slice(None):
          continue
        sub_key = [slice(None)] * data.ndim
        sub_key[ax_i - dropped] = k
        data = _xp.take(_host(data), tuple(sub_key))
        if not isinstance(k, slice) and np.ndim(k) == 0:
          dropped += 1
    return Variable(tuple(dims), data, self.attrs)


def broadcast_dims_order(*dims_tuples: Sequence[str]) -> tuple[str, ...]:
  """Result dims = order of first appearance across operands (xarray rule)."""
  out = []
  for dims in dims_tuples:
    for d in dims:
      if d not in out:
        out.append(d)
  return tuple(out)


def _merge_sizes(*variables: Variable) -> dict[str, int]:
  sizes: dict[str, int] = {}
  for v in variables:
    for d, s in v.sizes.items():
      if d in sizes and sizes[d] != s:
        raise ValueError(
            f"conflicting sizes for dim {d!r}: {sizes[d]} vs {s}"
        )
      sizes[d] = s
  return sizes


def broadcast_variables(*variables: Variable):
  dims = broadcast_dims_order(*(v.dims for v in variables))
  sizes = _merge_sizes(*variables)
  return [v.broadcast_to_dims(dims, sizes) for v in variables]


# ---------------------------------------------------------------------------
# DataArray
# ---------------------------------------------------------------------------


def _coords_for_dims(coords: Mapping[str, Variable], dims) -> dict:
  dimset = set(dims)
  return {k: cv for k, cv in coords.items() if set(cv.dims) <= dimset}


class _DTAccessor:
  """Datetime component accessor (``da.dt.dayofyear`` etc.), numpy-only."""

  def __init__(self, obj: "DataArray"):
    self._obj = obj

  def _component(self, name, values) -> "DataArray":
    return DataArray(Variable(self._obj.dims, values.astype(np.int64)),
                     coords=self._obj.coords, name=name)

  def _values(self):
    return _to_numpy(self._obj.variable.data).astype("datetime64[ns]")

  @property
  def dayofyear(self):
    v = self._values()
    doy = (v.astype("datetime64[D]") - v.astype("datetime64[Y]")) // (
        np.timedelta64(1, "D"))
    return self._component("dayofyear", doy + 1)

  @property
  def hour(self):
    v = self._values()
    hours = (v.astype("datetime64[h]") - v.astype("datetime64[D]")) // (
        np.timedelta64(1, "h"))
    return self._component("hour", hours)


def _reduce_data(xp_name, nan_name, data, axes, skipna):
  xp = _xp.namespace(data)
  fname = nan_name if (skipna and _xp.is_floating(data)) else xp_name
  if xp is np and fname.startswith("nan"):
    import warnings

    # all-NaN slices legitimately reduce to NaN under skipna; silence
    # numpy's "Mean of empty slice" warning like xarray does
    with warnings.catch_warnings():
      warnings.simplefilter("ignore", RuntimeWarning)
      return getattr(np, fname)(data, axis=axes)
  return getattr(xp, fname)(data, axis=axes)


class DataArray:
  """A Variable with coordinates and an optional name."""

  __slots__ = ("variable", "coords", "name")

  def __init__(self, data, dims=None, coords=None, name=None, attrs=None):
    if isinstance(data, DataArray):
      variable = data.variable
      coords = coords if coords is not None else data.coords
      name = name if name is not None else data.name
    elif isinstance(data, Variable):
      variable = data
    else:
      data = _asarray(data)
      if dims is None:
        raise ValueError("dims required when constructing from raw array")
      variable = Variable(dims, data, attrs)
    if attrs:
      variable = Variable(variable.dims, variable.data, attrs)
    self.variable = variable
    norm_coords = {}
    if coords:
      for cname, cval in coords.items():
        norm_coords[cname] = _as_coord_variable(cname, cval)
    self.coords = _coords_for_dims(norm_coords, variable.dims)
    self.name = name

  @property
  def dims(self):
    return self.variable.dims

  @property
  def data(self):
    return self.variable.data

  @property
  def values(self):
    return _to_numpy(self.variable.data)

  @property
  def shape(self):
    return self.variable.shape

  @property
  def dtype(self):
    return self.variable.dtype

  @property
  def ndim(self):
    return self.variable.ndim

  @property
  def size(self):
    return self.variable.size

  @property
  def sizes(self):
    return self.variable.sizes

  @property
  def attrs(self):
    return self.variable.attrs

  @property
  def dt(self):
    return _DTAccessor(self)

  def coords_dict(self):
    """Coordinate variables (Dataset-compatible accessor)."""
    return dict(self.coords)

  def __repr__(self):
    return (
        f"<DataArray {self.name or ''} {self.dims} {self.dtype}"
        f" shape={self.shape}>"
    )

  def copy(self, data=None):
    v = self.variable.copy(data=data)
    return DataArray(v, coords=self.coords, name=self.name)

  def rename(self, name):
    return DataArray(self.variable, coords=self.coords, name=name)

  def rename_dims(self, mapping):
    v = self.variable.rename_dims(mapping)
    coords = {
        mapping.get(k, k): c.rename_dims(mapping)
        for k, c in self.coords.items()
    }
    return DataArray(v, coords=coords, name=self.name)

  def assign_coords(self, coords=None, **kw):
    new = dict(self.coords)
    updates = dict(coords or {})
    updates.update(kw)
    for cname, cval in updates.items():
      cv = _as_coord_variable(cname, cval)
      if cv.ndim and not set(cv.dims) <= set(self.dims):
        raise ValueError(
            f"coord {cname} has dims {cv.dims} not in array dims {self.dims}"
        )
      new[cname] = cv
    return DataArray(self.variable, coords=new, name=self.name)

  def expand_dims(self, dim=None, axis=0, **dim_kwargs):
    return _expand_dims_impl(self, dim, axis, dim_kwargs, is_dataset=False)

  def transpose(self, *dims):
    if not dims:
      dims = self.dims[::-1]
    return DataArray(
        self.variable.transpose(*dims), coords=self.coords, name=self.name
    )

  # -- selection -------------------------------------------------------------
  def get_index(self, dim) -> Index:
    if dim not in self.coords:
      raise KeyError(f"no index coordinate for dim {dim!r}")
    return Index(_to_numpy(self.coords[dim].data))

  def isel(self, indexers=None, drop=False, **kw):
    indexers = dict(indexers or {})
    indexers.update(kw)
    return _isel_impl(self, indexers, drop)

  def sel(self, indexers=None, method=None, tolerance=None, drop=False, **kw):
    indexers = dict(indexers or {})
    indexers.update(kw)
    return _sel_impl(self, indexers, method, tolerance, drop)

  # -- arithmetic ------------------------------------------------------------
  def _binop(self, other, op, reflexive=False):
    if isinstance(other, Dataset):
      return NotImplemented
    if isinstance(other, DataArray):
      a, b = align_arrays(self, other)
      va, vb = broadcast_variables(a.variable, b.variable)
      data = (_xp.binop(op, vb.data, va.data) if reflexive
              else _xp.binop(op, va.data, vb.data))
      coords = _merge_coords_dicts(a.coords, b.coords)
      return DataArray(Variable(va.dims, data), coords=coords, name=self.name)
    self_data = _host(self.data)
    data = (_xp.binop(op, other, self_data) if reflexive
            else _xp.binop(op, self_data, other))
    return DataArray(Variable(self.dims, data), coords=self.coords,
                     name=self.name)

  __add__ = functools.partialmethod(_binop, op=lambda a, b: a + b)
  __radd__ = functools.partialmethod(
      _binop, op=lambda a, b: a + b, reflexive=True)
  __sub__ = functools.partialmethod(_binop, op=lambda a, b: a - b)
  __rsub__ = functools.partialmethod(
      _binop, op=lambda a, b: a - b, reflexive=True)
  __mul__ = functools.partialmethod(_binop, op=lambda a, b: a * b)
  __rmul__ = functools.partialmethod(
      _binop, op=lambda a, b: a * b, reflexive=True)
  __truediv__ = functools.partialmethod(_binop, op=lambda a, b: a / b)
  __rtruediv__ = functools.partialmethod(
      _binop, op=lambda a, b: a / b, reflexive=True)
  __pow__ = functools.partialmethod(_binop, op=lambda a, b: a**b)
  __gt__ = functools.partialmethod(_binop, op=lambda a, b: a > b)
  __ge__ = functools.partialmethod(_binop, op=lambda a, b: a >= b)
  __lt__ = functools.partialmethod(_binop, op=lambda a, b: a < b)
  __le__ = functools.partialmethod(_binop, op=lambda a, b: a <= b)
  __and__ = functools.partialmethod(_binop, op=lambda a, b: a & b)

  def notnull(self):
    """Elementwise ``not NaN`` (every value of a non-float payload)."""
    data = _host(self.data)
    xp = _xp.namespace(data)
    if _xp.is_floating(data):
      return self.copy(data=~xp.isnan(data))
    return self.copy(data=xp.ones_like(data) == 1)

  def astype(self, dtype):
    """The payload cast to ``dtype``: a numpy dtype for host payloads, a
    numpy or torch dtype for tensors (``float`` means float64)."""
    data = _host(self.data)
    if is_tensor(data):
      return self.copy(data=data.to(_xp.torch_dtype(dtype)))
    return self.copy(data=data.astype(dtype))

  def __eq__(self, other):  # elementwise, like xarray
    return self._binop(other, op=lambda a, b: a == b)

  def __ne__(self, other):
    return self._binop(other, op=lambda a, b: a != b)

  def __hash__(self):
    return id(self)

  def __neg__(self):
    return self.copy(data=-_host(self.data))

  def __abs__(self):
    data = _host(self.data)
    return self.copy(data=_xp.namespace(data).abs(data))

  def __array__(self, dtype=None, copy=None):
    v = self.values
    return v.astype(dtype) if dtype is not None else v

  def where(self, cond, other=np.nan):
    """Keep values where cond; else ``other`` (xarray semantics)."""
    cond_da = cond if isinstance(cond, DataArray) else None
    other_da = other if isinstance(other, DataArray) else None
    operands = [self.variable]
    if cond_da is not None:
      operands.append(cond_da.variable)
    if other_da is not None:
      operands.append(other_da.variable)
    bvars = broadcast_variables(*operands)
    i = 1
    cond_data = cond
    if cond_da is not None:
      cond_data = bvars[i].data
      i += 1
    other_data = bvars[i].data if other_da is not None else other
    xp = _xp.namespace(*(v.data for v in bvars))
    data = xp.where(cond_data, bvars[0].data, other_data)
    coords = self.coords
    if cond_da is not None:
      coords = _merge_coords_dicts(coords, cond_da.coords)
    return DataArray(Variable(bvars[0].dims, data), coords=coords,
                     name=self.name)

  # -- reductions ------------------------------------------------------------
  def _reduce(self, xp_name, nan_name, dim, skipna):
    if dim is None:
      axes = tuple(range(self.ndim))
      dims = []
    else:
      if isinstance(dim, str):
        dim = [dim]
      axes = tuple(self.dims.index(d) for d in dim)
      dims = [d for d in self.dims if d not in dim]
    data = _reduce_data(xp_name, nan_name, _host(self.data), axes, skipna)
    coords = {k: v for k, v in self.coords.items() if set(v.dims) <= set(dims)}
    return DataArray(Variable(tuple(dims), data), coords=coords,
                     name=self.name)

  def mean(self, dim=None, skipna=False, **kw):
    return self._reduce("mean", "nanmean", dim, skipna)

  def sum(self, dim=None, skipna=False, **kw):
    return self._reduce("sum", "nansum", dim, skipna)

  def weighted(self, weights: "DataArray"):
    return Weighted(self, weights)

  def to_dataset(self, name=None):
    nm = name or self.name
    if nm is None:
      raise ValueError("cannot convert unnamed DataArray to Dataset")
    return Dataset({nm: self}, coords=self.coords)


def _as_coord_variable(name, value) -> Variable:
  if isinstance(value, Variable):
    return value
  if isinstance(value, DataArray):
    return value.variable
  arr = np.asarray(value)
  if arr.ndim == 0:
    return Variable((), arr)
  if arr.ndim == 1:
    return Variable((name,), arr)
  raise ValueError(
      f"coordinate {name!r} from raw array must be 0-d or 1-d; pass a "
      "Variable/DataArray for multi-dimensional coords"
  )


def _merge_coords_dicts(*dicts) -> dict:
  out: dict[str, Variable] = {}
  for d in dicts:
    for k, v in d.items():
      out.setdefault(k, v)
  return out


class Weighted:
  """Weighted mean and sum, mirroring xarray.core.weighted semantics."""

  def __init__(self, obj, weights: DataArray):
    self.obj = obj
    self.weights = weights

  def _apply_da(self, da: DataArray, dim, skipna, stat) -> DataArray:
    if isinstance(dim, str):
      dim = [dim]
    a, wb = broadcast_variables(da.variable, self.weights.variable)
    xp = _xp.namespace(a.data, wb.data)
    adata, wdata_full = (xp.coerce(a.data, wb.data) if xp is _xp.TORCH
                         else (a.data, wb.data))
    axes = tuple(a.dims.index(d) for d in dim if d in a.dims)
    valid = (~xp.isnan(adata) if _xp.is_floating(adata)
             else xp.ones_like(adata).bool() if xp is _xp.TORCH
             else np.ones(adata.shape, bool))
    wdata = xp.where(valid, wdata_full, 0)
    sum_w = xp.sum(wdata, axis=axes)
    x = xp.where(valid, adata, 0) if skipna else adata
    num = xp.sum(x * (wdata if skipna else wdata_full), axis=axes)
    data = num / sum_w if stat == "mean" else num
    dims = tuple(d for d in a.dims if d not in dim)
    coords = {k: v for k, v in da.coords.items() if set(v.dims) <= set(dims)}
    return DataArray(Variable(dims, data), coords=coords, name=da.name)

  def _apply(self, dim, skipna, stat):
    if isinstance(self.obj, Dataset):
      return self.obj.map(lambda da: self._apply_da(da, dim, skipna, stat))
    return self._apply_da(self.obj, dim, skipna, stat)

  def mean(self, dim, skipna=False):
    return self._apply(dim, skipna, "mean")

  def sum(self, dim, skipna=False):
    return self._apply(dim, skipna, "sum")


# ---------------------------------------------------------------------------
# Selection implementation shared by DataArray and Dataset
# ---------------------------------------------------------------------------


def _resolve_label_indexer(index: Index, label, method, tolerance):
  """Label indexer → (positional, indexer_dims or None, labels or None)."""
  if isinstance(label, slice):
    return index.slice_positions(label), None, None
  if isinstance(label, (DataArray, Variable)):
    var = label.variable if isinstance(label, DataArray) else label
    vals = _to_numpy(var.data)
    return index.positions_for_labels(vals, method, tolerance), var.dims, vals
  arr = np.asarray(label)
  if (arr.ndim == 0 and arr.dtype.kind == "U"
      and np.issubdtype(index.values.dtype, np.datetime64)):
    # partial string selection, e.g. ds.sel(time='2020')
    lo, hi = _partial_string_bounds(str(arr))
    pos = np.nonzero((index.values >= lo) & (index.values < hi))[0]
    if pos.size == 0:
      raise KeyError(f"no labels match {label!r}")
    if len(str(arr)) >= 19:
      return int(pos[0]), None, None
    return pos, None, None
  return index.positions_for_labels(arr, method, tolerance), None, None


def _as_slice_if_contiguous(arr: np.ndarray):
  """Convert an evenly-strided index array to a cheap (view/lazy) slice."""
  if arr.ndim != 1 or arr.size == 0 or arr.dtype.kind not in ("i", "u"):
    return arr
  start = int(arr[0])
  if arr.size == 1:
    return slice(start, start + 1)
  step = int(arr[1]) - start
  if step == 0:
    return arr
  if np.array_equal(arr, np.arange(start, start + step * arr.size, step)):
    stop = start + step * (arr.size - 1) + (1 if step > 0 else -1)
    if step < 0 and stop < 0:
      stop = None
    return slice(start, stop, step)
  return arr


def _isel_impl(obj, indexers, drop=False):
  """Positional selection on DataArray or Dataset."""
  vec: dict[str, Variable] = {}
  basic: dict[str, Any] = {}
  for d, idx in indexers.items():
    if isinstance(idx, (DataArray, Variable)):
      var = idx.variable if isinstance(idx, DataArray) else idx
      if var.ndim == 1 and var.dims == (d,) and not is_tensor(var.data):
        basic[d] = _as_slice_if_contiguous(_to_numpy(var.data))
      else:
        vec[d] = var
    elif isinstance(idx, slice):
      basic[d] = idx
    else:
      arr = np.asarray(idx)
      if arr.ndim > 1:
        raise ValueError(
            f"multi-dimensional indexer for {d!r} needs named dims: pass a "
            "DataArray or Variable"
        )
      basic[d] = _as_slice_if_contiguous(arr) if arr.ndim else int(arr)
  if isinstance(obj, Dataset):
    return _dataset_isel(obj, basic, vec, drop)
  return _dataarray_isel(obj, basic, vec, drop)


def _dataarray_isel(da: DataArray, basic, vec, drop):
  var = da.variable.isel_var(basic)
  new_coords = {}
  for cname, cv in da.coords.items():
    cbasic = {d: basic[d] for d in cv.dims if d in basic}
    sub = cv.isel_var(cbasic) if cbasic else cv
    if sub.ndim == 0 and drop:
      continue
    new_coords[cname] = sub
  if vec:
    var, new_coords = _vectorized_gather(var, new_coords, vec)
  return DataArray(var, coords=new_coords, name=da.name)


def _dataset_isel(ds: "Dataset", basic, vec, drop):
  new_vars = {}
  for name, v in ds._variables.items():
    vbasic = {d: basic[d] for d in v.dims if d in basic}
    nv = v.isel_var(vbasic) if vbasic else v
    vvec = {d: iv for d, iv in vec.items() if d in nv.dims}
    if vvec:
      nv, _ = _vectorized_gather(nv, {}, vvec)
    new_vars[name] = nv
  new_coords = {}
  for cname, cv in ds._coords.items():
    cbasic = {d: basic[d] for d in cv.dims if d in basic}
    sub = cv.isel_var(cbasic) if cbasic else cv
    cvec = {d: iv for d, iv in vec.items() if d in sub.dims}
    if cvec:
      sub, _ = _vectorized_gather(sub, {}, cvec)
    if sub.ndim == 0 and drop:
      continue
    new_coords[cname] = sub
  return Dataset(new_vars, coords=new_coords, attrs=ds.attrs)


def clustered_slices(uniq: np.ndarray, max_gap: int = 16) -> list[slice]:
  """Sorted unique positions grouped into bounded read slices."""
  slices = []
  start = prev = int(uniq[0])
  for p in uniq[1:]:
    p = int(p)
    if p - prev > max_gap:
      slices.append(slice(start, prev + 1))
      start = p
    prev = p
  slices.append(slice(start, prev + 1))
  return slices


def _bounded_lazy_read(var: Variable, vec: Mapping[str, Variable]):
  """Read only the indexed positions of a lazy payload, then re-index.

  Reads are CLUSTERED, not one [min, max] window: a winter chunk's
  dayofyear values {355..366, 1..10} would otherwise span the whole year.
  """
  data = var.data
  new_vec = {}
  for ax, d in enumerate(var.dims):
    if d not in vec:
      continue
    size_d = var.shape[ax]
    iv = vec[d]
    arr = _to_numpy(iv.data).astype(np.int64)
    arr = np.where(arr < 0, arr + size_d, arr)

    def full_key(sl, ax=ax):
      return tuple(sl if i == ax else slice(None) for i in range(var.ndim))

    if arr.size == 0:
      data = np.asarray(data[full_key(slice(0, 0))])
      new_vec[d] = Variable(iv.dims, arr, iv.attrs)
      continue
    pos_map = np.full(size_d, -1, np.int64)
    pieces = []
    cum = 0
    for sl in clustered_slices(np.unique(arr)):
      n = sl.stop - sl.start
      pos_map[sl] = np.arange(cum, cum + n)
      cum += n
      pieces.append(np.asarray(data[full_key(sl)]))
    data = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=ax)
    new_vec[d] = Variable(iv.dims, pos_map[arr], iv.attrs)
  return Variable(var.dims, np.asarray(data), var.attrs), {**vec, **new_vec}


def _vectorized_gather(var: Variable, coords: dict,
                       vec: Mapping[str, Variable]):
  """Vectorized (pointwise) indexing: replace dims by indexer dims.

  All indexer variables broadcast against each other; the indexed dims are
  removed and the broadcast indexer dims are inserted at the position of
  the first indexed dim.  On a tensor payload this is one gather on its
  device (an ``index_select`` for a single indexed dim).
  """
  if not set(vec) & set(var.dims):
    return var, coords
  if isinstance(var.data, LazyArrayBase):
    var, vec = _bounded_lazy_read(var, vec)

  ivars = broadcast_variables(*vec.values())
  idx_dims = ivars[0].dims
  ivals = dict(zip(vec.keys(), [iv.data for iv in ivars]))

  sel_axes = [i for i, d in enumerate(var.dims) if d in vec]
  first = min(sel_axes)
  order = (
      [d for d in var.dims[:first] if d not in vec]
      + [d for d in var.dims if d in vec]
      + [d for d in var.dims[first:] if d not in vec]
  )
  v = var.transpose(*order)
  key = tuple(ivals[d] if d in vec else slice(None) for d in v.dims)
  data = _xp.take(v.data, key)
  non_indexed = [d for d in v.dims if d not in vec]
  new_dims = tuple(non_indexed[:first]) + idx_dims + tuple(non_indexed[first:])
  out_var = Variable(new_dims, data, var.attrs)

  new_coords = {}
  for cname, cv in coords.items():
    cvec = {d: Variable(idx_dims, _to_numpy(ivals[d]))
            for d in cv.dims if d in vec}
    new_coords[cname] = (_vectorized_gather(cv, {}, cvec)[0] if cvec
                         else cv)
  return out_var, new_coords


def _sel_impl(obj, indexers, method, tolerance, drop):
  basic: dict[str, Any] = {}
  vec: dict[str, Variable] = {}
  vec_coords: dict[str, tuple] = {}
  for d, label in indexers.items():
    pos, idx_dims, idx_vals = _resolve_label_indexer(
        obj.get_index(d), label, method, tolerance
    )
    if idx_dims is not None:
      vec[d] = Variable(idx_dims, pos)
      vec_coords[d] = (idx_dims, idx_vals, label)
    else:
      basic[d] = pos
  out = _isel_impl(obj, {**basic, **vec}, drop=drop)
  # vectorized sel: selected-dim coords become indexer-valued coords
  for d, (idx_dims, idx_vals, label) in vec_coords.items():
    if isinstance(label, DataArray):
      existing = (
          out.coords_dict() if isinstance(out, Dataset) else out.coords
      )
      for cn, cv in label.coords.items():
        if cn not in existing:
          out = out.assign_coords({cn: cv})
    out = out.assign_coords({d: Variable(idx_dims, idx_vals)})
  return out


def align_arrays(a: DataArray, b: DataArray):
  """Inner-join alignment on shared dims whose index coords differ."""
  shared = set(a.dims) & set(b.dims)
  sel_a = {}
  sel_b = {}
  for d in shared:
    ca = a.coords.get(d)
    cb = b.coords.get(d)
    if ca is None or cb is None or ca.ndim != 1 or cb.ndim != 1:
      if a.sizes[d] != b.sizes[d]:
        raise ValueError(
            f"cannot align dim {d!r} with sizes {a.sizes[d]} vs "
            f"{b.sizes[d]} and no index coords"
        )
      continue
    av = _to_numpy(ca.data)
    bv = _to_numpy(cb.data)
    if av is bv or (av.shape == bv.shape and np.array_equal(av, bv)):
      continue
    # order-preserving inner join (keep the FIRST operand's label order)
    ia = np.nonzero(np.isin(av, bv))[0]
    if ia.size == 0:
      raise ValueError(f"no overlapping labels on dim {d!r}")
    b_pos = {v: i for i, v in enumerate(bv.tolist())}
    sel_a[d] = ia
    sel_b[d] = np.asarray([b_pos[v] for v in av[ia].tolist()])
  if sel_a:
    a = a.isel(sel_a)
  if sel_b:
    b = b.isel(sel_b)
  return a, b


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


class Dataset:
  """A dict of named Variables sharing dimensions, plus coordinates."""

  __slots__ = ("_variables", "_coords", "attrs")

  def __init__(self, data_vars=None, coords=None, attrs=None):
    self._variables: dict[str, Variable] = {}
    self._coords: dict[str, Variable] = {}
    self.attrs = dict(attrs) if attrs else {}
    if coords:
      for name, c in coords.items():
        self._coords[name] = _as_coord_variable(name, c)
    if data_vars:
      for name, v in data_vars.items():
        self[name] = v
    self._check_sizes()

  def _check_sizes(self):
    _merge_sizes(*self._variables.values(), *self._coords.values())

  def __contains__(self, name):
    return name in self._variables

  def __iter__(self):
    return iter(self._variables)

  def __len__(self):
    return len(self._variables)

  def keys(self):
    return self._variables.keys()

  def variables_dict(self):
    return self._variables

  def coords_dict(self):
    return self._coords

  @property
  def sizes(self):
    sizes: dict[str, int] = {}
    for v in self._variables.values():
      sizes.update(v.sizes)
    for v in self._coords.values():
      for d, s in v.sizes.items():
        sizes.setdefault(d, s)
    return sizes

  def __getitem__(self, key):
    if isinstance(key, (list, tuple, set)):
      keys = list(key)
      missing = [k for k in keys if k not in self._variables]
      if missing:
        raise KeyError(missing)
      return Dataset({k: self._variables[k] for k in keys},
                     coords=self._coords, attrs=self.attrs)
    if key in self._variables:
      return DataArray(self._variables[key], coords=self._coords, name=key)
    if key in self._coords:
      return DataArray(self._coords[key], coords=self._coords, name=key)
    raise KeyError(key)

  def __setitem__(self, name, value):
    if isinstance(value, tuple) and len(value) in (2, 3):
      attrs = value[2] if len(value) == 3 else None
      self._variables[name] = Variable(value[0], value[1], attrs)
    elif isinstance(value, DataArray):
      self._variables[name] = value.variable
      for cname, cv in value.coords.items():
        self._coords.setdefault(cname, cv)
    elif isinstance(value, Variable):
      self._variables[name] = value
    else:
      arr = _asarray(value)
      if arr.ndim:
        raise ValueError(
            "assigning a raw array to a Dataset requires (dims, data)")
      self._variables[name] = Variable((), arr)
    self._check_sizes()

  def __repr__(self):
    lines = [f"<xds.Dataset dims={self.sizes}>", "Coordinates:"]
    lines += [f"  {k} {v.dims} {v.dtype}" for k, v in self._coords.items()]
    lines.append("Data variables:")
    lines += [f"  {k} {v.dims} {v.dtype}" for k, v in self._variables.items()]
    return "\n".join(lines)

  def copy(self, data=None):
    if data is None:
      return Dataset(dict(self._variables), dict(self._coords), self.attrs)
    new_vars = {}
    for k, v in self._variables.items():
      if k in data:
        arr = data[k]
        arr = arr.data if isinstance(arr, (DataArray, Variable)) else arr
        new_vars[k] = Variable(v.dims, arr, v.attrs)
      else:
        new_vars[k] = v
    return Dataset(new_vars, dict(self._coords), self.attrs)

  def rename(self, mapping=None, **kw):
    mapping = dict(mapping or {})
    mapping.update(kw)
    new_vars = {mapping.get(k, k): v.rename_dims(mapping)
                for k, v in self._variables.items()}
    new_coords = {mapping.get(k, k): v.rename_dims(mapping)
                  for k, v in self._coords.items()}
    return Dataset(new_vars, new_coords, self.attrs)

  def assign_coords(self, coords=None, **kw):
    updates = dict(coords or {})
    updates.update(kw)
    new_coords = dict(self._coords)
    for name, c in updates.items():
      new_coords[name] = _as_coord_variable(name, c)
    return Dataset(dict(self._variables), new_coords, self.attrs)

  def assign_attrs(self, *args, **kw):
    attrs = dict(self.attrs)
    if args:
      attrs.update(args[0])
    attrs.update(kw)
    return Dataset(dict(self._variables), dict(self._coords), attrs)

  def expand_dims(self, dim=None, axis=0, **dim_kwargs):
    return _expand_dims_impl(self, dim, axis, dim_kwargs, is_dataset=True)

  def transpose(self, *dims):
    new_vars = {}
    for k, v in self._variables.items():
      own = [d for d in dims if d in v.dims]
      rest = [d for d in v.dims if d not in dims]
      new_vars[k] = v.transpose(*(own + rest)) if own else v
    return Dataset(new_vars, dict(self._coords), self.attrs)

  # -- selection -------------------------------------------------------------
  def get_index(self, dim) -> Index:
    if dim in self._coords:
      return Index(_to_numpy(self._coords[dim].data))
    raise KeyError(f"no index coordinate for dim {dim!r}")

  def isel(self, indexers=None, drop=False, **kw):
    indexers = dict(indexers or {})
    indexers.update(kw)
    return _isel_impl(self, indexers, drop)

  def sel(self, indexers=None, method=None, tolerance=None, drop=False, **kw):
    indexers = dict(indexers or {})
    indexers.update(kw)
    return _sel_impl(self, indexers, method, tolerance, drop)

  def thin(self, indexers=None, **kw):
    indexers = dict(indexers or {})
    indexers.update(kw)
    return self.isel({d: slice(None, None, s) for d, s in indexers.items()})

  # -- math ------------------------------------------------------------------
  def _binop_ds(self, other, op, reflexive=False):
    if isinstance(other, Dataset):
      ds = Dataset({}, coords={}, attrs=self.attrs)
      for k in self._variables:
        if k in other._variables:
          ds[k] = self[k]._binop(other[k], op, reflexive)
      # keep non-conflicting dataset-level coords from both operands
      for src in (self, other):
        for cn, cv in src._coords.items():
          if cn not in ds._coords and all(
              ds.sizes.get(d, cv.sizes[d]) == cv.sizes[d] for d in cv.dims):
            ds._coords[cn] = cv
      return ds
    return self.map(lambda da: da._binop(other, op, reflexive))

  __add__ = functools.partialmethod(_binop_ds, op=lambda a, b: a + b)
  __radd__ = functools.partialmethod(
      _binop_ds, op=lambda a, b: a + b, reflexive=True)
  __sub__ = functools.partialmethod(_binop_ds, op=lambda a, b: a - b)
  __rsub__ = functools.partialmethod(
      _binop_ds, op=lambda a, b: a - b, reflexive=True)
  __mul__ = functools.partialmethod(_binop_ds, op=lambda a, b: a * b)
  __rmul__ = functools.partialmethod(
      _binop_ds, op=lambda a, b: a * b, reflexive=True)
  __truediv__ = functools.partialmethod(_binop_ds, op=lambda a, b: a / b)
  __rtruediv__ = functools.partialmethod(
      _binop_ds, op=lambda a, b: a / b, reflexive=True)
  __pow__ = functools.partialmethod(_binop_ds, op=lambda a, b: a**b)
  __gt__ = functools.partialmethod(_binop_ds, op=lambda a, b: a > b)
  __ge__ = functools.partialmethod(_binop_ds, op=lambda a, b: a >= b)
  __lt__ = functools.partialmethod(_binop_ds, op=lambda a, b: a < b)
  __le__ = functools.partialmethod(_binop_ds, op=lambda a, b: a <= b)

  def __neg__(self):
    return self.map(lambda da: -da)

  def __abs__(self):
    return self.map(abs)

  def map(self, func):
    results = {k: func(self[k]) for k in self._variables}
    result_dims = set()
    for res in results.values():
      result_dims.update(res.dims)
    coords = {k: v for k, v in self._coords.items()
              if set(v.dims) <= result_dims}
    out = Dataset({}, coords=coords, attrs=self.attrs)
    for k, res in results.items():
      out[k] = res
    return out

  def where(self, cond, other=np.nan):
    if isinstance(cond, Dataset):
      out = Dataset({}, coords=dict(self._coords), attrs=self.attrs)
      for k in self._variables:
        out[k] = self[k].where(cond[k] if k in cond else cond, other)
      return out
    return self.map(lambda da: da.where(cond, other))

  def _reduce_ds(self, method_name, dim, skipna=False):
    def f(da):
      dims = ([dim] if isinstance(dim, str)
              else (list(dim) if dim is not None else None))
      if dims is not None:
        dims = [d for d in dims if d in da.dims]
        if not dims:
          return da
      return getattr(da, method_name)(dims, skipna=skipna)

    return self.map(f)

  def mean(self, dim=None, skipna=False, **kw):
    return self._reduce_ds("mean", dim, skipna)

  def sum(self, dim=None, skipna=False, **kw):
    return self._reduce_ds("sum", dim, skipna)

  def weighted(self, weights):
    return Weighted(self, weights)


def _expand_dims_impl(obj, dim, axis, dim_kwargs, is_dataset):
  """expand_dims accepting name, {name: size|values}, or kwargs."""
  specs: list[tuple[str, Any]] = []
  if isinstance(dim, str):
    specs.append((dim, 1))
  elif isinstance(dim, Mapping):
    specs.extend(dim.items())
  elif isinstance(dim, Iterable) and dim is not None:
    specs.extend((d, 1) for d in dim)
  specs.extend(dim_kwargs.items())

  out = obj
  for name, val in specs:
    extra_coords = {}
    if isinstance(val, DataArray):
      coord_vals = val.values
      size = coord_vals.shape[0] if coord_vals.ndim else 1
      extra_coords = val.coords
    elif isinstance(val, (int, np.integer)):
      coord_vals = None
      size = int(val)
    else:
      coord_vals = np.asarray(val)
      size = coord_vals.shape[0] if coord_vals.ndim else 1
    if is_dataset:
      new_vars = {
          k: v.expand_dims_var(name, size, axis)
          for k, v in out._variables.items()
      }
      new_coords = dict(out._coords)
    else:
      v = out.variable.expand_dims_var(name, size, axis)
      new_coords = dict(out.coords)
    if coord_vals is not None:
      new_coords[name] = Variable((name,), np.atleast_1d(coord_vals))
    for cn, cv in extra_coords.items():
      new_coords.setdefault(cn, cv if isinstance(cv, Variable) else cv.variable)
    out = (Dataset(new_vars, new_coords, out.attrs) if is_dataset
           else DataArray(v, coords=new_coords, name=out.name))
  return out


# ---------------------------------------------------------------------------
# concat
# ---------------------------------------------------------------------------


def concat(objs, dim: str):
  """Concatenate DataArrays or Datasets along a (new or existing) dim."""
  objs = list(objs)
  if not objs:
    raise ValueError("need at least one object to concatenate")
  if not isinstance(dim, str):
    raise TypeError(f"unsupported concat dim: {dim!r}")

  if isinstance(objs[0], DataArray):
    das = [o if dim in o.dims else o.expand_dims(dim) for o in objs]
    ax = das[0].dims.index(dim)
    base_dims = das[0].dims
    datas = [
        _host((o if o.dims == base_dims else o.transpose(*base_dims)).data)
        for o in das
    ]
    data = _xp.namespace(*datas).concatenate(datas, axis=ax)
    coords = {}
    for o in das:
      for k, v in o.coords.items():
        if dim not in v.dims and k not in coords:
          coords[k] = v
    if all(dim in o.coords for o in das):
      coords[dim] = Variable((dim,), np.concatenate(
          [np.atleast_1d(_to_numpy(o.coords[dim].data)) for o in das]))
    return DataArray(Variable(base_dims, data), coords=coords,
                     name=das[0].name)

  dss = [o if dim in o.sizes else o.expand_dims(dim) for o in objs]
  out = Dataset({}, coords={}, attrs=dss[0].attrs)
  for name in dss[0].keys():
    out[name] = concat([ds[name] for ds in dss], dim)
  for k, v in dss[0].coords_dict().items():
    if dim not in v.dims and k not in out.coords_dict():
      out = out.assign_coords({k: v})
  if (all(dim in ds.coords_dict() for ds in dss)
      and dim not in out.coords_dict()):
    out = out.assign_coords({dim: np.concatenate(
        [np.atleast_1d(_to_numpy(ds.coords_dict()[dim].data))
         for ds in dss])})
  return out



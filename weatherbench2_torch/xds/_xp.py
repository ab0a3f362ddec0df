"""Array namespace for the labeled layer: numpy on the host, torch on a device.

Host payloads stay numpy and device payloads are ``torch.Tensor``.  torch is
not a numpy namespace (``dim`` for ``axis``, no negative-step slices, no
``nan*`` family with tuple axes, dtype objects of its own), so the handful of
functions the labeled layer needs are written out here once, with numpy's
signatures.  ``namespace(*arrays)`` picks the module: torch as soon as one
operand is a tensor, and numpy operands are then moved to that tensor's
device.
"""
from __future__ import annotations

import numpy as np
import torch


def is_tensor(x) -> bool:
  return isinstance(x, torch.Tensor)


def to_numpy(x) -> np.ndarray:
  if is_tensor(x):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def is_floating(x) -> bool:
  if is_tensor(x):
    return x.is_floating_point()
  return np.issubdtype(np.dtype(x.dtype), np.floating)


def torch_dtype(dtype) -> torch.dtype:
  """A torch dtype from a torch dtype, a numpy dtype or a Python type."""
  if isinstance(dtype, torch.dtype):
    return dtype
  return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def like(values: np.ndarray, data):
  """Float64 ``values`` (coefficients computed from coordinates) in
  ``data``'s floating dtype, on its device: a float64 operand would turn a
  float32 payload into float64, twice the bytes on the card."""
  values = np.asarray(values)
  if is_floating(data):
    values = values.astype(torch.empty(0, dtype=data.dtype).numpy().dtype
                           if is_tensor(data) else data.dtype)
  return TORCH.asarray(values, data) if is_tensor(data) else values


def nan_full(shape, data):
  """NaNs of ``shape`` in ``data``'s dtype, on its device."""
  if is_tensor(data):
    return torch.full(tuple(shape), float("nan"), dtype=data.dtype,
                      device=data.device)
  return np.full(tuple(shape), np.nan, dtype=data.dtype)


def _axes(axis):
  if axis is None:
    return None
  return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class _Torch:
  """numpy-signature wrappers over torch, used when any operand is a tensor."""

  @classmethod
  def asarray(cls, x, like=None):
    """``x`` as a tensor on ``like``'s device.  A broadcast numpy view (a
    latitude weight or a region mask broadcast against member-sized data)
    crosses as its distinct values and is expanded on the device: made
    contiguous on the host it would be the size of the data."""
    if is_tensor(x):
      return x
    dev = like.device if is_tensor(like) else None
    arr = np.asarray(x)
    if arr.dtype.kind in "Mm" or arr.dtype == object:
      raise TypeError(f"{arr.dtype} payloads have no device representation")
    if arr.size and 0 in arr.strides:
      distinct = arr[tuple(slice(0, 1) if st == 0 else slice(None)
                           for st in arr.strides)]
      return torch.as_tensor(np.array(distinct), device=dev).expand(arr.shape)
    return torch.as_tensor(np.ascontiguousarray(arr), device=dev)

  @classmethod
  def coerce(cls, *xs):
    """Arrays among ``xs`` as tensors on the first tensor's device;
    Python scalars pass through."""
    like = next((x for x in xs if is_tensor(x)), None)
    return [
        x if (is_tensor(x) or np.ndim(x) == 0 and not isinstance(
            x, np.ndarray)) else cls.asarray(x, like)
        for x in xs
    ]

  @staticmethod
  def transpose(x, order):
    return x.permute(*order)

  @staticmethod
  def expand_dims(x, axis):
    return x.unsqueeze(axis)

  @staticmethod
  def broadcast_to(x, shape):
    return x.expand(*shape)

  @classmethod
  def where(cls, cond, a, b):
    cond, a, b = cls.coerce(cond, a, b)
    if is_tensor(cond) and cond.dtype != torch.bool:
      cond = cond != 0  # numpy's truth of a number (NaN is true)
    return torch.where(cond, a, b)

  @staticmethod
  def isnan(x):
    return torch.isnan(x)

  @staticmethod
  def abs(x):
    return torch.abs(x)

  @staticmethod
  def sqrt(x):
    return torch.sqrt(x)

  @classmethod
  def concatenate(cls, xs, axis=0):
    return torch.cat(cls.coerce(*xs), dim=axis)

  @classmethod
  def stack(cls, xs, axis=0):
    return torch.stack(cls.coerce(*xs), dim=axis)

  @staticmethod
  def ones_like(x):
    return torch.ones_like(x)

  @staticmethod
  def sum(x, axis=None):
    return x.sum() if axis is None else x.sum(dim=_axes(axis))

  @staticmethod
  def mean(x, axis=None):
    return x.mean() if axis is None else x.mean(dim=_axes(axis))

  @staticmethod
  def nansum(x, axis=None):
    return torch.nansum(x, dim=_axes(axis))

  @staticmethod
  def nanmean(x, axis=None):
    return torch.nanmean(x, dim=_axes(axis))

  @staticmethod
  def var(x, axis=None, ddof=0):
    return torch.var(x, dim=_axes(axis), correction=ddof)

  @classmethod
  def std(cls, x, axis=None, ddof=0):
    return torch.sqrt(cls.var(x, axis, ddof))

  @staticmethod
  def nanvar(x, axis=None, ddof=0):
    """numpy's nanvar: NaN where fewer than ``ddof + 1`` values are valid."""
    dims = _axes(axis) or tuple(range(x.ndim))
    valid = ~torch.isnan(x)
    count = valid.sum(dim=dims, keepdim=True).to(x.dtype)
    mean = torch.nansum(x, dim=dims, keepdim=True) / count
    sq = torch.where(valid, (x - mean) ** 2, 0.0).sum(dim=dims, keepdim=True)
    dof = count - ddof
    out = torch.where(dof > 0, sq / dof, torch.nan)
    return out.squeeze(dims) if dims else out

  @classmethod
  def nanstd(cls, x, axis=None, ddof=0):
    return torch.sqrt(cls.nanvar(x, axis, ddof))

  @staticmethod
  def cumsum(x, axis):
    return torch.cumsum(x, dim=axis)

  @staticmethod
  def nancumsum(x, axis):
    return torch.cumsum(torch.where(torch.isnan(x), 0.0, x), dim=axis)

  @staticmethod
  def zeros_like(x):
    return torch.zeros_like(x)

  @staticmethod
  def full_like(x, fill):
    return torch.full_like(x, fill)

  @staticmethod
  def min(x, axis=None):
    return torch.amin(x, dim=_axes(axis) or tuple(range(x.ndim)))

  @staticmethod
  def max(x, axis=None):
    return torch.amax(x, dim=_axes(axis) or tuple(range(x.ndim)))

  @staticmethod
  def _nan_extreme(x, axis, fill, fn):
    """numpy's nanmin/nanmax: NaNs left out, NaN where all are NaN."""
    dims = _axes(axis) or tuple(range(x.ndim))
    nan = torch.isnan(x)
    out = fn(torch.where(nan, fill, x), dim=dims)
    return torch.where(nan.all(dim=dims), torch.nan, out)

  @classmethod
  def nanmin(cls, x, axis=None):
    return cls._nan_extreme(x, axis, torch.inf, torch.amin)

  @classmethod
  def nanmax(cls, x, axis=None):
    return cls._nan_extreme(x, axis, -torch.inf, torch.amax)

  @staticmethod
  def clip(x, lo, hi):
    return torch.clamp(x, lo, hi)

  @staticmethod
  def roll(x, shift, axis):
    return torch.roll(x, shift, dims=axis)

  @staticmethod
  def pad(x, widths, mode):
    """numpy's ``pad`` in ``wrap`` mode (widths no longer than the axis)."""
    if mode != "wrap":
      raise NotImplementedError(f"pad mode {mode!r}")
    for ax, (lo, hi) in enumerate(widths):
      n = x.shape[ax]
      if lo > n or hi > n:
        raise ValueError(f"wrap padding of {lo, hi} on an axis of {n}")
      x = torch.cat([x.narrow(ax, n - lo, lo), x, x.narrow(ax, 0, hi)],
                    dim=ax)
    return x

  @staticmethod
  def log(x):
    return torch.log(x)

  @staticmethod
  def exp(x):
    return torch.exp(x)


TORCH = _Torch()


def namespace(*arrays):
  """``TORCH`` if any operand is a tensor, else numpy."""
  for a in arrays:
    if is_tensor(a):
      return TORCH
  return np


def binop(op, a, b):
  """``op(a, b)`` with numpy operands moved next to a tensor operand."""
  if is_tensor(a) or is_tensor(b):
    a, b = TORCH.coerce(a, b)
  return op(a, b)


def _index_tensor(k, device):
  return torch.as_tensor(np.asarray(k) if not is_tensor(k) else k,
                         device=device).long()


def take(data, key):
  """``data[key]`` for numpy or torch payloads (numpy semantics).

  Index arrays meet torch as int64 tensors on the payload's device.  torch
  refuses negative-step slices, so a key holding one is applied one axis
  at a time, each reversed axis as a positive slice and a flip.
  """
  if not is_tensor(data):
    return data[key]
  key = tuple(key)
  arrays = [i for i, k in enumerate(key) if not isinstance(k, slice)]
  if len(arrays) == 1 and np.ndim(key[arrays[0]]) >= 1 and all(
      k == slice(None) for k in key if isinstance(k, slice)):
    # one gathered axis: an index_select on the device
    dim = arrays[0]
    idx = _index_tensor(key[dim], data.device)
    return data.index_select(dim, idx.reshape(-1)).reshape(
        data.shape[:dim] + idx.shape + data.shape[dim + 1:])
  if not any(isinstance(k, slice) and (k.step or 1) < 0 for k in key):
    return data[tuple(
        k if isinstance(k, slice) or np.ndim(k) == 0 and not is_tensor(k)
        else _index_tensor(k, data.device)
        for k in key
    )]
  out, dim = data, 0
  for k in key:
    if isinstance(k, slice):
      r = range(out.shape[dim])[k]
      if r.step > 0:
        out = out[(slice(None),) * dim + (k,)]
      elif not len(r):
        out = out.narrow(dim, 0, 0)
      else:
        pos = slice(r[-1], r[0] + 1, -r.step)
        out = out[(slice(None),) * dim + (pos,)].flip(dim)
      dim += 1
    elif np.ndim(k) == 0 and not is_tensor(k):
      out = out.select(dim, int(k))
    else:
      idx = _index_tensor(k, out.device)
      out = out.index_select(dim, idx.reshape(-1)).reshape(
          out.shape[:dim] + idx.shape + out.shape[dim + 1:])
      dim += idx.ndim
  return out


def quantile(data, q: np.ndarray, axes, skipna: bool):
  """Quantiles ``q`` of ``data`` over ``axes``, the quantile axis first
  when ``q`` is 1-d: numpy's ``quantile``/``nanquantile`` (default
  ``linear`` method) on host arrays; on a tensor, one sort along the
  reduced axes (``torch.quantile`` refuses more than 2**24 entries) and
  numpy's interpolation, NaN where ``skipna`` is off and a pencil holds a
  NaN or where no entry is valid."""
  if not is_tensor(data):
    import warnings

    with warnings.catch_warnings():
      warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN pencils
      return (np.nanquantile if skipna else np.quantile)(data, q, axis=axes)
  keep = [i for i in range(data.ndim) if i not in axes]
  x = data.permute(*keep, *axes).reshape(
      tuple(data.shape[i] for i in keep) + (-1,))
  nan = torch.isnan(x)
  values, _ = torch.sort(torch.where(nan, torch.inf, x), dim=-1)
  n = x.shape[-1]
  counts = ((~nan).sum(-1) if skipna
            else torch.full(x.shape[:-1], n, device=x.device))
  qs = torch.as_tensor(np.atleast_1d(q), dtype=torch.float64,
                       device=x.device)
  # numpy's linear method: virtual index q (n - 1), lerp of its neighbours
  virtual = qs[:, None] * (counts.reshape(1, -1) - 1).to(torch.float64)
  lo = virtual.floor().clamp(min=0)
  gamma = (virtual - lo).to(x.dtype)
  lo = lo.long()
  hi = torch.minimum(lo + 1, (counts.reshape(1, -1) - 1).clamp(min=0))
  flat = values.reshape(-1, n)
  a = torch.gather(flat.T, 0, lo.clamp(max=n - 1))
  b = torch.gather(flat.T, 0, hi.clamp(max=n - 1))
  diff = b - a
  out = torch.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)
  bad = counts.reshape(1, -1) == 0
  if not skipna:
    bad = bad | nan.any(-1).reshape(1, -1)
  out = torch.where(bad, torch.nan, out)
  out = out.reshape((len(qs),) + tuple(x.shape[:-1]))
  return out[0] if np.ndim(q) == 0 else out

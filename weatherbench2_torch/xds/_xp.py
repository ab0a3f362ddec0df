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


def _axes(axis):
  if axis is None:
    return None
  return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class _Torch:
  """numpy-signature wrappers over torch, used when any operand is a tensor."""

  @classmethod
  def asarray(cls, x, like=None):
    if is_tensor(x):
      return x
    dev = like.device if is_tensor(like) else None
    arr = np.asarray(x)
    if arr.dtype.kind in "Mm" or arr.dtype == object:
      raise TypeError(f"{arr.dtype} payloads have no device representation")
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

"""Zarr template region writes and the host-to-device transfer boundary.

Counterpart of ``weatherbench2_tpu/xds/stream.py`` for the pieces the
evaluation slice needs: ``RegionWriter`` writes large synthetic stores
block by block with bounded host memory, and ``to_device`` moves a
Dataset's payloads to the card through pinned memory on a side stream.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from . import core
from . import io_zarr


class ShapeStub(core.LazyArrayBase):
  """Shape/dtype-only payload for output templates; holds no bytes."""

  __slots__ = ("shape", "dtype")

  def __init__(self, shape: Sequence[int], dtype):
    self.shape = tuple(int(s) for s in shape)
    self.dtype = np.dtype(dtype)

  @property
  def ndim(self) -> int:
    return len(self.shape)

  @property
  def size(self) -> int:
    return int(np.prod(self.shape)) if self.shape else 1

  def __array__(self, dtype=None, copy=None):
    raise ValueError(
        "ShapeStub is a template-only payload and holds no data; "
        "write real chunks through RegionWriter instead."
    )

  def __getitem__(self, key):
    raise ValueError("ShapeStub payloads cannot be sliced.")


def stub_variable(dims: Sequence[str], sizes: Mapping[str, int],
                  dtype, attrs=None) -> core.Variable:
  """A template Variable with no allocated data."""
  return core.Variable(
      tuple(dims), ShapeStub([sizes[d] for d in dims], dtype), attrs
  )


class RegionWriter:
  """Create a zarr template and write pieces into regions of it."""

  def __init__(
      self,
      path: str,
      template: core.Dataset,
      chunks: Optional[Mapping[str, int]] = None,
      compressor=None,
  ):
    io_zarr.create_zarr_template(template, path, chunks=chunks,
                                 compressor=compressor)
    self.path = path
    self._tvars = template.variables_dict()
    self._arrays: dict[str, io_zarr.ZarrArray] = {}

  def write_array(self, name: str, region_key: tuple, data: np.ndarray):
    """Write ``data`` at ``region_key`` (ints/slices) of variable ``name``."""
    arr = self._arrays.get(name)
    if arr is None:
      arr = self._arrays[name] = io_zarr.open_zarr_array(self.path, name)
    data, _ = io_zarr.encode_cf(np.asarray(data))
    region_key = tuple(region_key) + (slice(None),) * (
        len(arr.shape) - len(region_key))
    box = []
    for n, k in zip(arr.shape, region_key):
      r = range(n)[k if isinstance(k, slice) else slice(k, k + 1)]
      if r.step != 1:
        raise ValueError("region writes take unit-step slices")
      box.append((r.start, r.stop) if len(r) else (0, 0))
    arr.write_box(box, data.reshape(tuple(hi - lo for lo, hi in box)))

  def write(self, piece: core.Dataset, region: Mapping[str, Any]) -> None:
    """Write every data variable of ``piece`` at ``region`` (dim → slice)."""
    for name, v in piece.variables_dict().items():
      tvar = self._tvars.get(name)
      if tvar is None:
        raise KeyError(f"{name!r} is not in the output template")
      if v.dims != tvar.dims:
        v = v.transpose(*tvar.dims)
      key = tuple(region.get(d, slice(None)) for d in tvar.dims)
      self.write_array(name, key, np.asarray(v.data).astype(tvar.dtype))

  def finish(self) -> None:
    """Writes are synchronous; kept so callers mark the end of a store."""


def to_device(obj, device: torch.device, stream=None, counter=None):
  """Move the numpy payloads of a Dataset/DataArray (or a dict or tuple
  of them) to ``device``; coordinates stay on the host.

  On a CUDA device each payload is staged in pinned host memory and copied
  with ``non_blocking=True`` on ``stream`` (a side stream, so the copy
  overlaps kernels of the previous chunk); the caller makes its compute
  stream wait for ``stream`` before reading the tensors.  A payload that
  appears more than once in ``obj`` (the thresholds that several metrics
  prepared) crosses once.  ``counter``, a dict, receives the bytes moved
  under ``"h2d_bytes"``.
  """
  moved = {}  # id of a host payload -> (payload, its tensor)

  def put(x):
    if core.is_tensor(x):
      return x
    if id(x) in moved:
      return moved[id(x)][1]
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype.kind in "Mm" or arr.dtype == object:
      return arr
    if counter is not None:
      counter["h2d_bytes"] = counter.get("h2d_bytes", 0) + arr.nbytes
    host = torch.from_numpy(arr)
    if device.type != "cuda":
      out = host
    else:
      with torch.cuda.stream(stream):
        out = host.pin_memory().to(device, non_blocking=True)
    moved[id(x)] = (x, out)
    return out

  def walk(obj):
    if isinstance(obj, core.Dataset):
      return obj.copy(data={k: put(v.data)
                            for k, v in obj.variables_dict().items()})
    if isinstance(obj, core.DataArray):
      return obj.copy(data=put(obj.data))
    if isinstance(obj, dict):
      return {k: walk(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
      return type(obj)(walk(v) for v in obj)
    return obj

  return walk(obj)

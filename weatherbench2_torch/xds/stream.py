"""Streaming-transform scaffolding and the host-to-device transfer boundary.

Counterpart of ``weatherbench2_tpu/xds/stream.py``: ``iter_windows``
enumerates the blocks of a store, ``default_block`` sizes them,
``template_dataset`` makes an allocation-free output template from one
probe block, ``RegionWriter`` writes pieces into regions of it (so stores
of any size stream with bounded host memory), and ``to_device`` moves a
Dataset's payloads to the card through pinned memory on a side stream.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, Mapping, Optional, Sequence

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


def template_dataset(
    probe: core.Dataset,
    full_sizes: Mapping[str, int],
    coords: Optional[Mapping[str, core.Variable]] = None,
) -> core.Dataset:
  """A full-size, allocation-free template from a probe block's output.

  Every dim of ``full_sizes`` grows to its full extent, the others keep the
  probe's size; ``coords`` gives the full-size coordinates of the grown
  dims (a probe-sized coordinate along a grown dim raises).
  """
  tvars = {}
  for name, v in probe.variables_dict().items():
    sizes = {d: int(full_sizes.get(d, v.sizes[d])) for d in v.dims}
    tvars[name] = stub_variable(v.dims, sizes, v.dtype, v.attrs)
  out_coords = dict(probe.coords_dict())
  out_coords.update(coords or {})
  for k, v in out_coords.items():
    for d in v.dims:
      if d in full_sizes and v.sizes[d] != int(full_sizes[d]):
        raise ValueError(
            f"template coord {k!r} has size {v.sizes[d]} along {d!r} but "
            f"the full extent is {full_sizes[d]}; pass a full-size coord.")
  return core.Dataset(tvars, coords=out_coords, attrs=dict(probe.attrs))


def iter_windows(sizes: Mapping[str, int],
                 chunks: Mapping[str, int]) -> Iterator[dict[str, slice]]:
  """Dicts of dim -> slice covering ``sizes`` in C order.

  Dims absent from ``chunks`` (or with chunk -1/None, or one chunk that
  covers them) are not iterated: each window spans them whole and leaves
  them out of the dict.
  """
  dims = [d for d in chunks
          if d in sizes and chunks[d] not in (-1, None)
          and chunks[d] < sizes[d]]
  for d in dims:
    if int(chunks[d]) <= 0:
      raise ValueError(f"chunk size for {d!r} must be positive, got "
                       f"{chunks[d]}")

  def rec(i: int) -> Iterator[dict[str, slice]]:
    if i == len(dims):
      yield {}
      return
    d, step = dims[i], int(chunks[dims[i]])
    for start in range(0, sizes[d], step):
      for rest in rec(i + 1):
        yield {d: slice(start, min(start + step, sizes[d])), **rest}

  yield from rec(0)


# bytes of input per streamed block of the data-prep CLIs: the card takes
# bigger blocks than the host
BLOCK_BYTES = {"cuda": 2 ** 30, "cpu": 2 ** 28}


def default_block(ds: core.Dataset, dim: str, device_type: str) -> int:
  """Entries along ``dim`` that make a block of about ``BLOCK_BYTES`` for
  the device type: the per-entry bytes of every variable that has ``dim``,
  its other dims whole."""
  target_bytes = BLOCK_BYTES[device_type]
  per_step = 0
  for v in ds.variables_dict().values():
    if dim in v.dims:
      per_step += np.dtype(v.dtype).itemsize * v.size // max(1, v.sizes[dim])
  if per_step <= 0:
    return int(ds.sizes.get(dim, 1))
  return max(1, int(target_bytes // per_step))


def orthogonal_select(payload, keys: Sequence[Any]) -> np.ndarray:
  """Outer (per-axis independent) selection of a lazy or numpy payload.

  ``keys`` has one entry per axis: a slice or a 1-d integer array.  A lazy
  payload takes the keys one axis at a time into its view, so that only
  the selected positions are read (each axis's distinct positions, in
  ascending order, then put in the key's order); numpy takes them axis by
  axis.  Unlike numpy's fancy indexing, two position arrays select their
  product, not pairs.
  """
  data = payload
  for ax, k in enumerate(keys):
    if isinstance(k, slice):
      if k != slice(None):
        data = data[(slice(None),) * ax + (k,)]
      continue
    data = data[(slice(None),) * ax + (np.asarray(k, np.int64),)]
  return np.asarray(data)


def clustered_positions(positions: np.ndarray,
                        max_gap: int = 16) -> list[slice]:
  """Sorted distinct ``positions`` grouped into spans: a new span starts
  wherever two neighbours lie more than ``max_gap`` apart.  The spans cover
  every position; a scattered gather over a long axis (members drawn from
  30 years) becomes a few bounded reads."""
  pos = np.unique(np.asarray(positions, dtype=np.int64))
  if pos.size == 0:
    return []
  breaks = np.nonzero(np.diff(pos) > max_gap)[0]
  starts = np.concatenate([[0], breaks + 1])
  ends = np.concatenate([breaks, [pos.size - 1]])
  return [slice(int(pos[a]), int(pos[b]) + 1) for a, b in zip(starts, ends)]


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
    io_zarr.write_region(arr, region_key, data)

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


def read(ds: core.Dataset) -> core.Dataset:
  """``ds`` with every lazy payload read into numpy (once)."""
  return ds.copy(data={
      k: np.asarray(v.data) if isinstance(v.data, core.LazyArrayBase)
      else v.data for k, v in ds.variables_dict().items()})


# Host payloads up to this many entries cross in their own type even in
# the bfloat16 transfer mode (the JAX package's rule).
BFLOAT16_MIN_ENTRIES = 4096


def bfloat16_bits(arr: np.ndarray) -> torch.Tensor:
  """``arr`` (float32 or float64) rounded to bfloat16 on the host, as a
  CPU bfloat16 tensor, bit for bit as ``arr.astype(ml_dtypes.bfloat16)``:
  float64 rounds to float32 first (both steps to nearest, ties to even),
  then the upper 16 bits round to nearest even; NaN becomes the quiet NaN
  of its sign (0x7FC0 or 0xFFC0)."""
  x = torch.from_numpy(np.ascontiguousarray(arr)).to(torch.float32)
  u = x.view(torch.int32)
  # (u + 0x7FFF + lsb) >> 16 in int32, whose sums stay in range for every
  # value but NaN; the low 16 bits are the bfloat16
  bits = (u >> 16) & 1
  bits += u
  bits += 0x7FFF
  bits >>= 16
  nan = torch.isnan(x)
  if nan.any():
    bits.masked_fill_(nan, 0x7FC0)
    bits.masked_fill_(nan & (u < 0), -64)  # 0xFFC0
  return bits.to(torch.int16).view(torch.bfloat16)


def round_to_bfloat16(obj):
  """``obj`` (Datasets, or a tuple of them) with every float32 or float64
  tensor payload of more than ``BFLOAT16_MIN_ENTRIES`` entries rounded to
  bfloat16 where it lies and widened to float32: the values that
  ``to_device`` gives a host payload in the bfloat16 transfer mode
  (through float32, to nearest even).  Host payloads stay as they are."""
  if isinstance(obj, (list, tuple)):
    return type(obj)(round_to_bfloat16(v) for v in obj)

  def narrow(x):
    if (core.is_tensor(x) and x.dtype in (torch.float32, torch.float64)
        and x.numel() > BFLOAT16_MIN_ENTRIES):
      return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    return x

  return obj.copy(data={k: narrow(v.data)
                        for k, v in obj.variables_dict().items()})


def to_device(obj, device: torch.device, stream=None, counter=None,
              transfer_dtype=None, full_precision=()):
  """Move the numpy payloads of a Dataset/DataArray (or a dict or tuple
  of them) to ``device``; coordinates stay on the host.

  On a CUDA device each payload is staged in pinned host memory and copied
  with ``non_blocking=True`` on ``stream`` (a side stream, so the copy
  overlaps kernels of the previous chunk); the caller makes its compute
  stream wait for ``stream`` before reading the tensors.  A payload that
  appears more than once in ``obj`` (the thresholds that several metrics
  prepared) crosses once.  ``counter``, a dict, receives the bytes moved
  under ``"h2d_bytes"``.  With ``transfer_dtype=torch.bfloat16`` a float32
  or float64 payload of more than ``BFLOAT16_MIN_ENTRIES`` entries crosses
  as bfloat16 (``bfloat16_bits``) and becomes float32 on the device: half
  the bytes of float32 at about three significant digits; the Dataset
  variables named in ``full_precision`` cross in their own type.
  """
  moved = {}  # id of a host payload -> (payload, its tensor)

  def put(x, narrowing=transfer_dtype):
    if core.is_tensor(x):
      return x
    if id(x) in moved:
      return moved[id(x)][1]
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype.kind in "Mm" or arr.dtype == object:
      return arr
    narrow = (narrowing == torch.bfloat16
              and arr.dtype in (np.float32, np.float64)
              and arr.size > BFLOAT16_MIN_ENTRIES)
    host = bfloat16_bits(arr) if narrow else torch.from_numpy(arr)
    if counter is not None:
      counter["h2d_bytes"] = (counter.get("h2d_bytes", 0)
                              + host.numel() * host.element_size())
    if device.type != "cuda":
      out = host
    else:
      with torch.cuda.stream(stream):
        out = host.pin_memory().to(device, non_blocking=True)
    if narrow:
      with (torch.cuda.stream(stream) if device.type == "cuda"
            else contextlib.nullcontext()):
        out = out.to(torch.float32)
    moved[id(x)] = (x, out)
    return out

  def walk(obj):
    if isinstance(obj, core.Dataset):
      return obj.copy(data={
          k: put(v.data, None if k in full_precision else transfer_dtype)
          for k, v in obj.variables_dict().items()})
    if isinstance(obj, core.DataArray):
      return obj.copy(data=put(obj.data))
    if isinstance(obj, dict):
      return {k: walk(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
      return type(obj)(walk(v) for v in obj)
    return obj

  return walk(obj)

"""Streaming-transform scaffolding and the host-to-device transfer boundary.

Counterpart of ``weatherbench2_tpu/xds/stream.py``: ``iter_windows``
enumerates the blocks of a store, ``default_block`` sizes them,
``template_dataset`` makes an allocation-free output template from one
probe block, ``RegionWriter`` writes pieces into regions of it (so stores
of any size stream with bounded host memory), and ``to_device`` moves a
Dataset's payloads to the card through pinned memory on a side stream.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import heapq
import itertools
import threading
import time
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
      compressor="default",
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


# Payloads of at least this many bytes are staged as tasks of a
# ``StageQueue`` when the caller gives one; the smaller ones (the time mask,
# the truth's valid-time inverse) cost less to stage than to hand over, and
# stay with the caller.
STAGE_TASK_BYTES = 1 << 20

_QUEUED, _RUNNING, _DONE, _CANCELLED = range(4)


class _Task:
  """One payload's host work, run once by the thread that claims it."""

  __slots__ = ("fn", "state", "result", "error", "thread", "start", "end",
               "tally")

  def __init__(self, fn):
    self.fn = fn
    self.state = _QUEUED
    self.result = self.error = None
    self.tally = io_zarr.tallied()  # the reads' tally of the thread making it

  def run(self, cond: threading.Condition) -> None:
    """Run ``fn`` on this thread, which claimed the task, its reads and
    decodes added to its maker's tally: its result or its exception and
    its seconds are kept, and the waiters on ``cond`` told."""
    start = time.perf_counter()
    result = error = None
    try:
      with io_zarr.tally(self.tally):
        result = self.fn()
    except BaseException as err:  # the task's owner raises it again
      error = err
      raise
    finally:
      end = time.perf_counter()
      with cond:
        self.result, self.error = result, error
        self.thread = threading.get_ident()
        self.start, self.end = start, end
        self.state = _DONE
        cond.notify_all()


class StageQueue:
  """Payload tasks of ``to_device`` shared over the threads of ``pool``.

  A caller of ``to_device`` on one of the pool's threads hands its large
  payloads in as tasks, and puts one helper call a task in the pool: a
  helper runs the queued task of the lowest rank, if one is left, on a
  thread that has nothing else to do.  The caller runs its own tasks while
  any are still queued and waits only on those another thread runs, so no
  thread waits on a task that nobody runs, and no more threads work than
  the pool has.
  """

  def __init__(self, pool: concurrent.futures.Executor):
    self.pool = pool
    self.cond = threading.Condition()
    self._heap: list = []
    self._order = itertools.count()

  def put(self, rank: int, tasks: list) -> None:
    with self.cond:
      for task in tasks:
        heapq.heappush(self._heap, (rank, next(self._order), task))
    for _ in tasks:
      try:
        self.pool.submit(self._help)
      except RuntimeError:  # the pool is shutting down: the callers run them
        break

  def _help(self) -> None:
    with self.cond:
      while self._heap:
        task = heapq.heappop(self._heap)[2]
        if task.state == _QUEUED:
          task.state = _RUNNING
          break
      else:
        return
    task.run(self.cond)


@dataclasses.dataclass
class Staging:
  """One caller's share of a ``StageQueue``: its tasks queue at ``rank``
  (the lowest first), and it counts them: ``tasks`` handed in,
  ``offload_s`` the seconds of those that ran on other threads, and
  ``blocked_s`` the seconds the caller waited while another thread ran one
  of them.  Their reads and decodes go to the caller's ``io_zarr.tally``."""
  queue: StageQueue
  rank: int
  tasks: int = 0
  offload_s: float = 0.0
  blocked_s: float = 0.0


def _nbytes(payload) -> int:
  """The bytes a host payload crosses in its own type, from its shape and
  type alone (a lazy one is not read); 0 for one that stays on the host."""
  dtype = getattr(payload, "dtype", None)
  if not isinstance(dtype, np.dtype) or dtype.kind in "MmO":
    return 0
  return int(getattr(payload, "size", 0)) * dtype.itemsize


def _narrows(narrowing, dtype, size) -> bool:
  return (narrowing == torch.bfloat16 and dtype in (np.float32, np.float64)
          and size > BFLOAT16_MIN_ENTRIES)


def _stage(x, narrowing, device: torch.device, stream):
  """A payload's host work: read it (with its decodes and CF decode), make
  it contiguous, round it to bfloat16 where ``narrowing`` asks, and pin it
  for a CUDA device.  (host array or CPU tensor, narrowed, seconds
  pinning); an array of times or objects stays a host array.  A lazy Zarr
  view whose values are its stored bytes is read straight into pinned
  memory for a CUDA device: no host array of its own is made, filled and
  copied again."""
  if (device.type == "cuda" and isinstance(x, io_zarr.LazyArray) and x.plain
      and not _narrows(narrowing, x.dtype, x.size)):
    with torch.cuda.stream(stream):
      t0 = time.perf_counter()
      pinned = torch.empty(x.shape, pin_memory=True,
                           dtype=torch.from_numpy(np.empty(0, x.dtype)).dtype)
      pin_s = time.perf_counter() - t0
    x.read_into(pinned.numpy())
    return pinned, False, pin_s
  arr = np.ascontiguousarray(np.asarray(x))
  if arr.dtype.kind in "Mm" or arr.dtype == object:
    return arr, False, 0.0
  narrow = _narrows(narrowing, arr.dtype, arr.size)
  host = bfloat16_bits(arr) if narrow else torch.from_numpy(arr)
  if device.type != "cuda":
    return host, narrow, 0.0
  with torch.cuda.stream(stream):
    t0 = time.perf_counter()
    pinned = host.pin_memory()
    return pinned, narrow, time.perf_counter() - t0


def _collect(tasks: list, cond: threading.Condition, staging, deliver):
  """``deliver(i, result)`` for each of ``tasks`` as it finishes; this
  thread runs every one of them still queued, the first first, and waits
  only while another thread runs one.  A task's exception is raised here;
  the tasks not yet claimed then are dropped."""
  me = threading.get_ident()
  left = list(range(len(tasks)))
  try:
    while left:
      with cond:
        ready = [i for i in left if tasks[i].state == _DONE]
        own = None
        if not ready:
          own = next((i for i in left if tasks[i].state == _QUEUED), None)
          if own is None:
            w0 = time.perf_counter()
            while not any(tasks[i].state == _DONE for i in left):
              cond.wait()
            w1 = time.perf_counter()
            # the wait while the first task to end ran: its seconds bound it
            first = min((tasks[i] for i in left if tasks[i].state == _DONE),
                        key=lambda task: task.end)
            staging.blocked_s += max(
                0.0, min(w1, first.end) - max(w0, first.start))
            continue
          tasks[own].state = _RUNNING
      if own is not None:
        tasks[own].run(cond)
        continue
      for i in ready:
        left.remove(i)
        task = tasks[i]
        if task.error is not None:
          raise task.error
        if task.thread != me:
          staging.offload_s += task.end - task.start
        deliver(i, task.result)
  finally:
    with cond:
      for i in left:
        if tasks[i].state == _QUEUED:
          tasks[i].state = _CANCELLED


def to_device(obj, device: torch.device, stream=None, counter=None,
              transfer_dtype=None, full_precision=(), staging=None):
  """Move the numpy payloads of a Dataset/DataArray (or a dict or tuple
  of them) to ``device``; coordinates stay on the host.

  On a CUDA device each payload is staged in pinned host memory and copied
  with ``non_blocking=True`` on ``stream`` (a side stream, so the copy
  overlaps kernels of the previous chunk); the caller makes its compute
  stream wait for ``stream`` before reading the tensors.  A payload that
  appears more than once in ``obj`` (the thresholds that several metrics
  prepared) crosses once.  ``counter``, a dict, receives the bytes moved
  under ``"h2d_bytes"`` and the seconds spent staging them in pinned
  memory under ``"pin_s"``.  With ``transfer_dtype=torch.bfloat16`` a float32
  or float64 payload of more than ``BFLOAT16_MIN_ENTRIES`` entries crosses
  as bfloat16 (``bfloat16_bits``) and becomes float32 on the device: half
  the bytes of float32 at about three significant digits; the Dataset
  variables named in ``full_precision`` cross in their own type.

  Each payload is read, narrowed and pinned, then copied, one after the
  other; a lazy Zarr view of stored values is read straight into pinned
  memory.  With ``staging`` (a ``Staging``), the payloads of at least
  ``STAGE_TASK_BYTES`` are handed to its queue as tasks that idle threads
  may take, the caller stages the rest and its tasks still queued, and
  copies each payload as it is ready; ``staging`` counts the tasks.
  """
  payloads = {}  # id of a host payload -> (payload, its narrowing)

  def register(x, narrowing):
    if not core.is_tensor(x):
      payloads.setdefault(id(x), (x, narrowing))
    return x

  _walk(obj, register, transfer_dtype, full_precision)
  keys = list(payloads)
  tasks = [_Task(functools.partial(_stage, x, narrowing, device, stream))
           for x, narrowing in payloads.values()]
  cond = threading.Condition()
  if staging is not None:
    cond = staging.queue.cond
    handed = [task for key, task in zip(keys, tasks)
              if _nbytes(payloads[key][0]) >= STAGE_TASK_BYTES]
    staging.tasks += len(handed)
    staging.queue.put(staging.rank, handed)
  moved = {}

  def cross(i, staged):
    host, narrow, pin_s = staged
    if core.is_tensor(host):
      if counter is not None:
        counter["h2d_bytes"] = (counter.get("h2d_bytes", 0)
                                + host.numel() * host.element_size())
        if device.type == "cuda":
          counter["pin_s"] = counter.get("pin_s", 0.0) + pin_s
      with (torch.cuda.stream(stream) if device.type == "cuda"
            else contextlib.nullcontext()):
        if device.type == "cuda":
          host = host.to(device, non_blocking=True)
        if narrow:
          host = host.to(torch.float32)
    moved[keys[i]] = host

  _collect(tasks, cond, staging, cross)
  return _walk(obj, lambda x, _: x if core.is_tensor(x) else moved[id(x)],
               transfer_dtype, full_precision)


def _walk(obj, leaf, transfer_dtype, full_precision):
  """``obj`` with each payload ``x`` of its Datasets and DataArrays
  replaced by ``leaf(x, its transfer type)``, in one fixed order."""
  if isinstance(obj, core.Dataset):
    return obj.copy(data={
        k: leaf(v.data, None if k in full_precision else transfer_dtype)
        for k, v in obj.variables_dict().items()})
  if isinstance(obj, core.DataArray):
    return obj.copy(data=leaf(obj.data, transfer_dtype))
  if isinstance(obj, dict):
    return {k: _walk(v, leaf, transfer_dtype, full_precision)
            for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(_walk(v, leaf, transfer_dtype, full_precision)
                     for v in obj)
  return obj

"""Shared parts of the data-prep CLI twins: what a run counts, and reads of
a time axis that keep their overlap on the device.

Every data-prep twin returns the same counts from ``main``: the bytes read
from the store (``io_zarr.READS``), moved to the device and back, the
seconds spent reading, on the device (copies included) and writing, and
the wall time.  The copies are also timed apart (``h2d_s``, ``d2h_s``; on a
card each waits for its copy to end).
"""
from __future__ import annotations

import time

import torch

from weatherbench2_torch import tracing
from weatherbench2_torch import xds
from weatherbench2_torch.xds import _xp
from weatherbench2_torch.xds import io_zarr


class RunCounts(tracing.Counts):
  """A CLI run's counts, with its counted reads and copies; ``result()``
  adds the bytes read and the wall."""

  def __init__(self, **extra):
    super().__init__(h2d_bytes=0, d2h_bytes=0, read_s=0.0, device_s=0.0,
                     write_s=0.0, h2d_s=0.0, d2h_s=0.0, **extra)
    self._t0 = time.perf_counter()
    self._reads0 = io_zarr.READS.bytes

  def read(self, ds: xds.Dataset) -> xds.Dataset:
    """``ds`` with its lazy payloads read."""
    with self.timing("read_s"):
      return xds.read(ds)

  def to_device(self, obj, dev):
    """``xds.to_device``, counting the bytes and the seconds."""
    with self.timing("h2d_s"):
      out = xds.to_device(obj, dev, counter=self)
      if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out

  def to_host(self, obj):
    """A Dataset's (or DataArray's) payloads as numpy, counting the bytes
    of the tensors that come back and the seconds."""
    def back(x):
      if _xp.is_tensor(x):
        if x.is_cuda:  # the work that makes x is not the copy's
          torch.cuda.synchronize(x.device)
        with self.timing("d2h_s"):
          x = _xp.to_numpy(x)
        self["d2h_bytes"] += x.nbytes
      return x

    if isinstance(obj, xds.DataArray):
      return obj.copy(data=back(obj.data))
    return obj.copy(data={k: back(v.data)
                          for k, v in obj.variables_dict().items()})

  def result(self) -> dict:
    self["read_bytes"] = io_zarr.READS.bytes - self._reads0
    self["wall_s"] = time.perf_counter() - self._t0
    return dict(self)


class SlidingReads:
  """Ranges [start, stop) of ``ds``'s ``dim`` (which every variable of
  ``ds`` has) on the device, optionally of one ``tile`` (a window over the
  other dims).  Asked for with both ends never decreasing within a tile,
  the part that the previous range already brought stays there, so that
  each position is read and copied once."""

  def __init__(self, ds: xds.Dataset, dim: str, dev, counts: RunCounts):
    self.ds, self.dim, self.dev, self.counts = ds, dim, dev, counts
    self._tile = None
    self._held = None  # (start, stop, the range on the device)

  def get(self, start: int, stop: int, tile=None) -> xds.Dataset:
    tile = dict(tile or {})
    if tile != self._tile:
      self._tile, self._held = tile, None
    held = self._held
    reuse = held is not None and held[0] <= start <= held[1] <= stop
    first_new = held[1] if reuse else start
    host = self.counts.read(self.ds.isel(
        {**tile, self.dim: slice(first_new, stop)}))
    out = self.counts.to_device(host, self.dev)
    if reuse and held[1] > start:
      out = xds.concat([held[2].isel({self.dim: slice(start - held[0], None)}),
                        out], self.dim)
    self._held = (start, stop, out)
    return out


def write_blocks(path: str, full: dict, stream_chunks: dict, compute,
                 coords: dict, counts: RunCounts, chunks=None) -> None:
  """Write ``compute(window)`` for every window of ``full`` (the sizes of
  the streamed dims) into a store whose template is the first window's
  result at full size, with ``coords`` the streamed dims' coordinates (no
  separate probe reads the input)."""
  writer = None
  for window in xds.iter_windows(full, stream_chunks):
    piece = compute(window)
    with counts.timing("write_s"):
      if writer is None:
        writer = xds.RegionWriter(
            path, xds.template_dataset(piece, full, coords=coords),
            chunks=chunks or stream_chunks)
      writer.write(piece, window)
  writer.finish()

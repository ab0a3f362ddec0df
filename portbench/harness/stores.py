"""Writes a cell's forecast, truth and climatology stores from the seed.

Layouts follow the WeatherBench 2 stores: dims (time, [number,]
prediction_timedelta, [level,] longitude, latitude) for forecasts, one
chunk per init and variable; (time, [level,] longitude, latitude) for the
truth, one chunk per time; (dayofyear, hour, [level,] longitude, latitude)
for the climatology, one chunk per day of year, of which only the days a
job reads are written (absent chunks read as the fill value), except the
SEEPS dry fraction, whose mean over every day is read.  The compressor is
the traffic mix's.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from harness import zarrv2
from harness.fields import HOUR, Fields, Layout


def _time_attrs(first):
  stamp = str(np.datetime64(first, "s")).replace("T", " ")
  return {"units": f"hours since {stamp}", "calendar": "proleptic_gregorian"}


def _host(x: torch.Tensor) -> np.ndarray:
  return x.cpu().numpy()


class _Writer(zarrv2.StoreWriter):

  def coords(self, lay: Layout, *extra):
    self.coord("longitude", lay.lon)
    self.coord("latitude", lay.lat)
    if lay.vars_3d:
      self.coord("level", lay.levels)
    for name, values, attrs in extra:
      self.coord(name, values, attrs)

  def variable(self, name, dims, values: np.ndarray, lead_axes: int,
               lead_sizes=None):
    """Declare ``name`` chunked one index at a time along its first
    ``lead_axes`` axes, whole along the others; ``lead_sizes`` gives those
    axes' sizes where ``values`` holds only some of their chunks."""
    shape = tuple(lead_sizes or values.shape[:lead_axes]) + (
        values.shape[lead_axes:])
    self.create(name, dims, shape, (1,) * lead_axes + values.shape[lead_axes:])

  def chunks_of(self, name, values: np.ndarray, lead_axes: int, offsets=()):
    """Write ``values`` chunk by chunk, its first chunk at ``offsets``."""
    for index in np.ndindex(*values.shape[:lead_axes]):
      at = tuple(i + (offsets[k] if k < len(offsets) else 0)
                 for k, i in enumerate(index))
      self.write_chunk(name, at + (0,) * (values.ndim - lead_axes),
                       values[index][(None,) * lead_axes])


def write_stores(root: str, fields: Fields, compressor, threads: int) -> dict:
  """Write the three stores under ``root``; their paths and the bytes
  written (``bytes``: file bytes, ``raw_bytes``: decoded bytes)."""
  lay = fields.lay
  cfg = lay.config
  paths = {k: os.path.join(root, f"{k}.zarr")
           for k in ("forecast", "truth", "climatology")}
  written = raw = 0
  dims_of = lambda name: ("level",) if lay.is_3d(name) else ()
  space = ("longitude", "latitude")

  # truth: one chunk per time
  w = _Writer(paths["truth"], compressor, threads)
  w.coords(lay, ("time", lay.hours(lay.truth_times).astype(np.int64),
                 _time_attrs(lay.inits[0])))
  for name in lay.variables:
    values = _host(fields.truth(name))
    w.variable(name, ("time",) + dims_of(name) + space, values, 1)
    w.chunks_of(name, values, 1)
    raw += values.nbytes
  mask = _host(fields.land_sea_mask())
  w.create("land_sea_mask", space, mask.shape, mask.shape)
  w.write_chunk("land_sea_mask", (0, 0), mask)
  raw += mask.nbytes
  w.finish()
  written += w.bytes_written

  # forecast: one chunk per init (all members, leads and levels)
  w = _Writer(paths["forecast"], compressor, threads)
  extra = [("time", lay.hours(lay.inits).astype(np.int64),
            _time_attrs(lay.inits[0])),
           ("prediction_timedelta", (lay.leads / HOUR).astype(np.int64),
            {"units": "hours"})]
  member_dims = ()
  if lay.members:
    extra.append(("number", np.arange(lay.members, dtype=np.int64), {}))
    member_dims = ("number",)
  w.coords(lay, *extra)
  for name in lay.variables:
    values = _host(fields.forecast(name))
    w.variable(name, ("time",) + member_dims + ("prediction_timedelta",)
               + dims_of(name) + space, values, 1)
    w.chunks_of(name, values, 1)
    raw += values.nbytes
  w.finish()
  written += w.bytes_written

  # climatology: one chunk per day of year, only the days read
  clim = cfg["climatology"]
  w = _Writer(paths["climatology"], compressor, threads)
  extra = [("dayofyear", lay.doys.astype(np.int64), {}),
           ("hour", lay.clim_hours.astype(np.int64), {})]
  quantiles = clim.get("quantiles")
  if quantiles:
    extra.append(("quantile", np.asarray(quantiles, np.float64), {}))
  w.coords(lay, *extra)
  doys = lay.read_doys
  first = int(doys[0]) - 1
  if not np.array_equal(doys, np.arange(doys[0], doys[-1] + 1)):
    raise ValueError(f"the days of year read are not contiguous: {doys}")
  n_doy, n_hour = len(lay.doys), len(lay.clim_hours)
  for name in lay.variables:
    cdims = ("dayofyear", "hour") + dims_of(name) + space
    mean = _host(fields.climatology(name, doys))
    w.variable(name, cdims, mean, 1, (n_doy,))
    if clim.get("means_read", True):
      w.chunks_of(name, mean, 1, (first,))
      raw += mean.nbytes
    if quantiles:
      qname = f"{name}_quantile"
      q = _host(fields.quantiles(name, doys, quantiles))
      w.create(qname, ("quantile",) + cdims,
               (len(quantiles), n_doy) + q.shape[2:],
               (len(quantiles), 1) + q.shape[2:])
      for d in range(len(doys)):
        w.write_chunk(qname, (0, first + d) + (0,) * (q.ndim - 2),
                      q[:, d:d + 1])
      raw += q.nbytes
  if clim.get("seeps"):
    precip = clim["seeps"]
    cdims = ("dayofyear", "hour") + space
    thr = _host(fields.seeps_threshold(doys))
    w.variable(f"{precip}_seeps_threshold", cdims, thr, 1, (n_doy,))
    w.chunks_of(f"{precip}_seeps_threshold", thr, 1, (first,))
    dry = _host(fields.dry_fraction())
    w.create(f"{precip}_seeps_dry_fraction", cdims, (n_doy, n_hour) + (
        dry.shape), (1, n_hour) + dry.shape)
    block = np.broadcast_to(dry, (1, n_hour) + dry.shape)
    for d in range(n_doy):
      w.write_chunk(f"{precip}_seeps_dry_fraction", (d, 0, 0, 0), block)
    raw += thr.nbytes + n_doy * block.nbytes
  w.finish()
  written += w.bytes_written
  return {"paths": paths, "bytes": written, "raw_bytes": raw}

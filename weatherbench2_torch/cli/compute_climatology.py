r"""Compute and save a climatology (day of year [x hour of day]), on a CUDA
card.

The twin of ``scripts/compute_climatology.py`` (the JAX package's CLI):
the same flags and defaults, plus ``--device``.  It runs on the card unless
``--device=cpu`` is given; without a card it raises.  ``--use_device`` is
accepted and does not choose the device: every method and statistic runs
on the card (the JAX script moves only ``--method=explicit`` mean, std and
quantile there, and only with that flag).

Example:
  python -m weatherbench2_torch.cli.compute_climatology \
    --input_path=/data/era5_240x121.zarr \
    --output_path=/data/climatology.zarr \
    --frequency=hourly --hour_interval=6 --window_size=61 \
    --start_year=1990 --end_year=2019 --statistics=mean,std

Each spatial tile (``--working_chunks``; by default the whole grid) of the
climatology years moves to the device once.  Per hour of day (or per day,
after daily means), the years are stacked to (year, day of year, ...) and:
``mean``/``std`` are circulant-window matmuls (``--method=explicit``) or a
day-of-year group reduction and a circulant smoothing (``fast``);
``quantile`` and ``seeps`` sort each day's wrapped (year x window) pool,
per pencil.  The output template comes from the first tile's results (no
separate probe read); each tile is written into its region of the store.
"""
import ast

import numpy as np
import torch

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep
from weatherbench2_torch.ops import climatology as clim_ops

DEFAULT_SEEPS_THRESHOLD_MM = (
    "{'total_precipitation_24hr':0.25, 'total_precipitation_6hr':0.1}")


def build_parser():
  """The flags of ``scripts/compute_climatology.py``, and ``--device``."""
  f = flag_utils.Flags(
      "python -m weatherbench2_torch.cli.compute_climatology", __doc__)
  f.string("input_path", None, "Input Zarr path")
  f.string("output_path", None, "Output Zarr path")
  f.string("frequency", "hourly",
           '"hourly": per day-of-year and hour-of-day; "daily": per '
           "day-of-year.")
  f.integer("hour_interval", 1,
            "Hour-of-day interval for hourly climatology.")
  f.integer("window_size", 61, "Window size in days to average over.")
  f.integer("start_year", 1990, "Inclusive start year of climatology")
  f.integer("end_year", 2020, "Inclusive end year of climatology")
  f.chunks("working_chunks", "",
           'Spatial tile sizes for streaming, e.g. '
           '"longitude=32,latitude=32".')
  f.chunks("output_chunks", "", "Chunk sizes for the output store.")
  f.integer("rechunk_itemsize", 4, "(accepted for compatibility; unused)")
  f.listing("statistics", ["mean"],
            'Statistics from "mean", "std", "seeps", "quantile".')
  f.listing("quantiles", [], "Quantiles to compute.")
  f.string("method", "explicit",
           '"explicit" (windowed weighted stat over stacked years) or '
           '"fast" (stat per day-of-year, then weighted smoothing).')
  f.string("seeps_dry_threshold_mm", DEFAULT_SEEPS_THRESHOLD_MM,
           "Dict of per-variable dry thresholds (mm) for SEEPS.")
  f.string("runner", None, "(ignored)")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.boolean("use_device", False,
            "(accepted for compatibility: every statistic runs on the "
            "device that --device names)")
  f.device()
  return f.parser


def _result_dims(lead, var_dims) -> tuple:
  """A result's dims: ``lead`` (``quantile``), then the variable's dims
  with ``time`` -> ``dayofyear``, as the JAX package orders them."""
  return tuple(lead) + tuple("dayofyear" if d == "time" else d
                             for d in var_dims)


class Quantile:
  """Weighted interpolated quantiles over each day's (window, year) pool;
  equal values in the order of the script's (value, weight) sort."""

  def __init__(self, quantiles):
    self.quantiles = [float(q) for q in quantiles]

  def compute(self, ds: xds.Dataset, window_weights) -> xds.Dataset:
    """``ds``: one hour's (or the days') values, with a time dim."""
    stacked = utils.stack_years(ds)
    out = xds.Dataset({}, coords={
        k: v for k, v in stacked.coords_dict().items() if k != "year"})
    for name in stacked.keys():
      res = clim_ops.device_window_quantile(
          stacked[name].data, len(window_weights), self.quantiles,
          window_weights)
      var = xds.Variable(("quantile",) + stacked[name].dims[1:], res)
      out[name] = var.transpose(*_result_dims(("quantile",), ds[name].dims))
    return out.assign_coords(quantile=np.asarray(self.quantiles))


class SEEPSThreshold:
  """SEEPS wet threshold (weighted q = 2/3 of the pool's wet values) and
  dry fraction (the unweighted share of dry values over every window
  position, the zero-weight edges included)."""

  def __init__(self, dry_threshold_mm: float, var: str):
    self.dry_threshold_m = dry_threshold_mm / 1000.0
    self.var = var

  def compute(self, ds: xds.Dataset, window_weights) -> xds.Dataset:
    stacked = utils.stack_years(ds[[self.var]])
    x = stacked[self.var].data
    is_dry = x < self.dry_threshold_m  # NaN is not dry, as in numpy
    dry_fraction = clim_ops.window_dry_fraction(is_dry, len(window_weights))
    wet = torch.where(is_dry, torch.nan, x)
    threshold = clim_ops.device_window_quantile(
        wet, len(window_weights), [2 / 3], window_weights)[0]
    dims = stacked[self.var].dims[1:]
    order = _result_dims((), ds[self.var].dims)
    coords = {k: v for k, v in stacked.coords_dict().items()
              if k != "year" and set(v.dims) <= set(dims)}
    return xds.Dataset({
        f"{self.var}_seeps_threshold":
            xds.Variable(dims, threshold).transpose(*order),
        f"{self.var}_seeps_dry_fraction":
            xds.Variable(dims, dry_fraction).transpose(*order),
    }, coords=coords)


class _Run:
  """One run's settings, shared by every tile."""

  def __init__(self, args):
    self.args = args
    self.clim_years = slice(str(args.start_year), str(args.end_year))
    self.window_weights = utils.create_window_weights(
        args.window_size).values
    self.hours = (np.arange(0, 24, args.hour_interval)
                  if args.frequency == "hourly" else None)
    if args.frequency not in ("hourly", "daily"):
      raise NotImplementedError(
          f"frequency {args.frequency} not implemented.")

  def per_period(self, obs_tile: xds.Dataset, fn) -> xds.Dataset:
    """``fn`` of each hour's values (with ``hour`` prepended) or of the
    daily means."""
    if self.hours is None:
      return fn(utils.resample_daily_mean(obs_tile))
    return xds.concat([fn(utils.select_hour(obs_tile, int(h))).expand_dims(
        hour=[h]) for h in self.hours], "hour")

  def stat(self, obs_tile: xds.Dataset, statistic: str,
           quantiles) -> xds.Dataset:
    """One statistic of a tile (its climatology years, on the device)."""
    args = self.args
    if statistic == "quantile":
      q = Quantile(quantiles)
      return self.per_period(
          obs_tile, lambda ds: q.compute(ds, self.window_weights))
    if args.method == "explicit":
      return self.per_period(obs_tile, lambda ds: utils.compute_rolling_stat(
          ds, xds.DataArray(self.window_weights, dims=("window",)),
          statistic))
    if self.hours is not None:
      return utils.compute_hourly_stat_fast(
          obs_tile, args.window_size, slice(None), args.hour_interval,
          statistic)
    return utils.compute_daily_stat_fast(obs_tile, args.window_size,
                                         slice(None), statistic)

  def seeps(self, obs_tile: xds.Dataset, var: str,
            threshold_mm: float) -> xds.Dataset:
    if self.args.method != "explicit":
      raise NotImplementedError("SEEPS only tested for explicit.")
    s = SEEPSThreshold(threshold_mm, var=var)
    return self.per_period(
        obs_tile, lambda ds: s.compute(ds, self.window_weights))


def _tile_slices(sizes, tile_spec):
  """Cartesian product of slices over the tiled dims."""
  dims = [d for d in tile_spec if d in sizes and tile_spec[d] not in (-1,)]
  if not dims:
    yield {}
    return

  def rec(i):
    if i == len(dims):
      yield {}
      return
    d = dims[i]
    size = tile_spec[d]
    for start in range(0, sizes[d], size):
      sl = slice(start, min(start + size, sizes[d]))
      for rest in rec(i + 1):
        yield {d: sl, **rest}

  yield from rec(0)


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its tiles."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(tiles=0)
  obs = xds.open_zarr(args.input_path, lazy=True)
  static = [k for k, v in obs.variables_dict().items()
            if "time" not in v.dims]
  if static:
    obs = obs.drop_vars(static)
  tile_spec = dict(args.working_chunks)
  if "time" in tile_spec:
    # a time tile would compute a partial-period climatology and
    # overwrite the full output region per tile
    raise ValueError("cannot include 'time' in --working_chunks")
  run = _Run(args)
  quantiles = [float(q) for q in args.quantiles]
  seeps_mm = ast.literal_eval(args.seeps_dry_threshold_mm)
  sizes = obs.sizes
  obs = obs.sel(time=run.clim_years)
  template = None
  for tile in _tile_slices(sizes, tile_spec or
                           {"longitude": sizes["longitude"]}):
    host_tile = counts.read(obs.isel(tile) if tile else obs)
    with counts.timing("device_s"):
      obs_tile = counts.to_device(host_tile, dev)
      del host_tile
      results = []
      for statistic in args.statistics:
        if statistic == "seeps":
          results += [run.seeps(obs_tile, var, thr)
                      for var, thr in seeps_mm.items() if var in obs]
          continue
        res = run.stat(obs_tile, statistic, quantiles)
        if statistic != "mean":
          res = res.rename({v: f"{v}_{statistic}" for v in res.keys()})
        results.append(res)
      piece = counts.to_host(xds.merge(results))
      del obs_tile, results
    with counts.timing("write_s"):
      if template is None:
        # the output template: the first tile's structure, the full grid
        tvars = {
            name: xds.stub_variable(v.dims, {
                d: sizes[d] if d in ("longitude", "latitude") else v.sizes[d]
                for d in v.dims}, np.float32)
            for name, v in piece.variables_dict().items()}
        coords = {k: v for k, v in piece.coords_dict().items()
                  if k not in ("longitude", "latitude")}
        coords["longitude"] = obs.coords_dict()["longitude"]
        coords["latitude"] = obs.coords_dict()["latitude"]
        template = xds.Dataset(tvars, coords=coords)
        xds.create_zarr_template(template, args.output_path,
                                 chunks=dict(args.output_chunks))
      for name, v in piece.variables_dict().items():
        tdims = template.variables_dict()[name].dims
        v = v.transpose(*tdims) if v.dims != tdims else v
        xds.write_zarr_region(args.output_path, name,
                              tuple(tile.get(d, slice(None)) for d in tdims),
                              np.asarray(v.data, dtype=np.float32))
    counts["tiles"] += 1
  return counts.result()


if __name__ == "__main__":
  main()

r"""Compute (area-weighted) averages over dimensions of a Zarr store, on a
CUDA card.

The twin of ``scripts/compute_averages.py`` (the JAX package's CLI): the
same flags and defaults, plus ``--device``.  It runs on the card unless
``--device=cpu`` is given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.compute_averages \
    --input_path=/data/era5.zarr --output_path=/data/era5_global_mean.zarr \
    --averaging_dims=latitude,longitude --time_start=2020-01-01 \
    --time_stop=2020-12-31

As in the script, where latitude is averaged each value is multiplied by
its latitude's cell-area weight (mean 1 over latitude) and the product is
averaged: a mean of w·x over the cells, with ``--skipna`` over the valid
cells (Σ w·x / N_valid, not Σ w·x / Σ w_valid).

Over ``latitude,longitude`` each (time, level) field is a row of
``ops.fused_region_sums`` (kernel 2) with two regions, the latitude
weights laid out over the cells and ones: the weighted sum is region 0's
``sums``, the valid count region 1's ``wsum_valid`` and the NaN count
region 1's ``nan_w``.  Other dims are torch ops.  Time blocks (about 1 GiB
of input on the card) are read once and reduced on the device; when time
itself is averaged, running (sum, count) accumulators stay on the device
until the end.
"""
import numpy as np
import torch

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import metrics
from weatherbench2_torch import ops
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep

SPATIAL = ("longitude", "latitude")


def build_parser():
  """The flags of ``scripts/compute_averages.py``, and ``--device``."""
  f = flag_utils.Flags("python -m weatherbench2_torch.cli.compute_averages",
                       __doc__)
  f.string("input_path", None, "Input Zarr path")
  f.string("output_path", None, "Output Zarr path")
  f.string("runner", None, "(ignored)")
  f.listing("averaging_dims", None,
            "Dims to average over; latitude triggers area weighting. "
            "Required.")
  f.string("time_dim", "time", "Name of the time dimension to slice on.")
  f.string("time_start", "2020-01-01", "Inclusive start timestamp")
  f.string("time_stop", "2020-12-31", "Inclusive stop timestamp")
  f.listing("levels", None, "Pressure levels to select (default: all).")
  f.listing("variables", None, "Variables to include (default: all).")
  f.boolean("skipna", False, "Skip NaNs in the mean.")
  f.integer("fanout", None, "(ignored)")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.device()
  return f.parser


def spatial_mean(da: xds.DataArray, lat_weights: np.ndarray,
                 skipna: bool) -> xds.DataArray:
  """The mean of w·x over the (longitude, latitude) cells of each field of
  ``da`` (a tensor payload), by one launch of kernel 2; float64, as the
  script's."""
  rest = tuple(d for d in da.dims if d not in SPATIAL)
  x = da.transpose(*rest, *SPATIAL).data
  n_lon, n_lat = x.shape[-2:]
  cells = n_lon * n_lat
  region_w = np.stack([np.broadcast_to(lat_weights, (n_lon, n_lat)).ravel(),
                       np.ones(cells)]).astype(np.float32)
  sums, wsum_valid, nan_w = ops.fused_region_sums(
      x.reshape(-1, cells), torch.as_tensor(region_w, device=x.device))
  if skipna:
    mean = sums[0].double() / wsum_valid[1].double()
  else:
    mean = torch.where(nan_w[1] > 0, torch.nan, sums[0].double() / cells)
  coords = {k: v for k, v in da.coords.items()
            if not set(v.dims) & set(SPATIAL)}
  return xds.DataArray(mean.reshape(x.shape[:-2]), dims=rest, coords=coords,
                       name=da.name)


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its blocks."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(blocks=0)
  ds = xds.open_zarr(args.input_path, lazy=True)
  if args.variables is not None:
    ds = ds[list(args.variables)]
  sel = {}
  time_dim = args.time_dim
  if time_dim in ds.sizes:
    sel[time_dim] = slice(args.time_start, args.time_stop)
  if args.levels and "level" in ds.sizes:
    sel["level"] = [float(level) for level in args.levels]
  if sel:
    ds = ds.sel(sel)
  dims = list(args.averaging_dims)
  weights = metrics.get_lat_weights(ds) if "latitude" in dims else None
  on_kernel = sorted(dims) == sorted(SPATIAL)

  def weighted(block):
    if weights is None:
      return block
    return block.map(lambda da: da * weights if "latitude" in da.dims
                     else da)

  def average(da):
    """One variable's averages, on the device."""
    if on_kernel and set(SPATIAL) <= set(da.dims):
      return spatial_mean(da, weights.values, args.skipna)
    present = [d for d in dims if d in da.dims]
    if not present:
      return da
    if weights is not None and "latitude" in da.dims:
      da = da * weights
    return da.mean(present, skipna=args.skipna)

  def reduce(block):
    """One block's averages (a host block in, a host result out)."""
    host = counts.read(block)
    with counts.timing("device_s"):
      out = counts.to_host(counts.to_device(host, dev).map(average))
    counts["blocks"] += 1
    return out

  if time_dim not in ds.sizes:
    piece = reduce(ds)
    with counts.timing("write_s"):
      xds.to_zarr(piece, args.output_path)
    return counts.result()

  if time_dim in dims:
    out = _time_average(ds, dims, time_dim, weighted, reduce, dev, counts,
                        args.skipna)
    with counts.timing("write_s"):
      xds.to_zarr(out, args.output_path)
    return counts.result()

  coords = {k: v for k, v in ds.coords_dict().items()
            if time_dim in v.dims and not set(v.dims) & set(dims)}
  _prep.write_blocks(
      args.output_path, {time_dim: ds.sizes[time_dim]},
      {time_dim: xds.default_block(ds, time_dim, dev.type)},
      lambda window: reduce(ds.isel(window) if window else ds), coords,
      counts)
  return counts.result()


def _time_average(ds, dims, time_dim, weighted, reduce, dev, counts,
                  skipna) -> xds.Dataset:
  """Averages over ``dims``, time among them: time blocks into running
  (sum, count) accumulators on the device.  Variables without the time
  dim are reduced once, apart, so that no block counts them again."""
  static = [k for k in ds.keys() if time_dim not in ds[k].dims]
  static_out = reduce(ds[static]) if static else None
  ds = ds.drop_vars(static)
  total = count = None
  stream_chunks = {time_dim: xds.default_block(ds, time_dim, dev.type)}
  for window in xds.iter_windows({time_dim: ds.sizes[time_dim]},
                                 stream_chunks):
    host = counts.read(ds.isel(window) if window else ds)
    with counts.timing("device_s"):
      block = weighted(counts.to_device(host, dev))
      s = block.sum(dims, skipna=skipna)
      total = s if total is None else total + s
      if skipna:
        c = block.map(lambda da: da.notnull().astype(np.float64)).sum(dims)
        count = c if count is None else count + c
    counts["blocks"] += 1
  with counts.timing("device_s"):
    if skipna:
      out = total / count
    else:
      out = total.copy()
      for name in total.keys():
        out[name] = total[name] / float(np.prod(
            [ds.sizes[d] for d in dims if d in ds[name].dims]))
    out = counts.to_host(out)
  if static_out is not None:
    for name in static_out.keys():
      out[name] = static_out[name]
  return out


if __name__ == "__main__":
  main()

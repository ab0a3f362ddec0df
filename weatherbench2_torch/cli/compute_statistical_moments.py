r"""Compute raw statistical moments of a Zarr store, on a CUDA card.

The twin of ``scripts/compute_statistical_moments.py`` (the JAX package's
CLI): the same flags and defaults, plus ``--device``.  It runs on the card
unless ``--device=cpu`` is given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.compute_statistical_moments \
    --input_path=/data/era5.zarr --output_path=/data/era5_moments.zarr \
    --start_year=2020 --end_year=2020

Per variable and order, the output ``{var}_{order}`` (``moment`` first, then
the variable's dims other than time, longitude and latitude) holds: the
zeroth moment, the share of valid (non-NaN) cells, and the first and second
raw moments over the valid cells; each over the (longitude, latitude) plane
of every time, then averaged over the times where it is not NaN.

Time blocks (about 1 GiB of input on the card) are read once and go to the
device.  The spatial moments of each (time, level) field are one launch of
``ops.fused_region_sums`` (kernel 2) over the stacked rows of x and x²
(float32) with one region of ones: Σx and Σx² are ``sums``, the valid count
is ``wsum_valid``.  The time sums accumulate on the device in float64, as
the script's.
"""
import numpy as np
import torch

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import ops
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep

ORDERS = ("zeroth", "first", "second")
SPATIAL = ("longitude", "latitude")


def build_parser():
  """The flags of ``scripts/compute_statistical_moments.py``, and
  ``--device``."""
  f = flag_utils.Flags(
      "python -m weatherbench2_torch.cli.compute_statistical_moments",
      __doc__)
  f.string("input_path", None, "Input Zarr path")
  f.string("output_path", None, "Output Zarr path")
  f.integer("start_year", None, "Inclusive start year")
  f.integer("end_year", None, "Inclusive end year")
  f.integer("rechunk_itemsize", 4, "(accepted for compatibility; unused)")
  f.string("runner", None, "(ignored)")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.device()
  return f.parser


def spatial_moments(da: xds.DataArray):
  """(dims, {order: float64 tensor}) of each field of ``da`` (a tensor
  payload) over its longitude and latitude: one launch of kernel 2 over
  the rows of x and then of x²."""
  rest = tuple(d for d in da.dims if d not in SPATIAL)
  x = da.transpose(*rest, *(d for d in SPATIAL if d in da.dims)).data
  shape = tuple(x.shape[:len(rest)])
  rows = x.reshape(int(np.prod(shape)), -1).to(torch.float32)
  n, cells = rows.shape
  sums, wsum_valid, _ = ops.fused_region_sums(
      torch.cat([rows, rows * rows]),
      torch.ones((1, cells), dtype=torch.float32, device=x.device))
  sums, valid = sums[0].double(), wsum_valid[0].double()
  return rest, {"zeroth": (valid[:n] / cells).reshape(shape),
                "first": (sums[:n] / valid[:n]).reshape(shape),
                "second": (sums[n:] / valid[n:]).reshape(shape)}


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its blocks."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(blocks=0)
  obs = xds.open_zarr(args.input_path, lazy=True)
  if args.start_year is not None and args.end_year is not None:
    obs = obs.sel(time=slice(str(args.start_year), str(args.end_year)))

  has_time = "time" in obs.sizes
  stream_chunks = ({"time": xds.default_block(obs, "time", dev.type)}
                   if has_time else {})
  acc: dict = {}  # (name, order) -> [time sum, time count, dims]
  for window in xds.iter_windows(obs.sizes, stream_chunks):
    host = counts.read(obs.isel(window) if window else obs)
    with counts.timing("device_s"):
      block = counts.to_device(host, dev)
      for name in block.keys():
        dims, moments = spatial_moments(block[name])
        for order, sv in moments.items():
          if "time" in dims:
            valid = ~torch.isnan(sv)
            s = torch.where(valid, sv, 0.0).sum(dims.index("time"))
            c = valid.sum(dims.index("time")).double()
          else:
            s, c = sv, torch.ones_like(sv)
          key = (name, order)
          if key in acc:
            acc[key][0] += s
            acc[key][1] += c
          else:
            acc[key] = [s, c, tuple(d for d in dims if d != "time")]
    counts["blocks"] += 1

  out = xds.Dataset({}, coords={
      k: v for k, v in obs.coords_dict().items()
      if not set(v.dims) & {"time", *SPATIAL}})
  with counts.timing("device_s"):
    for order in ORDERS:
      for name in obs.keys():
        total, count, dims = acc[(name, order)]
        temporal = xds.DataArray(total / count, dims=dims)
        out[f"{name}_{order}"] = counts.to_host(
            temporal.expand_dims(moment=1))
  with counts.timing("write_s"):
    xds.to_zarr(out, args.output_path)
  return counts.result()


if __name__ == "__main__":
  main()

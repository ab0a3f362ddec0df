r"""Compute the ensemble mean over the realization dimension, on a CUDA card.

The twin of ``scripts/compute_ensemble_mean.py`` (the JAX package's CLI):
the same flags and defaults, plus ``--device``.  It runs on the card unless
``--device=cpu`` is given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.compute_ensemble_mean \
    --input_path=/data/ifs_ens.zarr --output_path=/data/ifs_ens_mean.zarr \
    --time_start=2020-01-01 --time_stop=2020-12-31

Time blocks (about 1 GiB of input on the card, 256 MiB on the CPU) are
read once, go to the device, are averaged over the members there (``mean``
or, with ``--skipna``, ``nanmean``) and come back to be written into their
region of the output store, whose template is the first block's result at
full length.
"""
from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep

REALIZATION = "realization"


def build_parser():
  """The flags of ``scripts/compute_ensemble_mean.py``, and ``--device``."""
  f = flag_utils.Flags(
      "python -m weatherbench2_torch.cli.compute_ensemble_mean", __doc__)
  f.string("input_path", None, "Input Zarr path")
  f.string("output_path", None, "Output Zarr path")
  f.string("runner", None, "(ignored)")
  f.string("realization_name", REALIZATION,
           "Name of realization/member/number dimension.")
  f.string("time_dim", "time", "Name of the time dimension to slice on.")
  f.string("time_start", "2020-01-01", "Inclusive start timestamp")
  f.string("time_stop", "2020-12-31", "Inclusive stop timestamp")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.listing("variables", None, "Variables to select (default: all).")
  f.boolean("skipna", False, "Skip NaNs in the mean.")
  f.device()
  return f.parser


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its blocks."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(blocks=0)
  ds = xds.open_zarr(args.input_path, lazy=True)
  if args.variables is not None:
    ds = ds[list(args.variables)]
  time_dim, realization = args.time_dim, args.realization_name
  if time_dim in ds.sizes:
    ds = ds.sel({time_dim: slice(args.time_start, args.time_stop)})

  def reduce(block):
    host = counts.read(block)
    with counts.timing("device_s"):
      mean = counts.to_device(host, dev).mean(realization,
                                              skipna=args.skipna)
      out = counts.to_host(mean)
    counts["blocks"] += 1
    return out

  if time_dim not in ds.sizes:
    piece = reduce(ds)
    with counts.timing("write_s"):
      xds.to_zarr(piece, args.output_path)
    return counts.result()

  coords = {k: v for k, v in ds.coords_dict().items()
            if time_dim in v.dims and realization not in v.dims}
  _prep.write_blocks(
      args.output_path, {time_dim: ds.sizes[time_dim]},
      {time_dim: xds.default_block(ds, time_dim, dev.type)},
      lambda window: reduce(ds.isel(window) if window else ds), coords,
      counts)
  return counts.result()


if __name__ == "__main__":
  main()

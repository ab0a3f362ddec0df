r"""Expand a climatology into a time-indexed dataset, on a CUDA card.

The twin of ``scripts/expand_climatology.py`` (the JAX package's CLI): the
same flags and defaults, plus ``--device``.  It runs on the card unless
``--device=cpu`` is given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.expand_climatology \
    --input_path=/data/climatology.zarr \
    --output_path=/data/climatology_2020.zarr \
    --time_start=2020-01-01 --time_stop=2020-12-31

The times run from ``--time_start`` to ``--time_stop`` at the
climatology's hour spacing (daily without an ``hour`` dim).  The
climatology crosses to the device once; each output time block is one
gather there by (day of year[, hour]) (day 366 of a leap year is the
climatology's day 366) and comes back to be written into its region of the
output store.
"""
import numpy as np

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep


def build_parser():
  """The flags of ``scripts/expand_climatology.py``, and ``--device``."""
  f = flag_utils.Flags(
      "python -m weatherbench2_torch.cli.expand_climatology", __doc__)
  f.string("input_path", None, "path to hourly or daily climatology dataset")
  f.string("output_path", None, "path to save outputs in Zarr format")
  f.string("time_start", "2017-01-01", "Inclusive start timestamp")
  f.string("time_stop", "2017-12-31", "Inclusive stop timestamp")
  f.integer("time_chunk_size", None, "Output time chunk size.")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.string("runner", None, "(ignored)")
  f.device()
  return f.parser


def expand_block(climatology: xds.Dataset, times: np.ndarray) -> xds.Dataset:
  """The climatology at each time's (day of year[, hour]): one gather on
  the payloads' device; the day-of-year and hour coordinates dropped."""
  times_da = xds.DataArray(times, dims=("time",), coords={"time": times})
  sel = {"dayofyear": times_da.dt.dayofyear}
  if "hour" in climatology.coords_dict():
    sel["hour"] = times_da.dt.hour
  expanded = climatology.sel(sel)
  return expanded.drop_vars([k for k in ("dayofyear", "hour")
                             if k in expanded.coords_dict()])


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its blocks."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(blocks=0)
  climatology = counts.read(xds.open_zarr(args.input_path, lazy=True))
  if "hour" not in climatology.coords_dict():
    hour_delta = 24
  else:
    hours = np.asarray(climatology.coords_dict()["hour"].data)
    hour_delta = int(hours[1] - hours[0]) if len(hours) > 1 else 24
  times = utils.date_range(args.time_start, args.time_stop,
                           f"{hour_delta}h")
  with counts.timing("device_s"):
    on_device = counts.to_device(climatology, dev)
    probe = counts.to_host(expand_block(on_device, times[:1]))

  n = len(times)
  template = xds.template_dataset(
      probe, {"time": n}, coords={"time": xds.Variable(("time",), times)})
  block = args.time_chunk_size or xds.default_block(template, "time",
                                                    dev.type)
  stream_chunks = {"time": block}
  with counts.timing("write_s"):
    writer = xds.RegionWriter(args.output_path, template,
                              chunks=stream_chunks)
  for window in xds.iter_windows({"time": n}, stream_chunks):
    with counts.timing("device_s"):
      piece = counts.to_host(expand_block(
          on_device, times[window.get("time", slice(0, n))]))
    with counts.timing("write_s"):
      writer.write(piece, window)
    counts["blocks"] += 1
  writer.finish()
  return counts.result()


if __name__ == "__main__":
  main()

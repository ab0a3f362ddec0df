r"""Daily or weekly resampling of a Zarr store, on a CUDA card.

The twin of ``scripts/resample_daily.py`` (the JAX package's CLI, an older
variant of ``resample_in_time``): the same flags and defaults, plus
``--device``.  It runs on the card unless ``--device=cpu`` is given;
without a card it raises.

Example:
  python -m weatherbench2_torch.cli.resample_daily \
    --input_path=/data/era5_6h.zarr --output_path=/data/era5_daily.zarr \
    --period=1d --statistics=mean,min,max --add_statistic_suffix

``--method=resample`` bins by ``--period`` from the first day's midnight;
an accumulated variable (``total_precipitation_24hr``) is always summed,
over its times shifted back by an hour (each day sums its own 24 hours)
and aligned onto the other variables' daily labels.  ``--method=roll``
takes weekly periods over daily input.  The plans are made on the host
(``utils.resample_time_plan``); output-time blocks (time 128 by default,
``--working_chunks`` over the other dims) read the input once, go to the
device, are reduced there (segment reductions or rolling windows, float64)
and come back to be written.
"""
import numpy as np

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep

DAILY_ACCUMULATIVE_VARS = ("total_precipitation_24hr",)
_DEFAULT_TIME_BLOCK = 128


def build_parser():
  """The flags of ``scripts/resample_daily.py``, and ``--device``."""
  f = flag_utils.Flags("python -m weatherbench2_torch.cli.resample_daily",
                       __doc__)
  f.string("input_path", None, "Input Zarr path.")
  f.string("output_path", None, "Output Zarr path.")
  f.string("beam_runner", None, "(ignored)")
  f.string("method", "resample", '"resample" or "roll".')
  f.string("period", "1d", "int + d or w")
  f.listing("statistics", ["mean"], 'From "mean", "min", "max".')
  f.boolean("add_statistic_suffix", False,
            "Add statistic suffix to variable names (required for >1 "
            "statistic).")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.integer("start_year", None, "Start year (inclusive).")
  f.integer("end_year", None, "End year (inclusive).")
  f.chunks("working_chunks", "",
           "Streaming block sizes over OUTPUT dims (default time=128).")
  f.device()
  return f.parser


def plan_jobs(ds, args):
  """(jobs, output times): one job (variables, statistic computed,
  statistic named, "resample" or "roll", (starts, ends) or the window,
  label times) per statistic and group of variables."""
  period = args.period
  times = np.asarray(ds.coords_dict()["time"].data)
  jobs = []
  if args.method == "roll":
    # weekly rolling over daily input only, as the script
    if not period.endswith("w"):
      raise NotImplementedError(
          f"method=roll supports weekly periods only, got {period!r}")
    if len(times) > 1 and not (np.diff(times) == np.timedelta64(1, "D")
                               ).all():
      raise NotImplementedError("method=roll requires daily input data")
    window = 7 * int(period[:-1])
    out_times = times - np.timedelta64(window - 1, "D")
    for statistic in args.statistics:
      jobs.append((list(ds.keys()), statistic, statistic, "roll", window,
                   out_times))
    return jobs, out_times
  accum = [v for v in ds.keys() if v in DAILY_ACCUMULATIVE_VARS]
  normal = [v for v in ds.keys() if v not in DAILY_ACCUMULATIVE_VARS]
  out_times, starts, ends = utils.resample_time_plan(times, period)
  if accum:
    # the accumulated variables' bins, an hour earlier, aligned onto the
    # daily labels (the shifted plan gains a leading partial bin, which
    # the script drops)
    la, sa, ea = utils.resample_time_plan(times - np.timedelta64(1, "h"),
                                          period)
    pos = {t: i for i, t in enumerate(la.tolist())}
    missing = [t for t in out_times.tolist() if t not in pos]
    if missing:
      raise ValueError(
          "accumulative variables cannot be aligned onto the daily axis "
          f"(missing period {np.datetime64(missing[0], 'ns')}); adjust the "
          "time range.")
    keep = np.asarray([pos[t] for t in out_times.tolist()])
  for statistic in args.statistics:
    if normal:
      jobs.append((normal, statistic, statistic, "resample", (starts, ends),
                   out_times))
    if accum:
      # always daily sums; the suffix still names the requested statistic
      jobs.append((accum, "sum", statistic, "resample",
                   (sa[keep], ea[keep]), out_times))
  return jobs, out_times


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its blocks."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(blocks=0)
  ds = xds.open_zarr(args.input_path, lazy=True)
  if args.start_year is not None and args.end_year is not None:
    ds = ds.sel(time=slice(str(args.start_year), str(args.end_year)))
  if len(args.statistics) > 1 and not args.add_statistic_suffix:
    raise ValueError(
        "add_statistic_suffix is required for multiple statistics.")
  jobs, out_times = plan_jobs(ds, args)

  def suffixed(name, statistic):
    if args.add_statistic_suffix and statistic in ("min", "max"):
      return f"{name}_{statistic}"
    return name

  def rows_of(out_sl):
    """The input rows that the output block ``out_sl`` needs."""
    a, b = out_sl.start, out_sl.stop
    lo, hi = [], []
    for _, _, _, kind, info, _ in jobs:
      if kind == "resample":
        lo.append(int(info[0][a]))
        hi.append(int(info[1][b - 1]))
      else:
        lo.append(max(0, a - (info - 1)))
        hi.append(b)
    return min(lo), max(hi)

  def compute(block, first, out_sl):
    """One output block from the input rows [first, ...) on the device."""
    a, b = out_sl.start, out_sl.stop
    pieces = []
    for variables, compute_stat, name_stat, kind, info, label_times in jobs:
      if kind == "resample":
        starts, ends = info
        res = utils.reduce_time_bins(
            block[variables], starts[a:b] - first, ends[a:b] - first,
            label_times[a:b], compute_stat)
      else:
        res = utils.rolling_in_time(block[variables], info, compute_stat)
        res = res.isel(time=slice(a - first, b - first)).assign_coords(
            time=np.asarray(label_times)[a:b])
      pieces.append(res.rename({v: suffixed(v, name_stat)
                                for v in variables}))
    return counts.to_host(xds.merge(pieces))

  # time innermost: a rolling block's left context is still on the device
  stream_chunks = {d: c for d, c in args.working_chunks.items()
                   if d != "time"}
  stream_chunks["time"] = args.working_chunks.get("time",
                                                  _DEFAULT_TIME_BLOCK)
  full = {d: ds.sizes[d] for d in stream_chunks if d in ds.sizes}
  full["time"] = len(out_times)
  reads = _prep.SlidingReads(ds, "time", dev, counts)

  def block_of(window):
    out_sl = window.get("time", slice(0, len(out_times)))
    first, last = rows_of(out_sl)
    block = reads.get(first, last, tile={d: sl for d, sl in window.items()
                                         if d != "time"})
    with counts.timing("device_s"):
      piece = compute(block, first, out_sl)
    counts["blocks"] += 1
    return piece

  _prep.write_blocks(
      args.output_path, full, stream_chunks, block_of,
      {"time": xds.Variable(("time",), out_times),
       **{k: v for k, v in ds.coords_dict().items()
          if set(v.dims) & set(full) and "time" not in v.dims}},
      counts)
  return counts.result()


if __name__ == "__main__":
  main()

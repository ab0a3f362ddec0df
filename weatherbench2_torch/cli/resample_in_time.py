r"""Resample or rolling-aggregate a Zarr store in time, on a CUDA card.

The twin of ``scripts/resample_in_time.py`` (the JAX package's CLI): the
same flags and defaults, plus ``--device``.  It runs on the card unless
``--device=cpu`` is given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.resample_in_time \
    --input_path=/data/era5_6h.zarr --output_path=/data/era5_daily.zarr \
    --method=resample --period=1d --mean_vars=ALL --min_vars=2m_temperature \
    --max_vars=2m_temperature --add_mean_suffix

Per-variable statistic lists (``--mean_vars``, ``--min_vars``,
``--max_vars``, ``--sum_vars``; "ALL" for every variable with a time dim),
``--method=resample`` (bins of ``--period`` from the first day's midnight,
labelled on ``--label_side``) or ``rolling`` (a trailing window of
``--period``).  The binning plan is made on the host
(``utils.resample_time_plan``); output-time blocks (``--working_chunks``,
time 128 by default, other dims whole) read the input once, go to the
device, are reduced there (``utils.reduce_time_bins``, segment reductions,
or ``utils.rolling_in_time``, a cumulative sum or a windowed min or max;
float64, as the script's), and come back to be written.  A rolling block's
left context is the end of the block before, kept on the device.
"""
import numpy as np

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep

_ALL = "ALL"
_DEFAULT_TIME_BLOCK = 128


def build_parser():
  """The flags of ``scripts/resample_in_time.py``, and ``--device``."""
  f = flag_utils.Flags("python -m weatherbench2_torch.cli.resample_in_time",
                       __doc__)
  f.string("input_path", None, "Input Zarr path.")
  f.string("output_path", None, "Output Zarr path.")
  f.string("runner", None, "(ignored)")
  f.string("method", "resample", '"resample" or "rolling".')
  f.string("period", "1d", 'A timedelta string, e.g. "1d" or "1w".')
  f.listing("mean_vars", [], 'Variables to mean ("ALL" for all).')
  f.listing("min_vars", [], 'Variables to min ("ALL" for all).')
  f.listing("max_vars", [], 'Variables to max ("ALL" for all).')
  f.listing("sum_vars", [], 'Variables to sum ("ALL" for all).')
  f.boolean("add_mean_suffix", False, 'Add "_mean" suffix to mean variables.')
  f.string("label_side", "left",
           '"left": window [T, T+period) labelled T; "right": (T-period, T].')
  f.string("time_dim", "time", "Name of the time dimension.")
  f.string("time_start", None, "Inclusive start timestamp")
  f.string("time_stop", None, "Inclusive stop timestamp")
  f.boolean("skipna", False, "Skip NaNs in statistics.")
  f.chunks("working_chunks", "",
           'Streaming block sizes over OUTPUT dims, e.g. '
           '"time=128,longitude=360". Default: time=128, other dims full.')
  f.chunks("output_chunks", "", "Chunk sizes of the output store.")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.device()
  return f.parser


def _expand_all(list_of_vars, ds, time_dim):
  if list_of_vars == [_ALL]:
    return [str(k) for k, v in ds.variables_dict().items()
            if time_dim in v.dims]
  if _ALL in list_of_vars:
    raise ValueError(
        f"Cannot specify both {_ALL} and other variables: {list_of_vars}")
  return list(list_of_vars)


def stat_groups(ds, args):
  """(statistic, present vars, rename suffix) groups from the var flags."""
  groups = []
  for stat, var_list, suffix in [
      ("mean", args.mean_vars, "_mean" if args.add_mean_suffix else ""),
      ("min", args.min_vars, "_min"),
      ("max", args.max_vars, "_max"),
      ("sum", args.sum_vars, "_sum")]:
    present = [v for v in _expand_all(var_list, ds, args.time_dim)
               if v in ds]
    if present:
      groups.append((stat, present, suffix))
  return groups


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its blocks."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(blocks=0)
  ds = xds.open_zarr(args.input_path, lazy=True)
  period = utils.to_timedelta(args.period)
  time_dim = args.time_dim
  if args.time_start is not None or args.time_stop is not None:
    ds = ds.sel({time_dim: slice(args.time_start, args.time_stop)})
  groups = stat_groups(ds, args)
  ds = ds[sorted({v for _, present, _ in groups for v in present})]

  times = np.asarray(ds.coords_dict()[time_dim].data)
  if args.method == "resample":
    label_times, starts, ends = utils.resample_time_plan(times, period,
                                                         args.label_side)
    out_times = label_times
  elif args.method == "rolling":
    delta_t = np.diff(times[:2])[0]
    if period % delta_t:
      raise ValueError(
          f"{delta_t=} between times did not evenly divide {period=}")
    n_window = int(period // delta_t)
    out_times = times
  else:
    raise ValueError(f"Unhandled method={args.method}")

  def compute(block, out_sl):
    """One output block from its input rows on the device."""
    pieces = []
    for stat, present, suffix in groups:
      if args.method == "resample":
        a, b = out_sl.start, out_sl.stop
        res = utils.reduce_time_bins(
            block[present], starts[a:b] - starts[a], ends[a:b] - starts[a],
            label_times[a:b], stat, skipna=args.skipna, time_dim=time_dim)
      else:
        n_context = block.sizes[time_dim] - (out_sl.stop - out_sl.start)
        res = utils.rolling_in_time(
            block[present], n_window, stat, skipna=args.skipna,
            time_dim=time_dim).isel({time_dim: slice(n_context, None)})
      if suffix:
        res = res.rename({v: f"{v}{suffix}" for v in present})
      pieces.append(res)
    return counts.to_host(xds.merge(pieces))

  # time innermost: the windows of one spatial tile follow each other, so
  # that a rolling block's left context is still on the device
  stream_chunks = {d: c for d, c in args.working_chunks.items()
                   if d != time_dim}
  stream_chunks[time_dim] = args.working_chunks.get(time_dim,
                                                    _DEFAULT_TIME_BLOCK)
  full = {d: ds.sizes[d] for d in stream_chunks if d in ds.sizes}
  full[time_dim] = len(out_times)
  reads = _prep.SlidingReads(ds, time_dim, dev, counts)

  def block_of(window):
    out_sl = window.get(time_dim, slice(0, len(out_times)))
    if args.method == "resample":
      rows = (int(starts[out_sl.start]), int(ends[out_sl.stop - 1]))
    else:
      rows = (max(0, out_sl.start - (n_window - 1)), out_sl.stop)
    block = reads.get(*rows, tile={d: sl for d, sl in window.items()
                                   if d != time_dim})
    with counts.timing("device_s"):
      piece = compute(block, out_sl)
    counts["blocks"] += 1
    return piece

  _prep.write_blocks(
      args.output_path, full, stream_chunks, block_of,
      {time_dim: xds.Variable((time_dim,), out_times),
       **{k: v for k, v in ds.coords_dict().items()
          if set(v.dims) & set(full) and time_dim not in v.dims}},
      counts, chunks=dict(args.output_chunks))
  return counts.result()


if __name__ == "__main__":
  main()

r"""Build probabilistic climatological forecasts, on a CUDA card.

The twin of ``scripts/compute_probabilistic_climatological_forecasts.py``
(the JAX package's CLI): the same flags and defaults, plus ``--device``.
It runs on the card unless ``--device=cpu`` is given; without a card it
raises.

Example:
  python -m weatherbench2_torch.cli.compute_probabilistic_climatological_forecasts \
    --input_path=/data/era5.zarr --output_path=/data/clim_forecast.zarr \
    --climatology_start_year=1990 --climatology_end_year=2019 \
    --initial_time_start=2020-01-01 --initial_time_end=2020-12-31 \
    --ensemble_size=50

Each realization of each initial time takes a random climatology year and
a random day-of-year offset within ``--day_window_size`` (edge behaviours
WRAP_YEAR, REFLECT_RANGE and NO_EDGE, sample-hold, with or without
replacement, leave-out years) and reads the input at (sampled init + lead)
for every lead.  The sampling is the script's, on the host, with numpy's
generator in the script's call order: the same seed picks the same years
and days, member for member.  Init blocks (about 1 GiB of output on the
card) read only the positions they use, span by span
(``xds.clustered_positions``), move them to the device once, and gather
the (member, init, lead) output there.
"""
import calendar

import numpy as np
import torch

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep

REALIZATION = "realization"
DELTA = "prediction_timedelta"
WRAP_YEAR = "WRAP_YEAR"
NO_EDGE = "NO_EDGE"
REFLECT_RANGE = "REFLECT_RANGE"


def build_parser():
  """The flags of the script, and ``--device``."""
  f = flag_utils.Flags(
      "python -m weatherbench2_torch.cli."
      "compute_probabilistic_climatological_forecasts", __doc__)
  f.string("input_path", None,
           "Input ground-truth Zarr (daily+ resolution).")
  f.string("output_path", None, "Output Zarr path.")
  f.integer("climatology_start_year", 1990, "Inclusive start sample year.")
  f.integer("climatology_end_year", 2020, "Inclusive end sample year.")
  f.listing("levels", None, "Pressure levels to select (default: all).")
  f.listing("variables", None, "Variables to select (default: all).")
  f.string("time_dim", "time", "Name of the time dimension.")
  f.string("initial_time_start", None, "First initial time in the output.")
  f.string("initial_time_end", None, "Last initial time in the output.")
  f.string("initial_time_spacing", "6h", "Spacing between initial times.")
  f.integer("sample_hold_days", 0,
            "Hold each perturbation constant for this many days (0 = off).")
  f.string("initial_time_edge_behavior", WRAP_YEAR,
           f"{WRAP_YEAR} | {NO_EDGE} | {REFLECT_RANGE}")
  f.string("forecast_duration", "15 days", "Length of forecasts.")
  f.string("timedelta_spacing", "6h", "Spacing between lead times.")
  f.boolean("add_source_time", False,
            "Add a source_time variable recording the sampled input times.")
  f.integer("day_window_size", 15,
            "Width of the day-of-year window to sample from (1..728).")
  f.integer("ensemble_size", 2,
            "-1 means one member per (year, day-perturbation) combination.")
  f.boolean("with_replacement", True, "Sample with replacement.")
  f.boolean("leave_out_if_in_climatology", False,
            "Exclude the init year (+ following years) from the year pool.")
  f.integer("num_years_to_exclude", 0,
            "Extra years after the init year to exclude.")
  f.integer("seed", 802701, "Seed for the RNG.")
  f.chunks("output_chunks", "", "Chunk sizes for the output store.")
  f.string("realization_name", REALIZATION,
           "Name of the ensemble dimension.")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.string("runner", None, "(ignored)")
  f.device()
  return f.parser


def day_perturbation_values(day_window_size: int) -> np.ndarray:
  """Possible day offsets: window centered on 0 (left-heavy when even)."""
  half = day_window_size // 2
  return np.arange(-half, day_window_size - half)


def get_sampled_init_times(
    output_times: np.ndarray,
    climatology_start_year: int,
    climatology_end_year: int,
    day_window_size: int,
    ensemble_size: int,
    with_replacement: bool,
    sample_hold_days: int,
    initial_time_edge_behavior: str,
    leave_out_if_in_climatology: bool = False,
    num_years_to_exclude: int = 0,
    seed: int = 0,
) -> np.ndarray:
  """Sampled historical init times (datetime64[ns]), shape [ensemble,
  n_output_times], for ``output_times`` (datetime64).

  Each output time maps to (random climatology year, random day-of-year
  perturbation on the circular year), with the requested edge behavior.
  The generator's calls are the script's, in its order, so that a seed
  gives the script's samples.
  """
  rng = np.random.default_rng(seed)
  if day_window_size <= 0 or day_window_size > 2 * 364:
    raise ValueError(f"{day_window_size=} not in [1, 728].")
  output_times = np.asarray(output_times).astype("datetime64[ns]")
  out_year, out_doy, out_hour = utils.time_parts(output_times)

  perturbs = day_perturbation_values(day_window_size)
  year_pool = np.arange(climatology_start_year, climatology_end_year + 1)
  n_times = len(output_times)
  if ensemble_size == -1:
    if leave_out_if_in_climatology:
      raise ValueError(
          "ensemble_size=-1 unsupported with leave_out_if_in_climatology.")
    ensemble_size = len(perturbs) * len(year_pool)
  shape = (ensemble_size, n_times)

  if with_replacement:
    day_perturbations = rng.choice(perturbs, size=shape, replace=True)
    if leave_out_if_in_climatology:
      years = np.zeros(shape, dtype=int)
      for j, (t, year) in enumerate(zip(output_times, out_year)):
        pool = year_pool[(year_pool < year)
                         | (year_pool > year + num_years_to_exclude)]
        if pool.size == 0:
          raise ValueError(
              f"No available climatology years for output time {t}")
        years[:, j] = rng.choice(pool, size=ensemble_size, replace=True)
    else:
      years = rng.choice(year_pool, size=shape, replace=True)
  else:
    # each (year, perturbation) combination at most once per output time
    combos = np.array([(y, d) for y in year_pool for d in perturbs],
                      dtype=int)
    years = np.zeros(shape, dtype=int)
    day_perturbations = np.zeros(shape, dtype=int)
    if leave_out_if_in_climatology:
      for j, (t, year) in enumerate(zip(output_times, out_year)):
        pool = combos[(combos[:, 0] < year)
                      | (combos[:, 0] > year + num_years_to_exclude)]
        if len(pool) < ensemble_size:
          raise ValueError(
              f"Not enough (year, day) combinations for output time {t}")
        pick = rng.choice(len(pool), size=ensemble_size, replace=False)
        years[:, j] = pool[pick, 0]
        day_perturbations[:, j] = pool[pick, 1]
    else:
      if ensemble_size > len(combos):
        raise ValueError(
            f"{ensemble_size=} exceeds the {len(combos)} combinations.")
      for j in range(n_times):
        pick = rng.choice(len(combos), size=ensemble_size, replace=False)
        years[:, j] = combos[pick, 0]
        day_perturbations[:, j] = combos[pick, 1]

  dayofyears = out_doy + day_perturbations
  if initial_time_edge_behavior == WRAP_YEAR:
    for year in np.unique(years):
      mask = years == year
      days_in_year = 365 + calendar.isleap(int(year))
      dayofyears[mask] = (dayofyears[mask] - 1) % days_in_year + 1
  elif initial_time_edge_behavior == REFLECT_RANGE:
    for year in {climatology_start_year, climatology_end_year}:
      mask = years == year
      if not np.any(mask):
        continue
      days_in_year = 365 + calendar.isleap(int(year))
      if year == climatology_start_year:
        dayofyears[mask] = np.where(dayofyears[mask] >= 1, dayofyears[mask],
                                    np.abs(dayofyears[mask]) + 2)
      else:
        dayofyears[mask] = np.where(dayofyears[mask] <= days_in_year,
                                    dayofyears[mask],
                                    2 * days_in_year - dayofyears[mask])
  elif initial_time_edge_behavior != NO_EDGE:
    raise ValueError(f"Unhandled {initial_time_edge_behavior=}")

  sampled = (np.array(years - 1970, dtype="datetime64[Y]")
             + np.array(dayofyears - 1, dtype="timedelta64[D]")
             + np.array(out_hour, dtype="timedelta64[h]")
             ).astype("datetime64[ns]")

  if sample_hold_days:
    strides = np.unique(np.diff(output_times))
    if strides.size > 1:
      raise ValueError("Cannot sample-hold with irregular output times.")
    hold = np.timedelta64(sample_hold_days, "D").astype("timedelta64[ns]")
    hold_stride = int(hold // strides[0])
    if strides[0] * hold_stride != hold:
      raise ValueError(
          f"{sample_hold_days=} not a multiple of the output stride.")
    hold_idx = np.repeat(np.arange(n_times // hold_stride + 1),
                         hold_stride)[:n_times]
    # hold the day-offset (in whole days) fixed within each hold period
    delta_days = ((sampled - output_times[None, :])
                  .astype("timedelta64[D]").astype(np.int64))
    first_of_period = np.searchsorted(
        hold_idx, np.arange(n_times // hold_stride + 1))[hold_idx]
    delta_days = delta_days[:, first_of_period]
    sampled = output_times[None, :] + delta_days.astype("timedelta64[D]")
  return sampled


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its blocks."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(blocks=0)
  ds = xds.open_zarr(args.input_path, lazy=True)
  if args.variables is not None:
    ds = ds[list(args.variables)]
  if args.levels and "level" in ds.sizes:
    ds = ds.sel(level=[float(level) for level in args.levels])

  init_times = utils.date_range(args.initial_time_start,
                                args.initial_time_end,
                                args.initial_time_spacing)
  lead_times = utils.timedelta_range(0, args.forecast_duration,
                                     args.timedelta_spacing)
  sampled = get_sampled_init_times(
      init_times, args.climatology_start_year, args.climatology_end_year,
      args.day_window_size, args.ensemble_size, args.with_replacement,
      args.sample_hold_days, args.initial_time_edge_behavior,
      args.leave_out_if_in_climatology, args.num_years_to_exclude,
      args.seed)  # [ensemble, n_init]

  # valid times to read: [ensemble, init, lead]
  source_times = sampled[:, :, None] + lead_times[None, None, :]
  time_dim = args.time_dim
  in_times = np.asarray(ds.coords_dict()[time_dim].data)
  positions = np.clip(np.searchsorted(in_times, source_times), 0,
                      len(in_times) - 1)
  found = in_times[positions] == source_times
  if not found.all():
    missing = np.unique(source_times[~found])
    raise ValueError(f"{missing.size} sampled times missing from the input, "
                     f"e.g. {missing[:4]}")
  positions = positions.astype(np.int64)
  ens, n_init, n_lead = positions.shape
  realization = args.realization_name

  src_vars = ds.variables_dict()
  coords = {k: v for k, v in ds.coords_dict().items()
            if time_dim not in v.dims
            and k not in (time_dim, realization, DELTA)}
  coords["time"] = xds.Variable(("time",), init_times)
  coords[DELTA] = xds.Variable((DELTA,), lead_times)
  coords[realization] = xds.Variable((realization,), np.arange(ens))
  template_vars = {}
  rest_dims = {}
  for name, var in src_vars.items():
    if time_dim not in var.dims:  # static variables pass through
      template_vars[name] = xds.stub_variable(var.dims, var.sizes,
                                              var.dtype, var.attrs)
      continue
    rest = tuple(d for d in var.dims if d != time_dim)
    rest_dims[name] = rest
    sizes = {realization: ens, "time": n_init, DELTA: n_lead,
             **{d: var.sizes[d] for d in rest}}
    template_vars[name] = xds.stub_variable(
        (realization, "time", DELTA) + rest, sizes, var.dtype, var.attrs)
  if args.add_source_time:
    template_vars["source_time"] = xds.stub_variable(
        (realization, "time", DELTA),
        {realization: ens, "time": n_init, DELTA: n_lead},
        source_times.dtype)
  template = xds.Dataset(template_vars, coords=coords, attrs=ds.attrs)

  # init blocks of about BLOCK_BYTES of gathered output
  per_init = sum(np.dtype(src_vars[n].dtype).itemsize * ens * n_lead
                 * int(np.prod([src_vars[n].sizes[d] for d in rest]))
                 for n, rest in rest_dims.items())
  block = max(1, int(xds.stream.BLOCK_BYTES[dev.type] // max(1, per_init)))
  steps_per_day = (max(1, int(np.timedelta64(1, "D")
                              // (in_times[1] - in_times[0])))
                   if len(in_times) > 1 else 1)
  max_gap = max(16, 8 * steps_per_day)

  with counts.timing("write_s"):
    writer = xds.RegionWriter(args.output_path, template,
                              chunks=dict(args.output_chunks) or
                              {"time": block})
    for name in src_vars:
      if name not in rest_dims:
        writer.write_array(name, (), np.asarray(src_vars[name].data))
  for window in xds.iter_windows({"time": n_init}, {"time": block}):
    sl = window.get("time", slice(0, n_init))
    pos_block = positions[:, sl, :]  # (E, B, L)
    used = np.unique(pos_block)
    spans = [used[(used >= s.start) & (used < s.stop)]
             for s in xds.clustered_positions(used, max_gap=max_gap)]
    with counts.timing("device_s"):
      local = torch.as_tensor(np.searchsorted(used, pos_block).ravel(),
                              device=dev)
    for name, rest in rest_dims.items():
      var = src_vars[name]
      t_ax = var.dims.index(time_dim)
      with counts.timing("read_s"):
        parts = [xds.orthogonal_select(
            var.data, [span if ax == t_ax else slice(None)
                       for ax in range(len(var.dims))]) for span in spans]
      with counts.timing("device_s"):
        rows = torch.cat([counts.to_device(
            xds.DataArray(p, dims=var.dims), dev).data for p in parts],
                         dim=t_ax)
        gathered = rows.index_select(t_ax, local).unflatten(
            t_ax, pos_block.shape)
        # (E, B, L) sit at the time axis: bring them first, the other
        # dims after them in the source's order
        gathered = gathered.movedim((t_ax, t_ax + 1, t_ax + 2), (0, 1, 2))
        data = counts.to_host(xds.DataArray(
            gathered, dims=(realization, "time", DELTA) + rest)).data
      with counts.timing("write_s"):
        writer.write_array(name, (slice(None), sl), data)
    if args.add_source_time:
      with counts.timing("write_s"):
        writer.write_array("source_time", (slice(None), sl),
                           source_times[:, sl, :])
    counts["blocks"] += 1
  writer.finish()
  return counts.result()


if __name__ == "__main__":
  main()

r"""Re-index forecasts from (init, lead) to (valid time, lead) or (valid
time, init), on a CUDA card.

The twin of ``scripts/index_on_valid_time.py`` (the JAX package's CLI):
the same flags and defaults, plus ``--device``.  It runs on the card
unless ``--device=cpu`` is given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.index_on_valid_time \
    --input_path=/data/forecast.zarr --output_path=/data/by_valid.zarr \
    --desired_time_dims=valid_and_delta

``valid_and_delta`` gives dims (time, prediction_timedelta) and keeps every
``forecast_spacing``-th lead; ``valid_and_init`` gives (time, init).  The
gather maps are built on the host (``build_gather_maps``).  Valid-time
blocks (about 1 GiB of input on the card) need a range of inits each; the
inits that the block before already brought stay on the device, so that
each is read and copied once.  The gather runs on the device; a (valid,
lead) corner that no forecast reaches is NaN, from the template's fill
value where a whole block has none.  Variables without both time dims are
written through unchanged.
"""
import numpy as np
import torch

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep

TIME = "time"
DELTA = "prediction_timedelta"
INIT = "init"

VALID_AND_DELTA = "valid_and_delta"
VALID_AND_INIT = "valid_and_init"


def build_parser():
  """The flags of ``scripts/index_on_valid_time.py``, and ``--device``."""
  f = flag_utils.Flags(
      "python -m weatherbench2_torch.cli.index_on_valid_time", __doc__)
  f.string("input_path", None, "Input Zarr path.")
  f.string("output_path", None, "Output Zarr path.")
  f.string("desired_time_dims", VALID_AND_DELTA,
           f'"{VALID_AND_DELTA}" or "{VALID_AND_INIT}".')
  f.string("runner", None, "(ignored)")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.device()
  return f.parser


def get_forecast_offset_and_spacing(init_times, lead_times):
  """Offset & spacing between weather forecasts by valid time."""
  init_deltas = np.unique(np.diff(init_times))
  if init_deltas.size > 1:
    raise ValueError(
        f"initialization times are not equidistant: {init_deltas}")
  (init_delta,) = init_deltas
  lead_deltas = np.unique(np.diff(lead_times))
  if lead_deltas.size > 1:
    raise ValueError(f"lead times are not equidistant: {lead_deltas}")
  (lead_delta,) = lead_deltas
  forecast_spacing, remainder = divmod(init_delta, lead_delta)
  if remainder:
    raise ValueError(
        "initialization times not spaced at a multiple of lead times: "
        f"{lead_delta=}, {init_delta=}")
  if lead_times[0] == np.timedelta64(0, "h"):
    forecast_offset = 0
  else:
    forecast_offset = lead_times.tolist().index(forecast_spacing * lead_delta)
  return int(forecast_offset), int(forecast_spacing)


def _positions_in(haystack: np.ndarray, needed: np.ndarray) -> np.ndarray:
  """Positions of ``needed`` values in sorted ``haystack``; -1 if absent."""
  idx = np.searchsorted(haystack, needed)
  idx_cl = np.clip(idx, 0, len(haystack) - 1)
  return np.where(haystack[idx_cl] == needed, idx_cl, -1).astype(np.int64)


def build_gather_maps(init_times, lead_times, desired: str):
  """(valid_index, other_dim, other_coord, gather_init, gather_other).

  ``gather_init[v, o]`` / ``gather_other[v, o]`` address the source
  (time=init, prediction_timedelta) entry landing at output
  (valid_index[v], other[o]); -1 marks a missing corner (NaN output).
  """
  n_init, n_lead = len(init_times), len(lead_times)
  valid_index = np.unique((init_times[:, None] + lead_times[None, :]).ravel())
  if desired == VALID_AND_DELTA:
    gather_init = _positions_in(init_times,
                                valid_index[:, None] - lead_times[None, :])
    gather_other = np.where(gather_init >= 0,
                            np.arange(n_lead, dtype=np.int64)[None, :], -1)
    return valid_index, DELTA, lead_times, gather_init, gather_other
  if desired == VALID_AND_INIT:
    gather_other = _positions_in(lead_times,
                                 valid_index[:, None] - init_times[None, :])
    gather_init = np.where(gather_other >= 0,
                           np.arange(n_init, dtype=np.int64)[None, :], -1)
    return valid_index, INIT, init_times, gather_init, gather_other
  raise ValueError(f"unknown desired_time_dims {desired!r}")


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its blocks."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(blocks=0)
  source = xds.open_zarr(args.input_path, lazy=True)
  init_times = np.asarray(source.coords_dict()[TIME].data)
  lead_times = np.asarray(source.coords_dict()[DELTA].data)
  forecast_offset, forecast_spacing = get_forecast_offset_and_spacing(
      init_times, lead_times)
  if args.desired_time_dims == VALID_AND_DELTA:
    source = source.isel(
        {DELTA: slice(forecast_offset, None, forecast_spacing)})
    lead_times = lead_times[forecast_offset::forecast_spacing]
  valid_index, other_dim, other_coord, gather_init, gather_other = (
      build_gather_maps(init_times, lead_times, args.desired_time_dims))
  n_valid, n_other = gather_init.shape

  coords = {k: v for k, v in source.coords_dict().items()
            if TIME not in v.dims and DELTA not in v.dims}
  coords[TIME] = xds.Variable((TIME,), valid_index)
  coords[other_dim] = xds.Variable((other_dim,), other_coord)
  src_names = [n for n, v in source.variables_dict().items()
               if TIME in v.dims and DELTA in v.dims]
  static = [n for n in source.keys() if n not in src_names]
  template_vars = {}
  for name, var in source.variables_dict().items():
    if name in src_names:
      rest = tuple(d for d in var.dims if d not in (TIME, DELTA))
      sizes = {TIME: n_valid, other_dim: n_other,
               **{d: var.sizes[d] for d in rest}}
      template_vars[name] = xds.stub_variable((TIME, other_dim) + rest,
                                              sizes, np.float32, var.attrs)
    else:
      template_vars[name] = xds.stub_variable(var.dims, var.sizes,
                                              np.float32, var.attrs)
  template = xds.Dataset(template_vars, coords=coords, attrs=source.attrs)

  block = xds.default_block(source, TIME, dev.type)
  with counts.timing("write_s"):
    writer = xds.RegionWriter(args.output_path, template,
                              chunks={TIME: block})
  reads = _prep.SlidingReads(source[src_names], TIME, dev, counts)
  for window in xds.iter_windows({TIME: n_valid}, {TIME: block}):
    sl = window.get(TIME, slice(0, n_valid))
    mask = gather_init[sl] >= 0
    if not mask.any():
      continue  # the template's fill value (NaN) covers this block
    in0 = int(gather_init[sl][mask].min())
    in1 = int(gather_init[sl][mask].max()) + 1
    inits = reads.get(in0, in1)
    with counts.timing("device_s"):
      m = torch.as_tensor(mask, device=dev)
      bi = torch.as_tensor(np.where(mask, gather_init[sl] - in0, 0),
                           device=dev)
      bo = torch.as_tensor(np.where(mask, gather_other[sl], 0), device=dev)
      pieces = {}
      for name in src_names:
        da = inits[name]
        rest = tuple(d for d in da.dims if d not in (TIME, DELTA))
        vals = da.transpose(TIME, DELTA, *rest).data.to(torch.float32)
        picked = vals[bi, bo]
        picked = torch.where(m.reshape(m.shape + (1,) * len(rest)), picked,
                             torch.nan)
        pieces[name] = counts.to_host(xds.DataArray(
            picked, dims=(TIME, other_dim) + rest)).data
    with counts.timing("write_s"):
      for name, data in pieces.items():
        writer.write_array(name, (sl,), data)
    counts["blocks"] += 1
  for name in static:
    host = counts.read(source[[name]])
    with counts.timing("write_s"):
      writer.write_array(name, (), np.asarray(host[name].data, np.float32))
  writer.finish()
  return counts.result()


if __name__ == "__main__":
  main()

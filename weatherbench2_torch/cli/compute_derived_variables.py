r"""Add derived variables to a Zarr store, on a CUDA card.

The twin of ``scripts/compute_derived_variables.py`` (the JAX package's
CLI): the same flags and defaults, plus ``--device``.  It runs on the card
unless ``--device=cpu`` is given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.compute_derived_variables \
    --input_path=/data/era5.zarr \
    --output_path=/data/era5_with_derived.zarr

The input streams in blocks over every dimension that is not a core
dimension of a requested derived variable (a precipitation accumulation
sees the whole lead axis, a spatial operator the whole latitude-longitude
plane).  Each block's base variables go to the device, the derived
variables are computed there and come back to be written, region by
region, into the output store beside the input's own variables.  Derived
variables whose inputs the store lacks are skipped.
"""
import ast
import time

from weatherbench2_torch import derived_variables as dvs
from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import xds
from weatherbench2_torch.xds import _xp

_DEFAULT_DERIVED_VARIABLES = [
    "wind_speed",
    "10m_wind_speed",
    "divergence",
    "vorticity",
    "vertical_velocity",
    "eddy_kinetic_energy",
    "geostrophic_wind_speed",
    "ageostrophic_wind_speed",
    "lapse_rate",
    "total_column_vapor",
    "integrated_vapor_transport",
    "relative_humidity",
    "total_precipitation_6hr",
    "total_precipitation_24hr",
]


def build_parser():
  """The flags of ``scripts/compute_derived_variables.py``, and
  ``--device``."""
  f = flag_utils.Flags(
      "python -m weatherbench2_torch.cli.compute_derived_variables", __doc__)
  f.string("input_path", None, "Input Zarr path")
  f.string("output_path", None, "Output Zarr path")
  f.listing("derived_variables", list(_DEFAULT_DERIVED_VARIABLES),
            "Derived variables to compute.")
  f.listing("preexisting_variables_to_remove", [],
            "Variables to remove from the source before computing.")
  f.boolean("rename_raw_tp_name", False,
            'Rename raw tp name to "total_precipitation".')
  f.string("raw_tp_name", "total_precipitation",
           "Raw name of the total precipitation variable.")
  f.string("rename_variables", None,
           'Dict literal of renames, e.g. {"2t": "2m_temperature"}')
  f.chunks("working_chunks", "",
           'Streaming block sizes over non-core dims, e.g. "time=4". '
           "Default: about 1 GiB (card) or 256 MiB (CPU) of input along the "
           "init/time dim, other dims whole.")
  f.integer("rechunk_itemsize", 4, "(accepted for compatibility; unused)")
  f.integer("max_mem_gb", 1, "(accepted for compatibility; unused)")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.string("runner", None, "(ignored)")
  f.device()
  return f.parser


def _add_derived(block: xds.Dataset, to_compute, dev,
                 counts: dict) -> xds.Dataset:
  """``block`` (read once) with the derived variables, computed on ``dev``
  from the base variables and brought back to the host; ``counts`` gains
  the bytes moved each way."""
  out = xds.read(block)
  bases = list(dict.fromkeys(v for _, dv in to_compute
                             for v in dv.base_variables if v in out))
  on_device = xds.to_device(out[bases], dev, counter=counts)
  for name, dv in to_compute:
    derived = dv.compute(on_device[[v for v in dv.base_variables
                                    if v in block]])
    out[name] = derived.copy(data=_xp.to_numpy(derived.data))
    counts["d2h_bytes"] = counts.get("d2h_bytes", 0) + out[name].data.nbytes
  return out


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts: blocks, the bytes moved to the device and
  back, and the wall time."""
  t0 = time.perf_counter()
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  ds = xds.open_zarr(args.input_path, lazy=True)
  if args.preexisting_variables_to_remove:
    present = [v for v in args.preexisting_variables_to_remove if v in ds]
    if present:
      ds = ds.drop_vars(present)
  if args.rename_raw_tp_name and args.raw_tp_name in ds:
    ds = ds.rename({args.raw_tp_name: "total_precipitation"})
  if args.rename_variables:
    ds = ds.rename(ast.literal_eval(args.rename_variables))

  to_compute = []
  core_dims: set = set()
  for name in args.derived_variables:
    dv = dvs.DERIVED_VARIABLE_DICT[name]
    if any(v not in ds and v != "level" for v in dv.base_variables):
      continue  # its inputs are absent
    to_compute.append((name, dv))
    core_dims |= dv.all_input_core_dims

  # stream over everything that is not a core dim of a requested variable
  sizes = dict(ds.sizes)
  stream_chunks = {}
  for d in ("time", "init_time"):
    if d in sizes and d not in core_dims:
      stream_chunks[d] = xds.default_block(ds, d, dev.type)
  for d, c in args.working_chunks.items():
    if d in core_dims and c not in (-1, None) and c < sizes.get(d, 0):
      raise ValueError(
          f"cannot chunk {d!r}: it is a core dim of a requested derived "
          "variable (the full axis must be resident per block)")
    stream_chunks[d] = c

  streamed = [d for d, c in stream_chunks.items()
              if d in sizes and c not in (-1, None)]
  counts = {"blocks": 0, "h2d_bytes": 0, "d2h_bytes": 0}
  probe = _add_derived(ds.isel({d: slice(0, 1) for d in streamed}),
                       to_compute, dev, {})
  template = xds.template_dataset(
      probe, {d: sizes[d] for d in streamed},
      coords={k: v for k, v in ds.coords_dict().items()
              if set(v.dims) & set(streamed)})
  writer = xds.RegionWriter(
      args.output_path, template,
      chunks={d: c for d, c in stream_chunks.items() if c not in (-1, None)})
  first = True
  for window in xds.iter_windows(template.sizes, stream_chunks):
    if not window and not streamed:
      piece = probe  # nothing is streamed: the probe is the whole store
    else:
      piece = _add_derived(ds.isel(window) if window else ds, to_compute,
                           dev, counts)
    counts["blocks"] += 1
    if not first:  # variables without a streamed dim are written once
      static = [n for n, v in piece.variables_dict().items()
                if not set(v.dims) & set(window)]
      if static:
        piece = piece.drop_vars(static)
    writer.write(piece, window)
    first = False
  writer.finish()
  counts["wall_s"] = time.perf_counter() - t0
  return counts


if __name__ == "__main__":
  main()

r"""Compute zonal energy spectra of a Zarr store, on a CUDA card.

The twin of ``scripts/compute_zonal_energy_spectrum.py`` (the JAX package's
CLI): the same flags and defaults, plus ``--device`` in place of its
``WB2_NO_DEVICE`` switch.  It runs on the card unless ``--device=cpu`` is
given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.compute_zonal_energy_spectrum \
    --input_path=/data/era5_1440x721.zarr \
    --output_path=/data/spectra/era_2020.zarr \
    --time_start=2020 --time_stop=2020 \
    --base_variables=geopotential,temperature,2m_temperature

Each base variable VAR becomes a Parseval-normalized power spectrum over
``zonal_wavenumber`` (with per-latitude frequency and wavelength coords),
averaged over ``--averaging_dims``.  Time blocks stream to the device, where
one ``torch.fft.rfft`` per variable computes the spectrum; when the time
dim is averaged (the official workflow) each block's mean is accumulated
there, weighted by the block's length, and only the result comes back.
Otherwise the spectra of each block are written into a Zarr template.
"""
import time

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import xds
from weatherbench2_torch.derived_variables import ZonalEnergySpectrum
from weatherbench2_torch.xds import _xp

_DEFAULT_BASE_VARIABLES = ["u_component_of_wind", "v_component_of_wind"]
_DEFAULT_LEVELS = ["500", "700", "850"]
_DEFAULT_AVERAGING_DIMS = ["time"]


def build_parser():
  """The flags of ``scripts/compute_zonal_energy_spectrum.py``, and
  ``--device``."""
  f = flag_utils.Flags(
      "python -m weatherbench2_torch.cli.compute_zonal_energy_spectrum",
      __doc__)
  f.string("input_path", None, "Input Zarr path")
  f.string("output_path", None, "Output Zarr path")
  f.listing("base_variables", list(_DEFAULT_BASE_VARIABLES),
            "Variables; each VAR yields a VAR spectrum in the output.")
  f.string("time_dim", "time", "Name of the time dimension to slice on.")
  f.string("time_start", "2020-01-01", "Inclusive start timestamp")
  f.string("time_stop", "2020-12-31", "Inclusive stop timestamp")
  f.listing("levels", list(_DEFAULT_LEVELS),
            "Pressure levels (default 500/700/850).")
  f.listing("averaging_dims", list(_DEFAULT_AVERAGING_DIMS),
            "Dims to average the spectra over.")
  f.integer("fanout", None, "(ignored)")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.string("runner", None, "(ignored)")
  f.device()
  return f.parser


def _to_host(spectra: dict) -> xds.Dataset:
  out = xds.Dataset({}, coords={})
  for name, spectrum in spectra.items():
    out[name] = spectrum.copy(data=_xp.to_numpy(spectrum.data))
  return out


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the spectra;
  returns the run's counts: blocks, the bytes moved to the device, and the
  wall time."""
  t0 = time.perf_counter()
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  ds = xds.open_zarr(args.input_path, lazy=True)
  ds = ds[list(args.base_variables)]
  time_dim = args.time_dim
  sel = {}
  if time_dim in ds.sizes:
    sel[time_dim] = slice(args.time_start, args.time_stop)
  if args.levels and "level" in ds.sizes:
    sel["level"] = [int(level) for level in args.levels]
  if sel:
    ds = ds.sel(sel)
  n = ds.sizes.get(time_dim, 0)
  block_size = xds.default_block(ds, time_dim, dev.type) if n else 0

  counts = {"blocks": 0, "h2d_bytes": 0}

  def block_spectra(block):
    """{VAR: spectrum} of one block, on the device."""
    block = xds.to_device(block, dev, counter=counts)
    counts["blocks"] += 1
    spectra = {}
    for name in args.base_variables:
      spectrum = ZonalEnergySpectrum(name).compute(block[[name]])
      avg = [d for d in args.averaging_dims if d in spectrum.dims]
      spectra[name] = spectrum.mean(avg) if avg else spectrum
    return spectra

  def done():
    counts["wall_s"] = time.perf_counter() - t0
    return counts

  if n == 0:
    xds.to_zarr(_to_host(block_spectra(ds)), args.output_path)
    return done()

  if time_dim in args.averaging_dims:
    # the mean over time as the block means weighted by the block lengths,
    # accumulated on the device
    acc: dict = {}
    for start in range(0, n, block_size):
      block = ds.isel({time_dim: slice(start, start + block_size)})
      w = float(block.sizes[time_dim])
      for name, spectrum in block_spectra(block).items():
        acc[name] = spectrum * w if name not in acc else (
            acc[name] + spectrum * w)
    xds.to_zarr(_to_host({name: total / float(n)
                          for name, total in acc.items()}),
                args.output_path)
    return done()

  # time kept in the output: stream blocks into a zarr template
  probe = _to_host(block_spectra(ds.isel({time_dim: slice(0, 1)})))
  template = xds.template_dataset(
      probe, {time_dim: n},
      coords={k: v for k, v in ds.coords_dict().items() if time_dim in v.dims})
  writer = xds.RegionWriter(args.output_path, template,
                            chunks={time_dim: block_size})
  for window in xds.iter_windows(template.sizes, {time_dim: block_size}):
    writer.write(_to_host(block_spectra(ds.isel(window))), window)
  writer.finish()
  return done()


if __name__ == "__main__":
  main()

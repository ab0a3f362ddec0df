r"""Regrid a whole Zarr store (nearest, bilinear or conservative), on a CUDA
card.

The twin of ``scripts/regrid.py`` (the JAX package's CLI): the same flags
and defaults, plus ``--device`` in place of its ``WB2_NO_DEVICE`` switch.
It runs on the card unless ``--device=cpu`` is given; without a card it
raises.

Example:
  python -m weatherbench2_torch.cli.regrid \
    --input_path=/data/era5_0p25.zarr \
    --output_path=/data/era5_1p5.zarr \
    --longitude_nodes=240 --latitude_nodes=121 \
    --regridding_method=conservative

The grid geometry is computed once on the host (``regridding``).  Time
blocks (``--time_chunk_size``, default about 1 GiB of input on the card,
256 MiB on the CPU) are read, moved to the device, regridded there (two
float32 matmuls a field for the conservative method, gathers for the
others) and written region by region into the output store.
"""
import time

import numpy as np

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import regridding
from weatherbench2_torch import xds
from weatherbench2_torch.xds import _xp
from weatherbench2_torch.xds import io_zarr

REGRIDDERS = {
    "nearest": regridding.NearestRegridder,
    "bilinear": regridding.BilinearRegridder,
    "conservative": regridding.ConservativeRegridder,
}


def build_parser():
  """The flags of ``scripts/regrid.py``, and ``--device``."""
  f = flag_utils.Flags("python -m weatherbench2_torch.cli.regrid", __doc__)
  f.string("input_path", None, "zarr inputs")
  f.string("output_path", None, "zarr outputs")
  f.chunks("output_chunks", "", "desired chunking of the output zarr")
  f.integer("latitude_nodes", None, "number of desired latitude nodes")
  f.integer("longitude_nodes", None, "number of desired longitude nodes")
  f.string("latitude_spacing", "EQUIANGULAR_WITH_POLES",
           "EQUIANGULAR_WITH_POLES or EQUIANGULAR_WITHOUT_POLES")
  f.string("longitude_scheme", "START_AT_ZERO",
           "START_AT_ZERO ([0..360-d]) or CENTER_AT_ZERO "
           "([-180+d/2..180-d/2])")
  f.string("regridding_method", "conservative",
           "nearest | bilinear | conservative")
  f.string("latitude_name", "latitude", "Name of latitude dim in the input")
  f.string("longitude_name", "longitude",
           "Name of longitude dim in the input")
  f.integer("time_chunk_size", None,
            "Stream the time dimension through the device in chunks this "
            "size.")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.string("runner", None, "(ignored)")
  f.device()
  return f.parser


def make_regridder(source_ds: xds.Dataset, args) -> regridding.Regridder:
  """The regridder from the store's grid to the flags' grid."""
  old_lon = np.asarray(source_ds.coords_dict()["longitude"].data)
  old_lat = np.asarray(source_ds.coords_dict()["latitude"].data)
  new_lon = regridding.longitude_values(
      regridding.LongitudeScheme[args.longitude_scheme], args.longitude_nodes)
  new_lat = regridding.latitude_values(
      regridding.LatitudeSpacing[args.latitude_spacing], args.latitude_nodes)
  source_grid = regridding.Grid.from_degrees(lon=old_lon,
                                             lat=np.sort(old_lat))
  target_grid = regridding.Grid.from_degrees(lon=new_lon, lat=new_lat)
  return REGRIDDERS[args.regridding_method](source_grid, target_grid)


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts: blocks, the bytes read from the store, moved to
  the device and back, the seconds spent reading, on the device (copies
  included) and writing, and the wall time."""
  t0 = time.perf_counter()
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  reads0 = io_zarr.READS.bytes
  source_ds = xds.open_zarr(args.input_path, lazy=True)
  renames = {args.longitude_name: "longitude",
             args.latitude_name: "latitude"}
  renames = {k: v for k, v in renames.items() if k != v}
  if renames:
    source_ds = source_ds.rename(renames)
  regridder = make_regridder(source_ds, args)
  counts = {"blocks": 0, "h2d_bytes": 0, "d2h_bytes": 0, "read_s": 0.0,
            "device_s": 0.0, "write_s": 0.0}

  def regrid_block(block, counter):
    t = time.perf_counter()
    block = xds.read(block)
    counter["read_s"] += time.perf_counter() - t
    t = time.perf_counter()
    out = regridder.regrid_dataset(xds.to_device(block, dev, counter=counter))
    host = out.copy(data={k: _xp.to_numpy(v.data)
                          for k, v in out.variables_dict().items()})
    counter["device_s"] += time.perf_counter() - t
    counter["d2h_bytes"] += sum(v.data.nbytes
                                for v in host.variables_dict().values())
    return host

  output_chunks = dict(args.output_chunks)
  if "time" not in source_ds.sizes:
    xds.to_zarr(regrid_block(source_ds, counts), args.output_path,
                chunks=output_chunks)
    counts["blocks"] = 1
  else:
    n = source_ds.sizes["time"]
    chunk = args.time_chunk_size or xds.default_block(source_ds, "time",
                                                      dev.type)
    probe = regrid_block(source_ds.isel(time=slice(0, 1)),
                         dict.fromkeys(counts, 0))
    full_coords = {
        k: v for k, v in source_ds.coords_dict().items()
        if "time" in v.dims and not {"latitude", "longitude"} & set(v.dims)}
    template = xds.template_dataset(probe, {"time": n}, coords=full_coords)
    writer = xds.RegionWriter(
        args.output_path, template,
        chunks=output_chunks or {"time": chunk})
    for window in xds.iter_windows({"time": n}, {"time": chunk}):
      piece = regrid_block(source_ds.isel(window) if window else source_ds,
                           counts)
      t = time.perf_counter()
      writer.write(piece, window or {"time": slice(0, n)})
      counts["write_s"] += time.perf_counter() - t
      counts["blocks"] += 1
    writer.finish()
  counts["read_bytes"] = io_zarr.READS.bytes - reads0
  counts["wall_s"] = time.perf_counter() - t0
  return counts


if __name__ == "__main__":
  main()

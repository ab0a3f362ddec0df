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
others) and written region by region into the output store, whose template
is the first block's result at full length.
"""
import numpy as np

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import regridding
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep

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
  returns the run's counts (``_prep.RunCounts``) and its blocks."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(blocks=0)
  source_ds = xds.open_zarr(args.input_path, lazy=True)
  renames = {args.longitude_name: "longitude",
             args.latitude_name: "latitude"}
  renames = {k: v for k, v in renames.items() if k != v}
  if renames:
    source_ds = source_ds.rename(renames)
  regridder = make_regridder(source_ds, args)

  def regrid_block(block):
    host = counts.read(block)
    with counts.timing("device_s"):
      out = counts.to_host(regridder.regrid_dataset(
          counts.to_device(host, dev)))
    counts["blocks"] += 1
    return out

  output_chunks = dict(args.output_chunks)
  if "time" not in source_ds.sizes:
    piece = regrid_block(source_ds)
    with counts.timing("write_s"):
      xds.to_zarr(piece, args.output_path, chunks=output_chunks)
    return counts.result()
  chunk = args.time_chunk_size or xds.default_block(source_ds, "time",
                                                    dev.type)
  full_coords = {
      k: v for k, v in source_ds.coords_dict().items()
      if "time" in v.dims and not {"latitude", "longitude"} & set(v.dims)}
  _prep.write_blocks(
      args.output_path, {"time": source_ds.sizes["time"]}, {"time": chunk},
      lambda window: regrid_block(source_ds.isel(window) if window
                                  else source_ds),
      full_coords, counts, chunks=output_chunks)
  return counts.result()


if __name__ == "__main__":
  main()

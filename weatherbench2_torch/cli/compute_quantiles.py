r"""Compute quantiles over arbitrary dimensions of a Zarr store, on a CUDA
card.

The twin of ``scripts/compute_quantiles.py`` (the JAX package's CLI): the
same flags and defaults, plus ``--device`` in place of its
``WB2_NO_DEVICE`` switch.  It runs on the card unless ``--device=cpu`` is
given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.compute_quantiles \
    --input_path=/data/era5.zarr --output_path=/data/quantiles.zarr \
    --dim=time --quantiles=0.1,0.5,0.9 --name_suffix=_quantile

The output gains a ``quantile`` dimension; with ``--name_suffix=_quantile``
it is usable as the climatology of the thresholded metrics.  Tiles over the
dims that are not reduced (by default latitude bands of about 1 GiB on the
card, 256 MiB on the CPU) keep the reduced dims whole; each goes to the
device, where one sort per pencil (``xds`` ``quantile``) gives every
quantile, and is written region by region into the output store, whose
template comes from the first tile's results (the JAX script reads a probe
tile first).
"""
from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep


def build_parser():
  """The flags of ``scripts/compute_quantiles.py``, and ``--device``."""
  f = flag_utils.Flags("python -m weatherbench2_torch.cli.compute_quantiles",
                       __doc__)
  f.string("input_path", None, "Path to input zarr")
  f.string("output_path", None, "Path to output zarr")
  f.listing("quantiles", None, "Quantiles in [0, 1].")
  f.listing("dim", [], "Dimensions to reduce over.")
  f.string("name_suffix", "",
           'Suffix for variable names (e.g. "_quantile").')
  f.boolean("skipna", False, "Skip NaNs when computing quantiles.")
  f.listing("levels", None, "Pressure levels to select (default: all).")
  f.string("time_dim", "time", "Time dimension name for slicing.")
  f.string("time_start", "2020-01-01", "Inclusive start timestamp")
  f.string("time_stop", "2020-12-31", "Inclusive stop timestamp")
  f.listing("variables", None, "Variables to include (default: all).")
  f.chunks("working_chunks", "",
           'Streaming tile sizes over the non-reduced dims, e.g. '
           '"latitude=8". Default: tiles of about 1 GiB (card) or 256 MiB '
           "(CPU) over the first non-reduced spatial dim.")
  f.chunks("output_chunks", "", "Chunking of the output store.")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.string("runner", None, "(ignored)")
  f.device()
  return f.parser


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its tiles."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(tiles=0)
  ds = xds.open_zarr(args.input_path, lazy=True)
  if args.variables is not None:
    ds = ds[list(args.variables)]
  sel = {}
  if args.time_dim in ds.sizes:
    sel[args.time_dim] = slice(args.time_start, args.time_stop)
  if args.levels and "level" in ds.sizes:
    sel["level"] = [float(level) for level in args.levels]
  if sel:
    ds = ds.sel(sel)
  empty = {d: n for d, n in ds.sizes.items() if n == 0}
  if empty:
    raise SystemExit(
        f"selection left dimensions empty: {empty} — check "
        f"--time_start/--time_stop against the input's time range")

  quantiles = [float(q) for q in args.quantiles]
  reduce_dims = list(args.dim)

  def compute(block):
    host = counts.read(block)
    with counts.timing("device_s"):
      out = counts.to_device(host, dev).quantile(
          quantiles, dim=reduce_dims, skipna=args.skipna)
      if args.name_suffix:
        out = out.rename({v: f"{v}{args.name_suffix}" for v in out.keys()})
      out = counts.to_host(out)
    counts["tiles"] += 1
    return out

  # the reduced dims stay whole in each tile; tiles stream over the others
  kept = [d for d in ds.sizes if d not in reduce_dims]
  stream_chunks = dict(args.working_chunks)
  if not stream_chunks:
    for cand in ("latitude", "longitude", *kept):
      if cand in kept:
        stream_chunks = {cand: xds.default_block(ds, cand, dev.type)}
        break
  stream_chunks = {d: c for d, c in stream_chunks.items() if d in kept}
  output_chunks = dict(args.output_chunks)
  if not kept or not stream_chunks:
    piece = compute(ds)
    with counts.timing("write_s"):
      xds.to_zarr(piece, args.output_path, chunks=output_chunks)
    return counts.result()
  _prep.write_blocks(
      args.output_path, {d: ds.sizes[d] for d in stream_chunks},
      stream_chunks, lambda window: compute(ds.isel(window) if window
                                            else ds),
      {k: v for k, v in ds.coords_dict().items()
       if set(v.dims) & set(stream_chunks)}, counts, chunks=output_chunks)
  return counts.result()


if __name__ == "__main__":
  main()

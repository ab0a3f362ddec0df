r"""Slice a Zarr store (sel, isel, drop_sel, drop_isel, variables), through
a CUDA card.

The twin of ``scripts/slice_dataset.py`` (the JAX package's CLI): the same
flags and defaults, plus ``--device``.  It runs on the card unless
``--device=cpu`` is given; without a card it raises.

Example:
  python -m weatherbench2_torch.cli.slice_dataset \
    --input_path=/data/era5.zarr --output_path=/data/era5_2020.zarr \
    --sel=level_list=500+850 --sel_strings=time_start=2020,time_stop=2020 \
    --make_dims_increasing=latitude

Flag grammar: ``--sel=DIM_start=...,DIM_stop=...,DIM_step=...,
DIM_list=a+b+c`` (labels; ``--sel_strings`` keeps them strings, as for
years), ``--isel`` the same with positions, ``--drop_sel``,
``--drop_sel_strings`` and ``--drop_isel`` to leave labels or positions
out.  ``--make_dims_increasing`` reverses a decreasing dim before any
selection.

Every selection runs on a skeleton of the store's coordinates and of one
position array per dim, on the host.  Output windows over the largest dim
(about 1 GiB on the card) then read only their positions
(``xds.orthogonal_select``, in ascending order), cross to the device, are
put in the selection's order there (the flips of
``--make_dims_increasing``) and come back to be written.
"""
import re

import numpy as np

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import flag_utils
from weatherbench2_torch import xds
from weatherbench2_torch.cli import _prep
from weatherbench2_torch.xds import _xp


def build_parser():
  """The flags of ``scripts/slice_dataset.py``, and ``--device``."""
  f = flag_utils.Flags("python -m weatherbench2_torch.cli.slice_dataset",
                       __doc__)
  f.string("input_path", None, "Input Zarr path.")
  f.string("output_path", None, "Output Zarr path.")
  f.dim_value_pairs("sel", "",
                    "DIM_{start,stop,step,list} pairs for label selection.")
  f.dim_value_pairs("sel_strings", "",
                    "Like --sel but values kept as strings (e.g. years).")
  f.dim_value_pairs("isel", "", "DIM_{start,stop,step,list} pairs for "
                    "positional selection.")
  f.dim_value_pairs("drop_sel", "", "Labels to drop.")
  f.dim_value_pairs("drop_sel_strings", "", "String labels to drop.")
  f.dim_value_pairs("drop_isel", "", "Positions to drop.")
  f.listing("drop_variables", None, "Variables to drop.")
  f.listing("keep_variables", None, "Variables to keep (default: all).")
  f.listing("make_dims_increasing", [],
            "Dimensions to make increasing, reversing order if needed.")
  f.chunks("output_chunks", "", "Chunking of the output store.")
  f.string("runner", None, "(ignored)")
  f.integer("num_threads", None, "(accepted for compatibility; unused)")
  f.device()
  return f.parser


def parse_selection_grammar(pairs: dict, force_string: bool = False) -> dict:
  """Parse DIM_{start,stop,step,list} pairs into {dim: slice|list}."""
  slices: dict = {}
  lists: dict = {}
  for key, value in pairs.items():
    m = re.fullmatch(r"(\w+)_(start|stop|step|list)", key)
    if not m:
      raise ValueError(
          f"flag key {key!r} does not match VARNAME_(start|stop|step|list)")
    dim, kind = m.group(1), m.group(2)
    if kind == "list":
      lists[dim] = [str(v) if force_string else flag_utils.get_dim_value(v)
                    for v in str(value).split("+")]
    else:
      slices.setdefault(dim, {})[kind] = (
          str(value) if force_string and kind != "step" else value)
  out = {dim: slice(parts.get("start"), parts.get("stop"),
                    int(parts["step"]) if "step" in parts else None)
         for dim, parts in slices.items()}
  out.update(lists)
  return out


def select_positions(ds: xds.Dataset, args):
  """(skeleton, {dim: positions}): every selection of the flags applied to
  a skeleton of ``ds``'s coordinates and position arrays."""
  skel = xds.Dataset(
      {f"__pos_{d}": xds.Variable((d,), np.arange(n, dtype=np.int64))
       for d, n in ds.sizes.items()},
      coords=dict(ds.coords_dict()))
  # reversals come before any selection; a non-monotonic dim is an error
  for dim in args.make_dims_increasing or []:
    increasing = np.diff(np.asarray(skel[dim].values)) > 0
    if increasing.all():
      continue
    if (~increasing).all():
      skel = skel.isel({dim: slice(None, None, -1)})
    else:
      raise ValueError(
          f"Cannot make non-monotonic dimension {dim} increasing")
  sel = parse_selection_grammar(args.sel)
  sel.update(parse_selection_grammar(args.sel_strings, force_string=True))
  if sel:
    skel = skel.sel(sel)
  isel = parse_selection_grammar(args.isel)
  if isel:
    skel = skel.isel(isel)
  drop_sel = parse_selection_grammar(args.drop_sel)
  drop_sel.update(parse_selection_grammar(args.drop_sel_strings,
                                          force_string=True))
  if drop_sel:
    skel = skel.drop_sel(drop_sel)
  drop_isel = parse_selection_grammar(args.drop_isel)
  if drop_isel:
    skel = skel.drop_isel(drop_isel)
  return skel, {d: np.asarray(skel[f"__pos_{d}"].values, dtype=np.int64)
                for d in ds.sizes}


def _ascending(positions: np.ndarray):
  """(the key that reads ``positions``' distinct values in ascending
  order, a slice where they are a run; the order that puts them back, or
  None where it is the identity)."""
  uniq, inverse = np.unique(positions, return_inverse=True)
  run = uniq.size and uniq[-1] - uniq[0] + 1 == uniq.size
  key = slice(int(uniq[0]), int(uniq[-1]) + 1) if run else uniq
  same = uniq.size == positions.size and np.array_equal(uniq, positions)
  return key, None if same else inverse.ravel()


def main(argv=None):
  """Parse ``argv`` (default: the command line) and write the store;
  returns the run's counts (``_prep.RunCounts``) and its windows."""
  args = build_parser().parse_args(argv)
  dev = device_lib.resolve(args.device)
  counts = _prep.RunCounts(windows=0)
  ds = xds.open_zarr(args.input_path, lazy=True)
  skel, pos = select_positions(ds, args)

  names = list(ds.keys())
  if args.keep_variables is not None:
    names = [n for n in names if n in set(args.keep_variables)]
  if args.drop_variables:
    names = [n for n in names if n not in set(args.drop_variables)]

  out_sizes = {d: len(p) for d, p in pos.items()}
  src_vars = ds.variables_dict()
  template = xds.Dataset(
      {n: xds.stub_variable(src_vars[n].dims, out_sizes, src_vars[n].dtype,
                            src_vars[n].attrs) for n in names},
      coords=dict(skel.coords_dict()), attrs=ds.attrs)
  stream_chunks = {}
  if out_sizes:  # stream over the largest output dim
    big = max(out_sizes, key=lambda d: out_sizes[d])
    stream_chunks[big] = xds.default_block(template[names], big, dev.type)
  with counts.timing("write_s"):
    writer = xds.RegionWriter(args.output_path, template,
                              chunks=dict(args.output_chunks) or
                              stream_chunks)
  for window in xds.iter_windows(out_sizes, stream_chunks):
    for n in names:
      var = src_vars[n]
      plans = [_ascending(pos[d][window.get(d, slice(None))])
               for d in var.dims]
      with counts.timing("read_s"):
        data = xds.orthogonal_select(var.data, [k for k, _ in plans])
      with counts.timing("device_s"):
        data = counts.to_device(xds.DataArray(data, dims=var.dims),
                                dev).data
        for ax, (_, order) in enumerate(plans):
          if order is not None:
            data = _xp.take(data, (slice(None),) * ax + (order,))
        data = counts.to_host(xds.DataArray(data, dims=var.dims)).data
      with counts.timing("write_s"):
        writer.write_array(
            n, tuple(window.get(d, slice(None)) for d in var.dims), data)
    counts["windows"] += 1
  writer.finish()
  return counts.result()


if __name__ == "__main__":
  main()

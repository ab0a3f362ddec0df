"""Chunks written straight from the caller's array hold the bytes a staged
chunk gave, on the CPU.

The port's Zarr writer encodes a chunk that a write covers whole, and that
ends inside its array, from the caller's data; it stages only an edge
chunk (padded past the array's end) in a chunk of the fill value, and
reads, modifies and writes a partial one.  Held here to the staged recipe,
recomputed on its own for every chunk file: a chunk of ``fill_value``, the
array's values copied in, then the blosc, zlib or raw encoding.  Stores of
one chunk per variable, stores with edge chunks on every axis, and region
writes into a template that mix partial, interior and edge chunks; in
float32, float64 with NaNs of several payloads, and int64 times; under
zstd3, lz4, none, zlib and a byte-shuffled blosc-zstd dict.
"""
import json
import os
import zlib

import numpy as np
import pytest

from weatherbench2_torch import xds
from weatherbench2_torch.xds import _codec
from weatherbench2_torch.xds import io_zarr

SHAPE = (64, 32)
DIMS = ("x", "y")
EDGE_CHUNKS = {"x": 24, "y": 12}  # 64 = 24 + 24 + 16, 32 = 12 + 12 + 8
COMPRESSORS = {
    "zstd3": "zstd3",
    "lz4": "lz4",
    "none": "none",
    "zlib": "zlib",
    "blosc_byte_shuffle": {"id": "blosc", "cname": "zstd", "clevel": 5,
                           "shuffle": 1},
}
# region writes into the template, in order: (x slice, y slice); on the
# EDGE_CHUNKS grid they cover the interior chunks (0-1, 0-1) whole, the
# edge chunk (2, 0) whole, partial chunks of the last column, a part of a
# written interior chunk again, and the edge chunks (2, 1) and (2, 2) whole
REGIONS = [
    (slice(0, 48), slice(0, 24)),
    (slice(48, 64), slice(0, 12)),
    (slice(5, 30), slice(24, 32)),
    (slice(10, 20), slice(3, 9)),
    (slice(48, 64), slice(12, 32)),
]


def _values(kind, seed):
  """A (64, 32) array of ``kind``: float32, float64 with NaNs of several
  payloads (quiet, signalling-pattern, negative), or datetime64 times."""
  rng = np.random.default_rng(seed)
  if kind == "float32":
    return rng.standard_normal(SHAPE).astype(np.float32)
  if kind == "float64_nan":
    out = rng.standard_normal(SHAPE)
    bits = out.view(np.uint64)
    nans = rng.uniform(size=SHAPE) < 0.2
    payloads = np.array([0x7FF8000000000000, 0x7FF8000000000123,
                         0xFFF8000000000001, 0x7FF0000000000001], np.uint64)
    bits[nans] = payloads[rng.integers(0, len(payloads), nans.sum())]
    return out
  ns = rng.integers(0, 2 * 10**18, SHAPE)
  return ns.astype("datetime64[ns]")


def _encode(comp, staged):
  """The staged chunk encoded as the writer has always encoded it."""
  if comp is None:
    return staged.tobytes()
  if comp["id"] == "zlib":
    enc = zlib.compressobj(comp["level"], zlib.DEFLATED, 15)
    return enc.compress(staged.tobytes()) + enc.flush()
  return _codec.encode(staged, comp["cname"], comp["clevel"],
                       comp["shuffle"], comp["blocksize"], "test").tobytes()


def _staged_bytes(meta, values, idx):
  """Chunk ``idx`` of an array that holds ``values`` (encoded as stored):
  a chunk of the fill value with the array's part of it copied in."""
  fill = meta["fill_value"]
  fill = np.nan if fill == "NaN" else (0 if fill is None else fill)
  chunks = meta["chunks"]
  staged = np.full(chunks, fill, dtype=np.dtype(meta["dtype"]))
  src = tuple(slice(i * c, min((i + 1) * c, n))
              for i, c, n in zip(idx, chunks, values.shape))
  staged[tuple(slice(0, s.stop - s.start) for s in src)] = values[src]
  return _encode(meta["compressor"], staged)


def _assert_chunks(path, name, values, written):
  """Every chunk file of ``name`` is one of ``written`` (chunk indices)
  and holds the staged recipe's bytes of ``values``."""
  with open(os.path.join(path, name, ".zarray")) as f:
    meta = json.load(f)
  files = sorted(f for f in os.listdir(os.path.join(path, name))
                 if not f.startswith("."))
  assert files == sorted(".".join(map(str, i)) for i in written)
  stored = np.asarray(io_zarr.encode_cf(values)[0])
  for idx in written:
    with open(os.path.join(path, name, ".".join(map(str, idx))), "rb") as f:
      got = f.read()
    assert got == _staged_bytes(meta, stored, idx), (name, idx)


def _grid(shape, chunks):
  return [tuple(int(i) for i in idx) for idx in
          np.ndindex(*[-(-n // c) for n, c in zip(shape, chunks)])]


@pytest.mark.parametrize("compressor", sorted(COMPRESSORS))
@pytest.mark.parametrize("kind", ["float32", "float64_nan", "datetime64"])
@pytest.mark.parametrize("layout", ["one_chunk", "edge_chunks", "region"])
def test_chunks_hold_the_staged_chunks_bytes(tmp_path, layout, kind,
                                              compressor):
  comp = COMPRESSORS[compressor]
  values = _values(kind, seed=7)
  coords = {"x": np.arange(SHAPE[0]) * 1.5, "y": np.linspace(-90, 90,
                                                             SHAPE[1])}
  path = str(tmp_path / "s.zarr")
  chunks = None if layout == "one_chunk" else EDGE_CHUNKS
  if layout != "region":
    ds = xds.Dataset({"v": xds.Variable(DIMS, values)}, coords=coords)
    xds.to_zarr(ds, path, chunks=chunks, compressor=comp)
    grid = SHAPE if chunks is None else [chunks[d] for d in DIMS]
    _assert_chunks(path, "v", values, _grid(SHAPE, grid))
  else:
    template = xds.Dataset({"v": xds.Variable(DIMS, np.zeros(SHAPE,
                                                             values.dtype))},
                           coords=coords)
    writer = xds.RegionWriter(path, template, chunks=chunks,
                              compressor=comp)
    fill = np.nan if values.dtype.kind == "f" else 0
    expected = np.full(SHAPE, fill, io_zarr.encode_cf(values)[0].dtype)
    touched = set()
    for xs, ys in REGIONS:
      writer.write(xds.Dataset({"v": xds.Variable(DIMS, values[xs, ys])}),
                   {"x": xs, "y": ys})
      expected[xs, ys] = io_zarr.encode_cf(values[xs, ys])[0]
      cx, cy = (EDGE_CHUNKS[d] for d in DIMS)
      touched |= {(i, j)
                  for i in range(xs.start // cx, -(-xs.stop // cx))
                  for j in range(ys.start // cy, -(-ys.stop // cy))}
    _assert_chunks(path, "v", expected, sorted(touched))
  for name, coord in coords.items():
    n = len(coord)
    _assert_chunks(path, name, coord,
                   _grid((n,), (n if chunks is None or layout == "region"
                                else chunks[name],)))

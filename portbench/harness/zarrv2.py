"""A minimal Zarr v2 directory store: the benchmark's own writer and reader.

The writer lays stores out as xarray and zarr-python do (``.zgroup``,
``.zattrs`` with ``_ARRAY_DIMENSIONS``, ``.zarray``, one file per chunk,
consolidated ``.zmetadata``; CF-encoded times), uncompressed or as blosc
chunks from the benchmark's frozen codec (``harness/codec.py``).  The
reader opens the results stores the program writes, for the comparison.
Neither touches the program's Zarr layer.
"""
from __future__ import annotations

import json
import os
import zlib

import numpy as np

from harness import codec

# zarr-python's default compressor: blosc lz4, clevel 5, byte shuffle
ZARR_DEFAULT = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
                "blocksize": 0}


def _write_json(path: str, obj) -> None:
  with open(path, "w") as f:
    json.dump(obj, f, indent=2)


class StoreWriter:
  """Writes one group: coordinates whole, data arrays chunk by chunk.

  ``compressor`` is None (raw chunks) or a blosc dict with cname lz4 or
  zstd; ``threads`` encode the blocks of a chunk.
  """

  def __init__(self, path: str, compressor=None, threads: int = 8):
    self.path = path
    self.compressor = compressor
    self.threads = threads
    self.meta: dict = {".zgroup": {"zarr_format": 2}, ".zattrs": {}}
    self.arrays: dict = {}
    self.bytes_written = 0
    os.makedirs(path, exist_ok=True)
    _write_json(os.path.join(path, ".zgroup"), {"zarr_format": 2})

  def create(self, name, dims, shape, chunks, dtype="<f4", attrs=None,
             fill_value=None):
    """Declare an array; its chunks are written by ``write_chunk``."""
    dtype = np.dtype(dtype).newbyteorder("<")
    zarray = {"shape": list(shape), "chunks": list(chunks),
              "dtype": dtype.str, "compressor": self.compressor,
              "fill_value": fill_value, "filters": None, "order": "C",
              "zarr_format": 2, "dimension_separator": "."}
    zattrs = {"_ARRAY_DIMENSIONS": list(dims), **(attrs or {})}
    os.makedirs(os.path.join(self.path, name), exist_ok=True)
    _write_json(os.path.join(self.path, name, ".zarray"), zarray)
    _write_json(os.path.join(self.path, name, ".zattrs"), zattrs)
    self.meta[f"{name}/.zarray"] = zarray
    self.meta[f"{name}/.zattrs"] = zattrs
    self.arrays[name] = (tuple(shape), tuple(chunks), dtype)

  def write_chunk(self, name, index, data: np.ndarray) -> None:
    """Write chunk ``index`` (a tuple of chunk positions) of ``name``;
    ``data`` has the chunk's full shape (zarr v2 pads edge chunks)."""
    shape, chunks, dtype = self.arrays[name]
    if data.shape != chunks:
      raise ValueError(f"{name} chunk {index}: shape {data.shape}, "
                       f"expected {chunks}")
    data = np.ascontiguousarray(data, dtype=dtype)
    if self.compressor is None:
      raw = data.tobytes()
    else:
      raw = codec.encode(data, self.compressor["cname"],
                         self.compressor["clevel"],
                         self.compressor["shuffle"], self.threads,
                         f"{self.path}/{name} chunk {index}")
    key = ".".join(str(i) for i in index) if index else "0"
    with open(os.path.join(self.path, name, key), "wb") as f:
      f.write(raw)
    self.bytes_written += len(raw)

  def coord(self, name, values, attrs=None) -> None:
    """A one-dimensional coordinate, written whole as one chunk."""
    values = np.asarray(values)
    self.create(name, (name,), values.shape, values.shape, values.dtype,
                attrs)
    self.write_chunk(name, (0,), values)

  def finish(self) -> None:
    _write_json(os.path.join(self.path, ".zattrs"), {})
    _write_json(os.path.join(self.path, ".zmetadata"),
                {"metadata": self.meta, "zarr_consolidated_format": 1})


def read_array(store: str, name: str):
  """(values, dims, attrs) of one array of a Zarr v2 store, whole.  Chunks
  may be raw, zlib, gzip or blosc; absent chunks read as the fill value."""
  base = os.path.join(store, name)
  with open(os.path.join(base, ".zarray")) as f:
    meta = json.load(f)
  with open(os.path.join(base, ".zattrs")) as f:
    attrs = json.load(f)
  dims = tuple(attrs.pop("_ARRAY_DIMENSIONS"))
  if meta.get("filters") or meta.get("order", "C") != "C":
    raise ValueError(f"{base}: filters or Fortran order")
  dtype = np.dtype(meta["dtype"])
  shape = tuple(meta["shape"])
  chunks = tuple(meta["chunks"]) if shape else ()
  fill = meta.get("fill_value")
  fill = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}.get(
      fill, fill)
  out = np.full(shape, 0 if fill is None else fill, dtype)
  sep = meta.get("dimension_separator", ".")
  comp = meta.get("compressor")
  grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
  for index in np.ndindex(*[len(g) for g in grid]) if shape else [()]:
    path = os.path.join(base, sep.join(map(str, index)) if index else "0")
    if not os.path.exists(path):
      continue
    with open(path, "rb") as f:
      raw = f.read()
    chunk = np.empty(chunks, dtype)
    if comp is None:
      chunk.reshape(-1).view(np.uint8)[...] = np.frombuffer(raw, np.uint8)
    elif comp["id"] == "blosc":
      codec.decode_into(raw, chunk, path)
    elif comp["id"] in ("zlib", "gzip"):
      data = zlib.decompress(raw, 31 if comp["id"] == "gzip" else 15)
      chunk.reshape(-1).view(np.uint8)[...] = np.frombuffer(data, np.uint8)
    else:
      raise ValueError(f"{path}: compressor {comp}")
    box = tuple(slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(index, chunks, shape))
    out[box] = chunk[tuple(slice(0, b.stop - b.start) for b in box)]
  return out, dims, attrs


def read_group(store: str) -> dict:
  """{name: (values, dims, attrs)} of every array of a store, with the
  string arrays that some writers keep in the group attrs
  (``_xds_string_arrays``) as object arrays."""
  out = {}
  for name in sorted(os.listdir(store)):
    if os.path.exists(os.path.join(store, name, ".zarray")):
      out[name] = read_array(store, name)
  zattrs = os.path.join(store, ".zattrs")
  if os.path.exists(zattrs):
    with open(zattrs) as f:
      group = json.load(f)
    for name, spec in group.get("_xds_string_arrays", {}).items():
      out[name] = (np.asarray(spec["values"], dtype=object),
                   tuple(spec["dims"]), {})
  return out

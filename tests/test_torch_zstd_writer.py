"""The port's zstd writer and its block-range reads against tensorstore, on
the CPU.

The port writes the JAX package's default layout (bit-shuffled blosc-zstd
at clevel 3, ``WB2_ZARR_COMPRESSOR`` unset) through its own encoder
(``weatherbench2_torch/csrc/codecs.cpp``).  Held here to the JAX package
(tensorstore, c-blosc, libzstd): stores at every blosc clevel 1-9 and
shuffle 0-2 open there bit for bit; every chunk's blosc header equals
tensorstore's but for the memcpyed bit and cbytes; file bytes within 1.10x
of tensorstore's at clevel 1-5 and 1.20x at 6-9, per variable; the
``.zarray`` of each compressor name and of the environment variable; region
writes into a store the JAX package made; all-equal, incompressible and
empty chunks.  Partial reads of blosc chunks (every cname and shuffle, in
chunks of several blocks) decode exactly the blocks that hold the rows and
give the whole decode's bits; a chunk stored raw reads only the rows.
"""
import json
import os
import shutil
import struct

import numpy as np
import pytest

from tests.test_torch_blosc import (BLOCKS_SHAPE, CHUNKS, CNAMES,
                                    DATA_VARS, FIXTURE_CHUNKS, FIXTURE_SHAPE,
                                    FIXTURES, MEMCPYED, SHUFFLES, arrays,
                                    assert_bitwise, blosc, fields,
                                    jax_dataset, port_dataset)
from weatherbench2_tpu import xds as jxds
from weatherbench2_torch import convert
from weatherbench2_torch import tracing
from weatherbench2_torch import xds
from weatherbench2_torch.xds import _codec
from weatherbench2_torch.xds import io_zarr

CLEVELS = range(1, 10)
# file bytes over tensorstore's, per variable: zstd's lazy levels, then its
# optimal parsers (c-blosc's clevels 6-9 on small chunks)
RATIO_BOUND = {clevel: 1.10 if clevel <= 5 else 1.20 for clevel in CLEVELS}
ZSTD3 = {"id": "blosc", "cname": "zstd", "clevel": 3, "shuffle": 2,
         "blocksize": 0}


def chunk_files(path):
  """{(array, key): file path} of every chunk of every array."""
  out = {}
  for name in sorted(os.listdir(path)):
    d = os.path.join(path, name)
    if os.path.isdir(d):
      for key in sorted(os.listdir(d)):
        if not key.startswith("."):
          out[(name, key)] = os.path.join(d, key)
  return out


def headers(path):
  """Each chunk's blosc header but for the memcpyed bit and cbytes."""
  out = {}
  for k, f in chunk_files(path).items():
    with open(f, "rb") as fh:
      h = _codec.blosc_header(fh.read(16))
    h["flags"] &= ~MEMCPYED
    del h["cbytes"]
    out[k] = h
  return out


def file_bytes(path, names=DATA_VARS):
  return {n: sum(os.path.getsize(f) for (a, _), f in chunk_files(path).items()
                 if a == n) for n in names}


def zarray(path, name):
  with open(os.path.join(path, name, ".zarray")) as f:
    return json.load(f)


# -- the writer against tensorstore -------------------------------------------


@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("clevel", CLEVELS)
def test_port_zstd_store_matches_tensorstore(tmp_path, clevel, shuffle):
  """The fixtures' data (five dtypes, ragged edge chunks, a coordinate chunk
  under 128 bytes) written by both: the JAX package reads the port's store
  bit for bit, every header equals tensorstore's, the bytes stay within the
  bound."""
  comp = blosc("zstd", shuffle, clevel=clevel)
  port, jax = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
  xds.to_zarr(port_dataset(FIXTURE_SHAPE, seed=1), port,
              chunks=FIXTURE_CHUNKS, compressor=comp)
  jxds.to_zarr(jax_dataset(FIXTURE_SHAPE, seed=1), jax,
               chunks=FIXTURE_CHUNKS, compressor=comp)
  read = jxds.open_zarr(port)
  assert_bitwise(read, jxds.open_zarr(jax))
  for name, values in fields(FIXTURE_SHAPE, seed=1).items():
    assert np.asarray(read[name].values).tobytes() == values.tobytes(), name
  assert headers(port) == headers(jax)
  with open(chunk_files(port)[("time", "0")], "rb") as f:
    assert _codec.blosc_header(f.read(16))["flags"] & MEMCPYED  # 48 bytes
  ours, theirs = file_bytes(port), file_bytes(jax)
  for name in DATA_VARS:
    assert ours[name] <= RATIO_BOUND[clevel] * theirs[name], (
        name, ours[name], theirs[name])


@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("compressor", ["zstd3", "blocksize4096"])
def test_several_blocks_and_a_leftover_match_tensorstore(tmp_path, shuffle,
                                                         compressor):
  """One chunk an array of up to 650 KB: c-blosc's default 128 KiB blocks
  at clevel 3, or a forced 4096, each with a leftover block."""
  comp = (dict(ZSTD3, shuffle=shuffle) if compressor == "zstd3"
          else blosc("zstd", shuffle, clevel=5, blocksize=4096))
  port, jax = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
  xds.to_zarr(port_dataset(BLOCKS_SHAPE), port, compressor=comp)
  jxds.to_zarr(jax_dataset(BLOCKS_SHAPE), jax, compressor=comp)
  assert_bitwise(jxds.open_zarr(port), jxds.open_zarr(jax))
  assert headers(port) == headers(jax)
  h = headers(port)[("wide", "0.0.0")]
  assert h["nbytes"] > h["blocksize"] and h["nbytes"] % h["blocksize"], h
  ours, theirs = file_bytes(port), file_bytes(jax)
  for name in DATA_VARS:
    assert ours[name] <= 1.10 * theirs[name], (name, ours, theirs)


def test_default_layout_header_of_a_large_float32_chunk(tmp_path,
                                                        monkeypatch):
  """A 0.25-degree float32 field (4 152 960 bytes) at the default: flags
  0x94 (zstd, do not split, bit shuffle), blocksize 131 072, as the JAX
  package writes it."""
  monkeypatch.delenv("WB2_ZARR_COMPRESSOR", raising=False)
  gen = np.random.default_rng(3)
  field = np.cumsum(gen.standard_normal((1440, 721)), axis=1).astype(
      np.float32)
  dims = ("longitude", "latitude")
  port, jax = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
  xds.to_zarr(convert.dataset_from_arrays({"z": (dims, field)}, coords={}), port)
  jxds.to_zarr(jxds.Dataset({"z": jxds.Variable(dims, field)}), jax)
  assert headers(port) == headers(jax)
  with open(chunk_files(port)[("z", "0.0")], "rb") as f:
    h = _codec.blosc_header(f.read(16))
  assert (h["version"], h["versionlz"], h["flags"], h["typesize"],
          h["nbytes"], h["blocksize"]) == (2, 1, 0x94, 4, 4152960, 131072)
  assert np.asarray(jxds.open_zarr(port)["z"].values).tobytes() == (
      field.tobytes())
  ours, theirs = file_bytes(port, ["z"]), file_bytes(jax, ["z"])
  assert ours["z"] <= 1.10 * theirs["z"], (ours, theirs)


# -- the compressor names ------------------------------------------------------


@pytest.mark.parametrize("env", [None, "zstd3", "lz4", "none"])
@pytest.mark.parametrize("compressor", ["default", "zstd3", "lz4", "none"])
def test_zarray_is_the_jax_packages(tmp_path, monkeypatch, env, compressor):
  """Every array's .zarray as the JAX package writes it, for each name and
  for WB2_ZARR_COMPRESSOR set to each or unset (it decides "default")."""
  if env is None:
    monkeypatch.delenv("WB2_ZARR_COMPRESSOR", raising=False)
  else:
    monkeypatch.setenv("WB2_ZARR_COMPRESSOR", env)
  port, jax = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
  xds.to_zarr(port_dataset(), port, chunks=CHUNKS, compressor=compressor)
  jxds.to_zarr(jax_dataset(), jax, chunks=CHUNKS, compressor=compressor)
  for name in DATA_VARS + ("time", "longitude", "latitude"):
    assert zarray(port, name) == zarray(jax, name), name
  assert_bitwise(jxds.open_zarr(port), jxds.open_zarr(jax))
  resolved = (env or "zstd3") if compressor == "default" else compressor
  want = {"zstd3": ZSTD3, "lz4": dict(io_zarr._COMPRESSORS["lz4"],
                                      blocksize=0), "none": None}[resolved]
  assert zarray(port, "smooth")["compressor"] == want


def test_default_is_bit_shuffled_zstd3_as_the_jax_package(tmp_path,
                                                         monkeypatch):
  """With WB2_ZARR_COMPRESSOR unset, to_zarr, create_zarr_template and
  RegionWriter write {"cname": "zstd", "clevel": 3, "shuffle": 2}."""
  monkeypatch.delenv("WB2_ZARR_COMPRESSOR", raising=False)
  ds = port_dataset()
  xds.to_zarr(ds, str(tmp_path / "a.zarr"))
  xds.create_zarr_template(ds, str(tmp_path / "b.zarr"))
  xds.RegionWriter(str(tmp_path / "c.zarr"), ds)
  for store in "abc":
    assert zarray(str(tmp_path / f"{store}.zarr"), "wide")["compressor"] == (
        ZSTD3)
  assert io_zarr.default_compressor() == jxds.io_zarr.default_compressor()


@pytest.mark.parametrize("how", ["env", "argument"])
def test_unknown_compressor_name_raises_as_the_jax_package(tmp_path,
                                                           monkeypatch, how):
  if how == "env":
    monkeypatch.setenv("WB2_ZARR_COMPRESSOR", "zstd9")
    kwargs = {}
  else:
    kwargs = {"compressor": "zstd9"}
  errors = []
  for writer, ds in ((xds.to_zarr, port_dataset()),
                     (jxds.to_zarr, jax_dataset())):
    with pytest.raises(ValueError) as err:
      writer(ds, str(tmp_path / f"{len(errors)}.zarr"), **kwargs)
    errors.append(str(err.value))
  assert errors[0] == errors[1]
  assert "options: ['lz4', 'none', 'zstd3']" in errors[0]


# -- region writes ---------------------------------------------------------------


@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_region_write_into_a_jax_zstd_store(tmp_path, shuffle):
  """The JAX package's template (zstd, each shuffle) written in regions
  across chunk edges by the port and, in a copy, by tensorstore: the same
  values, headers and (within 1.10x) bytes."""
  ds = jax_dataset()
  template = jxds.Dataset(
      {"wide": jxds.Variable(ds["wide"].dims,
                             np.zeros(ds["wide"].shape, np.float64))},
      coords=dict(ds.coords_dict()))
  base = str(tmp_path / "template.zarr")
  jxds.create_zarr_template(template, base, chunks=CHUNKS,
                            compressor=blosc("zstd", shuffle, clevel=3))
  port, jax = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
  shutil.copytree(base, port)
  shutil.copytree(base, jax)
  values = fields()["wide"]
  for lo, hi in ((0, 3), (3, 7), (7, 10)):
    xds.write_zarr_region(port, "wide", (slice(lo, hi),), values[lo:hi])
    jxds.write_zarr_region(jax, "wide", (slice(lo, hi),),
                           values[lo:hi]).result()
  got = np.asarray(jxds.open_zarr(port)["wide"].values)
  assert got.tobytes() == np.asarray(
      jxds.open_zarr(jax)["wide"].values).tobytes() == values.tobytes()
  assert headers(port) == headers(jax)
  ours, theirs = file_bytes(port, ["wide"]), file_bytes(jax, ["wide"])
  assert ours["wide"] <= 1.10 * theirs["wide"], (ours, theirs)


# -- chunks at the edges of the format ----------------------------------------


def _store_of(tmp_path, values, compressor=ZSTD3):
  path = str(tmp_path / "edge.zarr")
  xds.to_zarr(convert.dataset_from_arrays({"v": (("x",), values)}, coords={}),
              path, compressor=compressor)
  return path


@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_all_equal_chunk(tmp_path, shuffle):
  """A constant chunk of 400 000 bytes in four blocks (RLE blocks, or one
  long match), a few bytes each as tensorstore's, read back by the JAX
  package."""
  values = np.full(100_000, 271.5, np.float32)
  comp = dict(ZSTD3, shuffle=shuffle)
  path = _store_of(tmp_path, values, comp)
  jax = str(tmp_path / "jax.zarr")
  jxds.to_zarr(jxds.Dataset({"v": jxds.Variable(("x",), values)}), jax,
               compressor=comp)
  ours, theirs = file_bytes(path, ["v"])["v"], file_bytes(jax, ["v"])["v"]
  assert ours <= max(1.10 * theirs, 256), (ours, theirs)
  assert headers(path) == headers(jax)
  assert np.asarray(jxds.open_zarr(path)["v"].values).tobytes() == (
      values.tobytes())


def test_incompressible_chunk_is_stored_raw(tmp_path):
  values = np.random.default_rng(5).integers(0, 256, 50_000, np.uint8)
  path = _store_of(tmp_path, values)
  with open(chunk_files(path)[("v", "0")], "rb") as f:
    raw = f.read()
  h = _codec.blosc_header(raw)
  assert h["flags"] & MEMCPYED and len(raw) == 16 + values.nbytes
  assert np.asarray(jxds.open_zarr(path)["v"].values).tobytes() == (
      values.tobytes())
  assert np.asarray(xds.open_zarr(path)["v"].values).tobytes() == (
      values.tobytes())


def test_empty_chunks(tmp_path):
  """Zero bytes through the codec (a 16-byte header) and an array with no
  elements through the writer, as the JAX package reads it."""
  for dtype in (np.float32, np.int64):
    raw = _codec.encode(np.zeros(0, dtype), "zstd", 3, 2, 0, "empty")
    assert len(raw) == 16 and _codec.blosc_header(raw.tobytes())["nbytes"] == 0
    _codec.decode_into(raw.tobytes(), np.zeros(0, dtype), "empty")
  path = _store_of(tmp_path, np.zeros(0, np.float32))
  assert np.asarray(jxds.open_zarr(path)["v"].values).shape == (0,)
  assert np.asarray(xds.open_zarr(path)["v"].values).shape == (0,)


@pytest.mark.parametrize("clevel", [1, 3, 9])
def test_codec_round_trip_of_awkward_sizes(clevel):
  """Sizes around c-blosc's and zstd's edges (127-129 bytes, one block and
  a byte, a count of elements no multiple of 8): the port's decoder gives
  back the bytes."""
  gen = np.random.default_rng(clevel)
  for n in (1, 31, 32, 33, 127, 128, 129, 1023, 1024, 1025, 131_073,
            262_145):
    data = np.round(np.cumsum(gen.standard_normal(n)) * 4).astype(np.int32)
    for shuffle in SHUFFLES:
      raw = _codec.encode(data, "zstd", clevel, shuffle, 0, "awkward")
      back = np.empty_like(data)
      _codec.decode_into(raw.tobytes(), back, "awkward")
      assert back.tobytes() == data.tobytes(), (n, shuffle)


def test_encode_failure_names_the_store_and_chunk(tmp_path, monkeypatch):
  """A chunk that fails to encode raises naming store, array and chunk."""
  path = str(tmp_path / "x.zarr")

  def failing(lib, err, where):
    raise ValueError(f"{where}: corrupt zstd stream (code 10)")

  monkeypatch.setattr(_codec, "_check", failing)
  with pytest.raises(ValueError) as err:
    xds.to_zarr(port_dataset(), path, chunks=CHUNKS)
  msg = str(err.value)
  assert path in msg and "chunk" in msg, msg


# -- A.15: partial reads decode only the blocks of their rows -----------------


def touched_blocks_bytes(nbytes, blocksize, rows, row_bytes):
  """Decoded bytes of the blocks that rows ``rows`` of ``row_bytes`` touch."""
  blocks = set()
  for r in rows:
    blocks.update(range(r * row_bytes // blocksize,
                        ((r + 1) * row_bytes - 1) // blocksize + 1))
  return sum(min(blocksize, nbytes - b * blocksize) for b in blocks)


@pytest.fixture(scope="module")
def block_stores(tmp_path_factory):
  """Tensorstore stores of every cname and shuffle in chunks of several
  blocks (BLOCKS_SHAPE in one chunk, a forced 4096 that the splitting
  codecs raise to 64 KiB), and one chunk stored raw (clevel 0)."""
  tmp = tmp_path_factory.mktemp("blocks")
  paths = {}
  for cname in CNAMES:
    for shuffle in SHUFFLES:
      paths[(cname, shuffle)] = str(tmp / f"{cname}{shuffle}.zarr")
      jxds.to_zarr(jax_dataset(BLOCKS_SHAPE), paths[(cname, shuffle)],
                   compressor=blosc(cname, shuffle, blocksize=4096))
  paths["raw"] = str(tmp / "raw.zarr")
  jxds.to_zarr(jax_dataset(BLOCKS_SHAPE), paths["raw"],
               compressor=blosc("zstd", 2, clevel=0))
  return paths


@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("cname", CNAMES)
def test_partial_read_decodes_only_the_blocks_of_its_rows(block_stores,
                                                          cname, shuffle):
  path = block_stores[(cname, shuffle)]
  want = arrays(jxds.open_zarr(path))
  lazy = xds.open_zarr(path, lazy=True)
  blocks_seen = 0
  for name in ("wide", "smooth", "count"):
    with open(chunk_files(path)[(name, "0.0.0")], "rb") as f:
      h = _codec.blosc_header(f.read(16))
    assert not h["flags"] & MEMCPYED and h["nbytes"] > 2 * h["blocksize"]
    row_bytes = h["nbytes"] // BLOCKS_SHAPE[0]
    for rows in ([0], [3, 4], [17, 40, 41], [BLOCKS_SHAPE[0] - 1]):
      io_zarr.DECODES.reset()
      got = np.asarray(lazy[name].data[np.array(rows)])
      assert got.tobytes() == want[name][rows].tobytes(), (name, rows)
      decoded = touched_blocks_bytes(h["nbytes"], h["blocksize"], rows,
                                     row_bytes)
      assert io_zarr.DECODES.bytes == decoded < h["nbytes"], (name, rows)
      blocks_seen += 1
  # a slice of the middle of the time axis, as a chunked stream reads it
  io_zarr.DECODES.reset()
  got = np.asarray(lazy["wide"].data[20:31])
  assert got.tobytes() == want["wide"][20:31].tobytes()
  assert 0 < io_zarr.DECODES.bytes < want["wide"].nbytes
  assert blocks_seen == 12


@pytest.mark.parametrize("cname", CNAMES)
def test_partial_read_of_the_committed_fixtures(cname):
  """The committed fixtures (one block a chunk): a row selection decodes
  each chunk's one block and equals the JAX package's read."""
  for shuffle in SHUFFLES:
    path = os.path.join(FIXTURES, f"{cname}_shuffle{shuffle}.zarr")
    want = arrays(jxds.open_zarr(path))
    lazy = xds.open_zarr(path, lazy=True)
    for name in DATA_VARS:
      io_zarr.DECODES.reset()
      got = np.asarray(lazy[name].data[np.array([1, 5])])
      assert got.tobytes() == want[name][[1, 5]].tobytes(), (path, name)
      # rows 1 and 5 lie in time chunks 0 and 1, each of two longitude
      # chunks: four chunks, one block each
      files = chunk_files(path)
      stored_raw = sum(
          bool(_codec.blosc_header(open(f, "rb").read(16))["flags"]
               & MEMCPYED) for (a, _), f in files.items() if a == name)
      if not stored_raw:
        itemsize = want[name].dtype.itemsize
        per_chunk = 4 * 16 * FIXTURE_SHAPE[2] * itemsize
        assert io_zarr.DECODES.bytes == 4 * per_chunk, (path, name)


def test_partial_read_of_a_raw_chunk_reads_only_its_rows(block_stores):
  path = block_stores["raw"]
  f = chunk_files(path)[("wide", "0.0.0")]
  with open(f, "rb") as fh:
    h = _codec.blosc_header(fh.read(16))
  assert h["flags"] & MEMCPYED
  row_bytes = h["nbytes"] // BLOCKS_SHAPE[0]
  assert row_bytes >= io_zarr.MIN_PARTIAL_READ_BYTES
  want = np.asarray(jxds.open_zarr(path)["wide"].values)
  lazy = xds.open_zarr(path, lazy=True)["wide"].data
  for rows in ([2], [5, 6, 7], [9, 30]):
    io_zarr.READS.reset()
    io_zarr.DECODES.reset()
    got = np.asarray(lazy[np.array(rows)])
    assert got.tobytes() == want[rows].tobytes()
    assert io_zarr.READS.bytes == 16 + len(rows) * row_bytes
    assert io_zarr.DECODES.bytes == 0


@pytest.mark.parametrize("store", ["raw", ("zstd", 2)])
def test_partial_reads_time_reads_and_decodes_apart(block_stores, store):
  """Of a chunk stored raw only the rows' reads are timed and nothing is
  decoded; of a compressed one the file's read and its blocks' decoding
  are each timed."""
  lazy = xds.open_zarr(block_stores[store], lazy=True)["wide"].data
  io_zarr.READS.reset()
  io_zarr.DECODES.reset()
  with io_zarr.tally(tracing.Counts()) as mine:
    np.asarray(lazy[np.array([5, 6, 7])])
  assert io_zarr.READS.bytes > 0 and io_zarr.READS.seconds > 0
  assert (mine["read_bytes"], mine["read_s"]) == (io_zarr.READS.bytes,
                                                  io_zarr.READS.seconds)
  if store == "raw":
    assert (io_zarr.DECODES.bytes, io_zarr.DECODES.seconds) == (0, 0.0)
  else:
    assert io_zarr.DECODES.bytes > 0 and io_zarr.DECODES.seconds > 0


def test_whole_chunk_reads_decode_whole(block_stores):
  path = block_stores[("zstd", 2)]
  want = arrays(jxds.open_zarr(path))
  io_zarr.DECODES.reset()
  got = arrays(xds.open_zarr(path, lazy=True))
  assert got["wide"].tobytes() == want["wide"].tobytes()
  assert io_zarr.DECODES.bytes >= sum(want[n].nbytes for n in DATA_VARS)


def test_decode_blocks_checks_its_range(block_stores):
  path = block_stores[("zstd", 1)]
  with open(chunk_files(path)[("wide", "0.0.0")], "rb") as f:
    raw = f.read()
  h = _codec.blosc_header(raw)
  n_blocks = -(-h["nbytes"] // h["blocksize"])
  whole = np.empty(h["nbytes"], np.uint8)
  _codec.decode_into(raw, whole, "whole")
  last = h["nbytes"] - (n_blocks - 1) * h["blocksize"]
  part = np.empty(h["blocksize"] + last, np.uint8)
  _codec.decode_blocks_into(raw, n_blocks - 2, n_blocks - 1, part, "tail")
  assert part.tobytes() == whole[(n_blocks - 2) * h["blocksize"]:].tobytes()
  for first, last_block, size in ((0, n_blocks, 1), (2, 1, 1),
                                  (0, 0, h["blocksize"] + 1)):
    with pytest.raises(ValueError, match="bad argument"):
      _codec.decode_blocks_into(raw, first, last_block,
                                np.empty(size, np.uint8), "range")
  forged = bytearray(raw)
  start = struct.unpack_from("<i", forged, 16 + 4)[0]
  struct.pack_into("<i", forged, start, len(forged))  # block 1's stream
  with pytest.raises(ValueError, match="forged"):
    _codec.decode_blocks_into(bytes(forged), 1, 1,
                              np.empty(h["blocksize"], np.uint8), "forged")

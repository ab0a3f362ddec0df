"""The port's blosc codec (``weatherbench2_torch/csrc/codecs.cpp``) against
tensorstore's, on the CPU.

Stores written by the JAX package (tensorstore, c-blosc) open in the port
bit for bit against ``weatherbench2_tpu.xds.open_zarr``'s read, eager and
lazy: every cname (blosclz, lz4, lz4hc, snappy, zlib, zstd) with every
shuffle (none, byte, bit); typesize 1, 2, 4 and 8 (bool, int16, float32,
float64 with NaN and constant regions, int64); ragged edge chunks; a chunk
under 128 bytes (stored raw, "memcpyed"); several blosc blocks with a
leftover; zstd at blosc clevel 1, 3, 5 and 9 (zstd levels 1, 5, 9 and 22,
blosc's mapping).  The data is smooth fields plus rounded noise, and every
chunk but the tiny one is shown to have reached its codec (flag 0x02 clear,
fewer bytes than decoded).  The port's writer (blosc-lz4 at each shuffle,
the JAX package's "lz4", zstd, zlib) opens in the JAX package bit for bit,
also in regions of a JAX-made zstd store; the codecs it has no encoder for
are refused naming ROADMAP A.18; corrupt, truncated and forged chunks raise
naming store, array and chunk;
the port's evaluate CLI gives the same bits on the JAX package's default
(zstd3) stores as on uncompressed ones; the committed fixtures of
``weatherbench2_torch/testdata/blosc/`` match their manifest.

``JAX_PLATFORMS=cpu python -m tests.test_torch_blosc`` (from the repository
root) writes those fixtures again.
"""
import hashlib
import json
import os
import shutil
import struct
import sys
import threading

import numpy as np
import pytest

from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import utils as jutils
from weatherbench2_tpu import xds as jxds
from weatherbench2_torch import convert
from weatherbench2_torch import tracing
from weatherbench2_torch import xds
from weatherbench2_torch.xds import _codec
from weatherbench2_torch.xds import io_zarr

CNAMES = io_zarr.BLOSC_CNAMES
SHUFFLES = (0, 1, 2)
MEMCPYED = 0x02
SHAPE = (10, 36, 19)
CHUNKS = {"time": 4, "longitude": 16}  # ragged at both edges
DATA_VARS = ("smooth", "wide", "count", "mask", "ticks")
FIXTURES = os.path.join(os.path.dirname(os.path.dirname(xds.__file__)),
                        "testdata", "blosc")
FIXTURE_SHAPE = (6, 24, 19)
FIXTURE_CHUNKS = {"time": 4, "longitude": 16}


def fields(shape=SHAPE, seed=0) -> dict:
  """Compressible data of typesize 4, 8, 2, 1 and 8: smooth fields plus
  rounded noise; NaN and constant regions in the float64 one."""
  rng = np.random.default_rng(seed)
  t, x, y = np.meshgrid(np.arange(shape[0]),
                        np.linspace(0, 2 * np.pi, shape[1]),
                        np.linspace(-1.5, 1.5, shape[2]), indexing="ij")
  smooth = 250 + 30 * np.sin(x + 0.3 * t) * np.cos(y)
  noise = rng.normal(size=shape)
  # on a grid of 1/2: few distinct values, so that byte matches repeat
  field = np.round((smooth + noise) * 2) / 2
  wide = field.copy()
  wide[:, :5, :4] = np.nan
  wide[:, 10:14, 5:9] = 1.5
  # valid times of (time, longitude) cells, the same along latitude
  hours = (t * shape[1] + np.arange(shape[1])[:, None]).astype(np.int64)
  return {
      "smooth": field.astype(np.float32),
      "wide": wide,
      "count": np.round(smooth / 4 + noise / 8).astype(np.int16),
      "mask": field > 250,
      "ticks": np.int64(1_577_836_800_000_000_000)
               + hours * np.int64(3_600_000_000_000),
  }


def coords(shape=SHAPE) -> dict:
  return {
      "time": np.datetime64("2020-01-01T00", "ns")
              + np.arange(shape[0]) * np.timedelta64(6, "h"),
      "longitude": np.linspace(0, 350, shape[1]),
      "latitude": np.linspace(-90, 90, shape[2]),
  }


def jax_dataset(shape=SHAPE, seed=0):
  dims = ("time", "longitude", "latitude")
  return jxds.Dataset(
      {k: jxds.Variable(dims, v) for k, v in fields(shape, seed).items()},
      coords={k: jxds.Variable((k,), v) for k, v in coords(shape).items()})


def port_dataset(shape=SHAPE, seed=0):
  dims = ("time", "longitude", "latitude")
  return convert.dataset_from_arrays(
      {k: (dims, v) for k, v in fields(shape, seed).items()},
      coords=coords(shape))


def blosc(cname, shuffle, clevel=5, blocksize=0) -> dict:
  return {"id": "blosc", "cname": cname, "clevel": clevel,
          "shuffle": shuffle, "blocksize": blocksize}


def chunk_file(path, name, key=None) -> str:
  meta = json.load(open(os.path.join(path, name, ".zarray")))
  if key is None:
    key = meta.get("dimension_separator", ".").join(
        "0" for _ in meta["shape"]) or "0"
  return os.path.join(path, name, key)


def blosc_header(path, name, key=None) -> dict:
  with open(chunk_file(path, name, key), "rb") as f:
    raw = f.read(16)
  keys = ("version", "versionlz", "flags", "typesize", "nbytes", "blocksize",
          "cbytes")
  return dict(zip(keys, struct.unpack("<BBBBiii", raw)))


def arrays(ds) -> dict:
  names = list(ds.keys()) + list(ds.coords_dict())
  return {n: np.asarray(ds[n].values) for n in names}


def assert_bitwise(got, want):
  got, want = arrays(got), arrays(want)
  assert sorted(got) == sorted(want)
  for name, w in want.items():
    g = got[name]
    assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype)
    if w.dtype == object:  # labels
      assert g.tolist() == w.tolist(), name
    else:
      assert g.tobytes() == w.tobytes(), name


def assert_codec_ran(path, names=DATA_VARS):
  """Each array's first chunk went through its codec: not stored raw, and
  shorter than what it decodes to."""
  for name in names:
    h = blosc_header(path, name)
    assert not h["flags"] & MEMCPYED, (path, name, h)
    assert h["cbytes"] < h["nbytes"], (path, name, h)


def compressed_vars(cname):
  """The arrays whose chunks c-blosc compresses at this test's sizes: it
  gives snappy a stream only with room for snappy's worst case left, so a
  chunk of one unsplit block (typesize 1 here) is stored raw; the larger
  chunks of test_several_blocks_and_a_leftover_open_in_port reach it."""
  return [n for n in DATA_VARS if cname != "snappy" or n != "mask"]


def sha256(values) -> str:
  return hashlib.sha256(np.ascontiguousarray(values).tobytes()).hexdigest()


# -- tensorstore writes, once for the module ----------------------------------

CASES = {f"{c}_shuffle{s}": (blosc(c, s), SHAPE) for c in CNAMES
         for s in SHUFFLES}
CASES.update({f"zstd_clevel{lv}": (blosc("zstd", 2, clevel=lv), SHAPE)
              for lv in (1, 3, 5, 9)})
# several blocks and a leftover block whose element count is no multiple of
# 8; the splitting codecs enlarge a forced blocksize to 64 KiB (c-blosc), so
# every array's one chunk is larger than that; the bool one leaves snappy
# room for its worst case
BLOCKS_SHAPE = (61, 36, 37)
CASES.update({f"{c}_blocksize4096": (blosc(c, 2, blocksize=4096),
                                     BLOCKS_SHAPE) for c in CNAMES})


@pytest.fixture(scope="module")
def jax_stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("blosc_jax")
  paths = {}
  for case, (comp, shape) in CASES.items():
    paths[case] = str(tmp / f"{case}.zarr")
    chunks = CHUNKS if shape == SHAPE else None
    jxds.to_zarr(jax_dataset(shape), paths[case], chunks=chunks,
                 compressor=comp)
  return paths


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("cname", CNAMES)
@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_jax_blosc_store_opens_in_port(jax_stores, cname, shuffle, lazy):
  path = jax_stores[f"{cname}_shuffle{shuffle}"]
  assert_codec_ran(path, compressed_vars(cname))
  h = blosc_header(path, "wide")
  assert h["flags"] >> 5 == {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2,
                             "zlib": 3, "zstd": 4}[cname]
  assert h["flags"] & 5 == (0, 1, 4)[shuffle]
  assert {blosc_header(path, n)["typesize"] for n in DATA_VARS} == {1, 2, 4, 8}
  assert_bitwise(xds.open_zarr(path, lazy=lazy), jxds.open_zarr(path))


@pytest.mark.parametrize("clevel", [1, 3, 5, 9])
def test_zstd_levels_open_in_port(jax_stores, clevel):
  path = jax_stores[f"zstd_clevel{clevel}"]
  assert_codec_ran(path)
  assert_bitwise(xds.open_zarr(path), jxds.open_zarr(path))


@pytest.mark.parametrize("cname", CNAMES)
def test_several_blocks_and_a_leftover_open_in_port(jax_stores, cname):
  path = jax_stores[f"{cname}_blocksize4096"]
  assert_codec_ran(path)
  h = blosc_header(path, "wide")
  n_blocks = -(-h["nbytes"] // h["blocksize"])
  leftover = h["nbytes"] % h["blocksize"]
  assert n_blocks > 1 and leftover and (leftover // 8) % 8, h
  assert_bitwise(xds.open_zarr(path, lazy=True), jxds.open_zarr(path))


def test_tiny_chunk_is_stored_raw_and_opens(jax_stores):
  path = jax_stores["zstd_shuffle2"]
  h = blosc_header(path, "time")  # 10 int64, under c-blosc's 128 bytes
  assert h["flags"] & MEMCPYED and h["nbytes"] < 128
  assert_bitwise(xds.open_zarr(path), jxds.open_zarr(path))


def test_lazy_selections_of_a_blosc_store(jax_stores):
  """Gathers of a few positions and slices across chunk edges decode the
  chunks they touch and select in numpy."""
  path = jax_stores["lz4_shuffle1"]
  lazy = xds.open_zarr(path, lazy=True)["wide"].values
  eager = np.asarray(jxds.open_zarr(path)["wide"].values)
  for key in [(np.array([0, 5, 9]),), (slice(3, 7), slice(14, 20)),
              (2, np.array([1, 17, 35])), (slice(None), 3, slice(2, 11))]:
    np.testing.assert_array_equal(np.asarray(lazy[key]), eager[key],
                                  err_msg=str(key))


def test_decode_counter_adds_decoded_bytes(jax_stores):
  path = jax_stores["zstd_shuffle2"]
  io_zarr.READS.reset()
  io_zarr.DECODES.reset()
  ds = xds.open_zarr(path)
  decoded = sum(a.nbytes for n, a in arrays(ds).items()
                if n in DATA_VARS + ("latitude", "longitude"))
  stored = sum(os.path.getsize(os.path.join(path, n, f))
               for n in DATA_VARS + ("latitude", "longitude", "time")
               for f in os.listdir(os.path.join(path, n))
               if not f.startswith("."))
  assert io_zarr.READS.bytes == stored
  # the time coordinate is stored raw, yet its chunks decode through blosc;
  # chunks at the edges decode whole
  assert io_zarr.DECODES.bytes >= decoded and io_zarr.DECODES.seconds > 0


@pytest.mark.parametrize("case", ["zstd_shuffle2", "lz4_shuffle1"])
def test_read_counter_times_reads_apart_from_decodes(jax_stores, case):
  """A store read whole: the file reads are timed in ``READS.seconds``, the
  decoding in ``DECODES.seconds``, and this thread's own tally has the
  sums (no other thread read)."""
  path = jax_stores[case]
  io_zarr.READS.reset()
  io_zarr.DECODES.reset()
  with io_zarr.tally(tracing.Counts()) as mine:
    xds.open_zarr(path)
  assert io_zarr.READS.bytes > 0 and io_zarr.READS.seconds > 0
  assert io_zarr.DECODES.bytes > 0 and io_zarr.DECODES.seconds > 0
  assert (mine["read_bytes"], mine["read_s"]) == (io_zarr.READS.bytes,
                                                  io_zarr.READS.seconds)
  assert (mine["decode_bytes"], mine["decode_s"]) == (
      io_zarr.DECODES.bytes, io_zarr.DECODES.seconds)
  io_zarr.READS.reset()
  assert (io_zarr.READS.bytes, io_zarr.READS.seconds) == (0, 0.0)
  assert io_zarr.tallied() is None


def test_threads_decode_in_parallel_and_count_every_chunk(jax_stores):
  """Sixteen threads decode the same chunks at once (ctypes drops the
  GIL); every result is right and the counters lose no update."""
  path = jax_stores["zstd_shuffle1"]
  arr = io_zarr.open_zarr_array(path, "wide")
  want = np.asarray(jxds.open_zarr(path)["wide"].values)
  chunks = [(i, j, 0) for i in range(3) for j in range(3)]
  errors = []

  def work():
    try:
      for _ in range(10):
        for idx in chunks:
          got = arr._read_chunk(idx)
          lo = [i * c for i, c in zip(idx, arr.chunks)]
          hi = [min(a + c, n) for a, c, n in zip(lo, arr.chunks, arr.shape)]
          part = got[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
          if part.tobytes() != want[tuple(map(slice, lo, hi))].tobytes():
            errors.append(idx)
    except Exception as err:  # reported below
      errors.append(err)

  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-5)
  io_zarr.DECODES.reset()
  try:
    threads = [threading.Thread(target=work) for _ in range(16)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=60)
  finally:
    sys.setswitchinterval(old)
  assert not any(t.is_alive() for t in threads)
  assert not errors, errors[:3]
  per_chunk = int(np.prod(arr.chunks)) * 8
  assert io_zarr.DECODES.bytes == 16 * 10 * len(chunks) * per_chunk


# -- the port's writer ---------------------------------------------------------


@pytest.mark.parametrize("compressor", [
    blosc("lz4", 0), blosc("lz4", 1), blosc("lz4", 2), "lz4", "zlib"])
def test_port_store_opens_in_jax(tmp_path, compressor):
  path = str(tmp_path / "port.zarr")
  xds.to_zarr(port_dataset(), path, chunks=CHUNKS, compressor=compressor)
  if compressor != "zlib":
    assert_codec_ran(path)
  jax_read = jxds.open_zarr(path)
  assert_bitwise(xds.open_zarr(path), jax_read)
  for name, values in fields().items():
    assert np.asarray(jax_read[name].values).tobytes() == values.tobytes()


def test_port_lz4_metadata_is_the_jax_packages(tmp_path):
  port, jax = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
  xds.to_zarr(port_dataset(), port, chunks=CHUNKS, compressor="lz4")
  jxds.to_zarr(jax_dataset(), jax, chunks=CHUNKS, compressor="lz4")
  for name in DATA_VARS:
    meta = [json.load(open(os.path.join(p, name, ".zarray")))["compressor"]
            for p in (port, jax)]
    assert meta[0] == meta[1]


def test_region_writes_into_a_blosc_template(tmp_path):
  """A template with blosc-lz4 chunks, written in regions that cross chunk
  edges (read, decode, modify, encode), opens in the JAX package."""
  ds = port_dataset()
  path = str(tmp_path / "tmpl.zarr")
  template = xds.Dataset(
      {"wide": xds.stub_variable(ds["wide"].dims, ds["wide"].sizes,
                                 np.float64)},
      coords=dict(ds.coords_dict()))
  writer = xds.RegionWriter(path, template, chunks=CHUNKS,
                            compressor=blosc("lz4", 1))
  values = fields()["wide"]
  for lo, hi in ((0, 3), (3, 7), (7, 10)):
    writer.write_array("wide", (slice(lo, hi),), values[lo:hi])
  writer.finish()
  assert_codec_ran(path, ["wide"])
  assert np.asarray(jxds.open_zarr(path)["wide"].values).tobytes() == (
      values.tobytes())


@pytest.mark.parametrize("compressor", [
    "zstd3", blosc("zstd", 2, clevel=2), blosc("zstd", 0, clevel=9)])
def test_port_writer_writes_zstd(tmp_path, compressor):
  """The compressors the writer refused before it had a zstd encoder."""
  path = str(tmp_path / "port.zarr")
  xds.to_zarr(port_dataset(), path, chunks=CHUNKS, compressor=compressor)
  assert_codec_ran(path)
  assert_bitwise(xds.open_zarr(path), jxds.open_zarr(path))
  for name, values in fields().items():
    assert np.asarray(jxds.open_zarr(path)[name].values).tobytes() == (
        values.tobytes())


@pytest.mark.parametrize("cname", ["blosclz", "lz4hc", "snappy", "zlib"])
def test_port_writer_refuses_other_blosc_codecs(tmp_path, cname):
  with pytest.raises(ValueError, match="ROADMAP A.18"):
    xds.to_zarr(port_dataset(), str(tmp_path / "x.zarr"),
                compressor=blosc(cname, 1))


def test_region_write_into_a_zstd_store(jax_stores, tmp_path):
  """A region of the JAX package's zstd store written by the port (the
  chunks it crosses decoded, changed and encoded again) opens there."""
  path = str(tmp_path / "zstd.zarr")
  shutil.copytree(jax_stores["zstd_shuffle2"], path)
  want = fields()["wide"].copy()
  want[2:6] += 0.25
  xds.write_zarr_region(path, "wide", (slice(2, 6),), want[2:6])
  assert np.asarray(jxds.open_zarr(path)["wide"].values).tobytes() == (
      want.tobytes())
  assert_codec_ran(path, ["wide"])


def test_region_write_refuses_a_codec_without_an_encoder(jax_stores,
                                                         tmp_path):
  path = str(tmp_path / "snappy.zarr")
  shutil.copytree(jax_stores["snappy_shuffle2"], path)
  with pytest.raises(ValueError, match="ROADMAP A.18") as err:
    xds.write_zarr_region(path, "wide", (slice(0, 1),), fields()["wide"][:1])
  assert "'wide'" in str(err.value)


# -- errors --------------------------------------------------------------------


def _forge(raw: bytearray, how: str) -> bytearray:
  if how == "truncated":
    return raw[:len(raw) // 2]
  if how == "nbytes":
    struct.pack_into("<i", raw, 4, struct.unpack_from("<i", raw, 4)[0] + 8)
  elif how == "cname":  # codec number 6 in bits 5-7
    raw[2] = (raw[2] & 0x1F) | (6 << 5)
  elif how == "stream":  # a split stream's size past the chunk's end
    start = struct.unpack_from("<i", raw, 16)[0]
    struct.pack_into("<i", raw, start, len(raw))
  return raw


@pytest.mark.parametrize("how", ["truncated", "nbytes", "cname", "stream"])
@pytest.mark.parametrize("lazy", [False, True])
def test_corrupt_chunk_raises_naming_store_array_chunk(jax_stores, tmp_path,
                                                       how, lazy):
  path = str(tmp_path / "forged.zarr")
  shutil.copytree(jax_stores["lz4_shuffle1"], path)
  target = chunk_file(path, "wide", "1.1.0")
  with open(target, "rb") as f:
    raw = bytearray(f.read())
  with open(target, "wb") as f:
    f.write(_forge(raw, how))
  with pytest.raises(ValueError) as err:
    np.asarray(xds.open_zarr(path, lazy=lazy)["wide"].values)
  msg = str(err.value)
  assert path in msg and "'wide'" in msg and "'1.1.0'" in msg, msg


@pytest.mark.parametrize("cname", CNAMES)
def test_mangled_chunks_raise_or_decode_in_bounds(jax_stores, cname):
  """Random byte flips and cuts in a chunk (its header's sizes kept
  consistent) give a ValueError or some decoded bytes, never a read or
  write out of bounds: the output buffer is fenced by guard bytes."""
  path = jax_stores[f"{cname}_shuffle1"]
  with open(chunk_file(path, "wide"), "rb") as f:
    good = f.read()
  nbytes = struct.unpack_from("<i", good, 4)[0]
  rng = np.random.default_rng(7)
  guard = 64
  for trial in range(300):
    raw = bytearray(good)
    if trial % 3 == 0:
      raw = raw[:rng.integers(16, len(raw))]
      struct.pack_into("<i", raw, 12, len(raw))
    for _ in range(rng.integers(1, 4)):
      pos = int(rng.integers(16, len(raw))) if len(raw) > 16 else 15
      raw[pos] = int(rng.integers(256))
    buf = np.full(nbytes + 2 * guard, 0xA5, np.uint8)
    out = buf[guard:guard + nbytes]
    try:
      _codec.decode_into(bytes(raw), out, "mangled")
    except ValueError as err:
      assert "mangled" in str(err)
    assert (buf[:guard] == 0xA5).all() and (buf[-guard:] == 0xA5).all()


def test_missing_compiler_raises_naming_it_and_the_store(jax_stores,
                                                         tmp_path,
                                                         monkeypatch):
  monkeypatch.setattr(_codec, "_lib", None)
  monkeypatch.setattr(_codec, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(_codec.shutil, "which", lambda name: None)
  path = jax_stores["zstd_shuffle2"]
  with pytest.raises(RuntimeError, match=r"no C\+\+ compiler") as err:
    xds.open_zarr(path)
  assert path in str(err.value)
  # an uncompressed store needs no codec
  plain = str(tmp_path / "plain.zarr")
  xds.to_zarr(port_dataset(), plain, compressor=None)
  assert_bitwise(xds.open_zarr(plain), jxds.open_zarr(plain))


def test_library_is_built_from_the_source_into_build():
  path = _codec.build()
  assert os.path.dirname(path) == str(_codec.BUILD_DIR)
  assert _codec.BUILD_DIR.parts[-2:] == ("build", "weatherbench2_torch")
  stamp = _codec.BUILD_DIR / "libwb2codecs.sha256"
  assert stamp.read_text() == hashlib.sha256(
      _codec.SOURCE.read_bytes() + " ".join(_codec.CXX_FLAGS).encode()
  ).hexdigest()


# -- the evaluate CLI on the JAX package's default stores ---------------------

GOLDEN_VARIABLES = ["geopotential", "temperature", "2m_temperature"]


@pytest.fixture(scope="module")
def golden_stores(tmp_path_factory):
  """The same seeded truth, forecast and climatology at 30 degrees (values
  rounded to 1/16, so that they compress), written by the JAX package in
  its default format (WB2_ZARR_COMPRESSOR unset: bit-shuffled zstd) and
  uncompressed."""
  tmp = tmp_path_factory.mktemp("blosc_golden")
  kwargs = dict(variables_3d=GOLDEN_VARIABLES[:2],
                variables_2d=GOLDEN_VARIABLES[2:],
                spatial_resolution_in_degrees=30.0)
  datasets = {
      "truth": jschema.mock_truth_data(
          time_start="2020-02-20", time_stop="2020-03-08",
          time_resolution="12 hours", **kwargs),
      "forecast": jschema.mock_forecast_data(
          time_start="2020-02-24", time_stop="2020-03-04",
          time_resolution="12 hours", lead_stop="3 days",
          lead_resolution="12 hours", **kwargs),
      "climatology": jschema.mock_hourly_climatology_data(
          hour_interval=12, **kwargs)}
  paths = {"zstd3": {}, "none": {}}
  with pytest.MonkeyPatch.context() as mp:
    mp.delenv("WB2_ZARR_COMPRESSOR", raising=False)
    for seed, (name, ds) in enumerate(datasets.items()):
      ds = jutils.random_like(ds, seed=21 + seed)
      ds = ds.copy(data={k: (np.round(np.asarray(v.values) * 16) / 16)
                         .astype(np.float32) for k, v in ds.items()})
      for fmt in paths:
        paths[fmt][name] = str(tmp / f"{name}_{fmt}.zarr")
        jxds.to_zarr(ds, paths[fmt][name],
                     **({} if fmt == "zstd3" else {"compressor": "none"}))
  for path in paths["zstd3"].values():
    for name in GOLDEN_VARIABLES:
      meta = json.load(open(os.path.join(path, name, ".zarray")))
      assert meta["compressor"]["cname"] == "zstd", meta
    assert_codec_ran(path, GOLDEN_VARIABLES)
  return tmp, paths


@pytest.mark.parametrize("configs", [
    "deterministic", "deterministic_spatial,deterministic_temporal"])
def test_evaluate_cli_on_jax_default_stores_is_bitwise(golden_stores,
                                                       configs):
  from weatherbench2_torch.cli import evaluate as cli

  tmp, paths = golden_stores
  results = {}
  for fmt, p in paths.items():
    out = tmp / f"out_{fmt}_{configs.replace(',', '_')}"
    cli.main([
        f"--forecast_path={p['forecast']}", f"--obs_path={p['truth']}",
        f"--climatology_path={p['climatology']}", f"--output_dir={out}",
        "--variables=" + ",".join(GOLDEN_VARIABLES),
        "--time_start=2020-02-24", "--time_stop=2020-03-02T12",
        f"--eval_configs={configs}", "--use_mesh",
        "--input_chunks=init_time=4", "--device=cpu"])
    results[fmt] = {f: xds.open_netcdf(str(out / f)) for f in
                    sorted(os.listdir(out)) if f.endswith(".nc")}
  assert sorted(results["zstd3"]) == sorted(results["none"]) and results["none"]
  for f, ds in results["none"].items():
    assert_bitwise(results["zstd3"][f], ds)


def test_data_prep_twin_on_jax_default_store_is_bitwise(golden_stores):
  from weatherbench2_torch.cli import compute_averages

  tmp, paths = golden_stores
  outs = {}
  for fmt, p in paths.items():
    outs[fmt] = str(tmp / f"averages_{fmt}.zarr")
    compute_averages.main([
        f"--input_path={p['truth']}", f"--output_path={outs[fmt]}",
        "--averaging_dims=latitude,longitude", "--device=cpu"])
  assert_bitwise(xds.open_zarr(outs["zstd3"]), xds.open_zarr(outs["none"]))


# -- the committed fixtures ----------------------------------------------------


@pytest.mark.parametrize("cname", CNAMES)
@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_committed_fixtures_match_the_manifest(cname, shuffle):
  with open(os.path.join(FIXTURES, "manifest.json")) as f:
    manifest = json.load(f)
  store = f"{cname}_shuffle{shuffle}.zarr"
  path = os.path.join(FIXTURES, store)
  assert_codec_ran(path, compressed_vars(cname))
  for lazy in (False, True):
    got = arrays(xds.open_zarr(path, lazy=lazy))
    assert {n: sha256(v) for n, v in got.items()} == manifest[store]
  want = arrays(jxds.open_zarr(path))
  assert {n: sha256(v) for n, v in want.items()} == manifest[store]


def write_fixtures(root=FIXTURES):
  """One small store per cname x shuffle, written by the JAX package, and
  manifest.json: each array's sha256 as the JAX package reads it."""
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  manifest = {}
  for cname in CNAMES:
    for shuffle in SHUFFLES:
      store = f"{cname}_shuffle{shuffle}.zarr"
      path = os.path.join(root, store)
      jxds.to_zarr(jax_dataset(FIXTURE_SHAPE, seed=1), path,
                   chunks=FIXTURE_CHUNKS, compressor=blosc(cname, shuffle))
      manifest[store] = {n: sha256(v)
                         for n, v in arrays(jxds.open_zarr(path)).items()}
  with open(os.path.join(root, "manifest.json"), "w") as f:
    json.dump(manifest, f, indent=1, sort_keys=True)
    f.write("\n")


if __name__ == "__main__":
  write_fixtures()

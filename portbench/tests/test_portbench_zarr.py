"""The benchmark's Zarr writer and frozen codec, read back by the port."""
import copy
import json
import pathlib
import shutil

import numpy as np
import pytest

from harness import codec, fields, stores, zarrv2

BENCH = pathlib.Path(__file__).resolve().parents[1]


def _layout(config, traffic):
  cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
  tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
  cfg["grid"] = {"longitudes": 64, "latitudes": 32, "poles": False}
  cfg["leads"] = {"count": 3, "step_hours": 12}
  if cfg.get("members"):
    cfg["members"] = 3
  tr = copy.deepcopy(tr)
  tr["inits_per_job"] = min(tr["inits_per_job"], 2)
  return fields.Layout(cfg, tr)


def _compiler():
  return any(shutil.which(c) for c in ("c++", "g++"))


@pytest.mark.parametrize("config,traffic", [
    ("wb2-det-1.5deg", "raw-32inits"),
    ("wb2-det-1.5deg", "lz4-32inits"),
    ("wb2-det-1.5deg", "zstd3-32inits"),
    ("wb2-ens50-1.5deg", "raw-2inits"),
])
def test_stores_read_back_by_the_port(tmp_path, config, traffic):
  from weatherbench2_torch import xds

  lay = _layout(config, traffic)
  if lay.traffic["compressor"] and not _compiler():
    pytest.skip("no C++ compiler for the blosc codec")
  fl = fields.Fields(lay, 2**31 + 99, "cpu")
  info = stores.write_stores(str(tmp_path), fl, lay.traffic["compressor"], 2)
  if lay.traffic["compressor"]:
    assert info["bytes"] < info["raw_bytes"]
  fc = xds.open_zarr(info["paths"]["forecast"])
  truth = xds.open_zarr(info["paths"]["truth"])
  clim = xds.open_zarr(info["paths"]["climatology"], lazy=True)
  assert fc.sizes["longitude"] == 64 and fc.sizes["latitude"] == 32
  np.testing.assert_array_equal(np.asarray(fc.coords_dict()["time"].data),
                                lay.inits)
  np.testing.assert_array_equal(
      np.asarray(fc.coords_dict()["prediction_timedelta"].data), lay.leads)
  np.testing.assert_array_equal(
      np.asarray(truth.coords_dict()["time"].data), lay.truth_times)
  for name in lay.variables:
    np.testing.assert_array_equal(np.asarray(fc[name].data),
                                  fl.forecast(name).numpy())
    np.testing.assert_array_equal(np.asarray(truth[name].data),
                                  fl.truth(name).numpy())
  np.testing.assert_array_equal(np.asarray(truth["land_sea_mask"].data),
                                fl.land_sea_mask().numpy())
  name = lay.variables[0]
  first = int(lay.read_doys[0]) - 1
  rows = slice(first, first + len(lay.read_doys))
  if lay.config["climatology"].get("quantiles"):
    got = np.asarray(clim[f"{name}_quantile"].data)[:, rows]
    want = fl.quantiles(name, lay.read_doys,
                        lay.config["climatology"]["quantiles"]).numpy()
  else:
    got = np.asarray(clim[name].data)[rows]
    want = fl.climatology(name, lay.read_doys).numpy()
  np.testing.assert_array_equal(got, want)


def test_reader_round_trip(tmp_path):
  w = zarrv2.StoreWriter(str(tmp_path / "s.zarr"))
  values = np.arange(6 * 5, dtype=np.float32).reshape(6, 5)
  w.create("x", ("a", "b"), (6, 5), (4, 5))
  w.write_chunk("x", (0, 0), values[:4])
  pad = np.zeros((4, 5), np.float32)
  pad[:2] = values[4:]
  w.write_chunk("x", (1, 0), pad)
  w.finish()
  got, dims, _ = zarrv2.read_array(str(tmp_path / "s.zarr"), "x")
  assert dims == ("a", "b")
  np.testing.assert_array_equal(got, values)


@pytest.mark.parametrize("shuffle", [0, 1, 2])
def test_frozen_lz4_chunks_read_by_the_port(shuffle):
  if not _compiler():
    pytest.skip("no C++ compiler for the codecs")
  from weatherbench2_torch.xds import _codec

  rng = np.random.default_rng(shuffle)
  data = np.cumsum(rng.standard_normal(300_000)).astype(np.float32)
  raw = codec.encode(data, "lz4", 5, shuffle, 2)
  if shuffle:  # unshuffled noisy floats may be stored as they are
    assert len(raw) < data.nbytes
  out = np.empty_like(data)
  _codec.decode_into(raw, out, "test")
  np.testing.assert_array_equal(out, data)
  # and the port's zstd chunks (its results' default) through the copy
  port = _codec.encode(data, "zstd", 3, 2, 0, "test").tobytes()
  back = np.empty_like(data)
  codec.decode_into(port, back)
  np.testing.assert_array_equal(back, data)


@pytest.mark.parametrize("shuffle", [0, 1, 2])
def test_frozen_zstd_chunks_read_by_the_port(shuffle):
  if not _compiler():
    pytest.skip("no C++ compiler for the codecs")
  from weatherbench2_torch.xds import _codec

  rng = np.random.default_rng(10 + shuffle)
  data = np.cumsum(rng.standard_normal(300_000)).astype(np.float32)
  raw = codec.encode(data, "zstd", 3, shuffle, 2)
  assert len(raw) < data.nbytes
  out = np.empty_like(data)
  _codec.decode_into(raw, out, "test")
  np.testing.assert_array_equal(out, data)


def test_codec_copy_is_frozen():
  # the copy builds into the benchmark's own directory, not the port's
  assert codec.BUILD_DIR == BENCH / "build"
  assert codec.SOURCE == BENCH / "codec" / "codecs.cpp"

"""The port's evaluation slice end to end on the CPU.

The golden inputs of tests/golden/common.py are written uncompressed (the
JAX package reads WB2_ZARR_COMPRESSOR at call time), then:

  (a) the port reproduces the committed deterministic goldens;
  (b) the bench suite (MSE/RMSE/Bias/ACC, three regions) matches the JAX
      package's ``evaluate_with_mesh`` on the same stores, on its plain
      path and on its Pallas kernels in interpret mode;
  (c) with init_time chunks of 4 (a ragged, padded last chunk, and the
      truth deduplicated per chunk) the port gives the same results.

Tolerance: the port reduces in float32 while the goldens and the JAX run
here (x64 on) reduce float64 inputs in float64; per-time values near zero
(bias) carry only an absolute error.  Each variable is held to
``rtol=1e-5`` plus ``atol=1e-5 × max|reference|`` of that variable.
"""
import os

import numpy as np
import pytest
import torch

from tests.golden import common
from weatherbench2_tpu import config as jconfig
from weatherbench2_tpu import evaluation as jevaluation
from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.regions import ExtraTropicalRegion, SliceRegion
from weatherbench2_torch import convert
from weatherbench2_torch import evaluation
from weatherbench2_torch import ops
from weatherbench2_torch.parallel import streaming

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
RTOL = 1e-5


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_eval")
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    paths = common.build_inputs(str(tmp))
  return tmp, paths


def _data_config(paths, out_dir, levels=(500, 850)):
  return jconfig.Data(
      selection=jconfig.Selection(
          variables=["geopotential", "2m_temperature"],
          levels=list(levels),
          time_slice=slice("2020-01-01", "2020-01-15"),
      ),
      paths=jconfig.Paths(
          forecast=paths["forecast"], obs=paths["truth"],
          climatology=paths["climatology"], output_dir=str(out_dir)),
      by_init=True,
  )


def _bench_config(clim):
  """bench.py's _run_suite config."""
  return {
      "deterministic": jconfig.Eval(
          metrics={
              "mse": jmetrics.MSE(),
              "rmse": jmetrics.RMSESqrtBeforeTimeAvg(),
              "bias": jmetrics.Bias(),
              "acc": jmetrics.ACC(climatology=clim),
          },
          regions={
              "global": SliceRegion(),
              "tropics": SliceRegion(lat_slice=slice(-20, 20)),
              "extra-tropics": ExtraTropicalRegion(),
          },
      )
  }


def _assert_results_close(got, want, what, time_coords=True):
  assert sorted(got.keys()) == sorted(want.keys()), what
  for k in want.keys():
    w = want[k]
    g = got[k].transpose(*w.dims)
    for d in w.dims:
      if d in want.coords_dict() and (
          time_coords or want.coords_dict()[d].dtype.kind not in "mM"):
        np.testing.assert_array_equal(
            np.asarray(got.coords_dict()[d].data),
            np.asarray(want.coords_dict()[d].data), err_msg=f"{what}/{d}")
    wv = np.asarray(w.values, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(g.values, dtype=np.float64), wv, rtol=RTOL,
        atol=RTOL * np.nanmax(np.abs(wv)), err_msg=f"{what}/{k}")


def _run_port(data_config, eval_configs, **kw):
  return evaluation.evaluate_with_mesh(
      convert.from_reference(data_config),
      convert.eval_configs_from_reference(eval_configs), device="cpu", **kw)


@pytest.mark.parametrize("name", ["deterministic", "deterministic_temporal",
                                  "deterministic_vs_analysis"])
def test_port_reproduces_golden(stores, name):
  tmp, paths = stores
  clim = jxds.open_zarr(paths["climatology"])
  cfg = {name: common.eval_configs(clim)[name]}
  out = tmp / f"golden_{name}"
  stats = _run_port(_data_config(paths, out), cfg)
  assert stats["chunks"] == 1
  got = jxds.open_netcdf(str(out / f"{name}.nc"))
  want = jxds.open_netcdf(os.path.join(GOLDEN_DIR, f"{name}.nc"))
  # the committed goldens' lead_time labels read back 1000x too small in
  # this environment (a reference-side encoding quirk); data and the other
  # labels are compared
  _assert_results_close(got, want, name, time_coords=False)


@pytest.fixture(scope="module")
def bench_runs(stores):
  """The bench suite through the port (one chunk, and chunks of 4) and
  through the JAX package (plain path, and Pallas in interpret mode)."""
  tmp, paths = stores
  clim = jxds.open_zarr(paths["climatology"])
  levels = (500, 700, 850)
  runs = {}
  for tag, chunks in (("port", {}), ("port_chunks4", {"init_time": 4})):
    out = tmp / tag
    runs[tag + "_stats"] = _run_port(
        _data_config(paths, out, levels), _bench_config(clim),
        input_chunks=chunks)
    runs[tag] = jxds.open_netcdf(str(out / "deterministic.nc"))
  for tag, pallas in (("jax", "0"), ("jax_pallas", "1")):
    with pytest.MonkeyPatch.context() as mp:
      mp.setenv("WB2_USE_PALLAS", pallas)
      out = tmp / tag
      jevaluation.evaluate_with_mesh(
          _data_config(paths, out, levels), _bench_config(clim),
          input_chunks={})
    runs[tag] = jxds.open_netcdf(str(out / "deterministic.nc"))
  return runs


@pytest.mark.parametrize("reference", ["jax", "jax_pallas"])
def test_bench_suite_matches_jax(bench_runs, reference):
  got, want = bench_runs["port"], bench_runs[reference]
  assert list(got.coords_dict()["metric"].data) == [
      "mse", "rmse", "bias", "acc"]
  assert list(got.coords_dict()["region"].data) == [
      "global", "tropics", "extra-tropics"]
  _assert_results_close(got, want, reference)


def test_chunked_run_matches(bench_runs):
  # 15 inits in chunks of 4: the last chunk has 3 and is padded
  assert bench_runs["port_chunks4_stats"]["chunks"] == 4
  assert bench_runs["port_stats"]["chunks"] == 1
  for reference in ("port", "jax", "jax_pallas"):
    _assert_results_close(bench_runs["port_chunks4"], bench_runs[reference],
                          f"chunks of 4 vs {reference}")


def test_truth_dedup_ships_unique_times(bench_runs):
  # forecast: 15 inits x 4 leads x (3 levels + 1) x 84 cells of float64;
  # the deduped truth holds 18 unique valid times padded to 32, not 60
  stats = bench_runs["port_stats"]
  forecast_bytes = 15 * 4 * 4 * 84 * 8
  truth_bytes = 32 * 4 * 84 * 8
  assert forecast_bytes + truth_bytes <= stats["h2d_bytes"]
  assert stats["h2d_bytes"] < forecast_bytes + truth_bytes + 200_000


def test_default_device_raises_without_cuda(stores, monkeypatch):
  tmp, paths = stores
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  clim = jxds.open_zarr(paths["climatology"])
  with pytest.raises(RuntimeError, match="device='cpu'"):
    evaluation.evaluate_with_mesh(
        convert.from_reference(_data_config(paths, tmp / "nocuda")),
        convert.eval_configs_from_reference(_bench_config(clim)))


def test_unported_paths_raise(stores):
  """Nothing is left unported: a mesh (A.12) must be the port's own (its
  runs are in tests/test_torch_mesh.py), and the bfloat16 transfer mode
  (A.6) runs (held to the JAX package in tests/test_torch_transfer_bf16.py);
  lead_time chunks, configs without regions and checkpoints run too."""
  tmp, paths = stores
  clim = jxds.open_zarr(paths["climatology"])
  dc = _data_config(paths, tmp / "unported")
  with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
    _run_port(dc, _bench_config(clim), mesh=object())
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_TRANSFER_DTYPE", "bfloat16")
    assert _run_port(dc, _bench_config(clim))["chunks"] == 1
  prob_clim = {"d": jconfig.Eval(
      metrics={"mse": jmetrics.MSE()},
      evaluate_probabilistic_climatology=True,
      probabilistic_climatology_start_year=1990,
      probabilistic_climatology_end_year=2000)}
  # the baseline is ported: years the truth lacks raise as in the JAX package
  with pytest.raises(KeyError, match="year 1990"):
    _run_port(dc, prob_clim)
  no_regions = {"d": jconfig.Eval(metrics={"mse": jmetrics.MSE()})}
  stats = _run_port(dc, no_regions, input_chunks={"lead_time": 2},
                    checkpoint_path=str(tmp / "ckpt"), checkpoint_every=1)
  assert stats["chunks"] == 2  # one init chunk in two lead slices
  assert os.path.exists(tmp / "ckpt.d")


def test_launch_counters_stay_zero_on_cpu(bench_runs):
  del bench_runs
  assert ops.fused_deterministic_sums.launches == 0
  assert ops.fused_region_sums.launches == 0


def test_host_gather_climatology_matches(stores, bench_runs, monkeypatch):
  """ACC with the climatology gathered per chunk on the host (the mode for
  climatologies too large to keep on the device) gives the same results."""
  tmp, paths = stores
  monkeypatch.setenv("WB2_CLIM_DEVICE_BYTES", "0")
  clim = jxds.open_zarr(paths["climatology"])
  out = tmp / "host_gather"
  _run_port(_data_config(paths, out, (500, 700, 850)), _bench_config(clim),
            input_chunks={"init_time": 4})
  got = jxds.open_netcdf(str(out / "deterministic.nc"))
  np.testing.assert_array_equal(
      np.asarray(got["geopotential"].values),
      np.asarray(bench_runs["port_chunks4"]["geopotential"].values))
  _assert_results_close(got, bench_runs["jax"], "host gather vs jax")


def test_masked_sum_count_skipna():
  vals = torch.tensor([[1.0, np.nan, 3.0, 4.0], [2.0, 2.0, np.nan, 9.0]])
  from weatherbench2_torch import xds

  result = xds.Dataset({"v": (("r", "init_time"), vals)})
  mask = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=torch.float64)
  s, c = streaming._masked_sum_count(result, "init_time", mask, skipna=True)
  np.testing.assert_array_equal(s["v"].values, [4.0, 4.0])
  np.testing.assert_array_equal(c["v"].values, [2.0, 2.0])
  s, c = streaming._masked_sum_count(result, "init_time", mask, skipna=False)
  assert np.isnan(s["v"].values).all()
  np.testing.assert_array_equal(c["v"].values, [3.0, 3.0])


def test_by_valid_convention_matches_jax(stores):
  """by_init=False: the forecast's time is the valid time and the truth
  aligns on it (no truth dedup); port and JAX agree."""
  tmp, paths = stores
  clim = jxds.open_zarr(paths["climatology"])
  outs = {}
  for tag in ("port", "jax"):
    dc = _data_config(paths, tmp / f"by_valid_{tag}", (500, 700, 850))
    dc.by_init = False
    if tag == "port":
      stats = _run_port(dc, _bench_config(clim), input_chunks={"time": 6})
      assert stats["chunks"] == 3
    else:
      jevaluation.evaluate_with_mesh(dc, _bench_config(clim),
                                     input_chunks={"time": 6})
    outs[tag] = jxds.open_netcdf(str(tmp / f"by_valid_{tag}" /
                                     "deterministic.nc"))
  _assert_results_close(outs["port"], outs["jax"], "by valid")


@pytest.mark.parametrize("skipna", [False, True])
def test_nans_in_forecast_match_jax(stores, skipna):
  """NaN cells (one whole field, scattered cells) flow through the fused
  tiers with both NaN semantics as in the JAX package."""
  tmp, paths = stores
  fc = jxds.open_zarr(paths["forecast"])
  data = {k: np.array(v.data) for k, v in fc.variables_dict().items()}
  rs = np.random.RandomState(11)
  data["geopotential"][1, 2, 0] = np.nan  # one (lead, init, level) field
  data["2m_temperature"][rs.rand(*data["2m_temperature"].shape) < 0.02] = (
      np.nan)
  nan_path = str(tmp / f"forecast_nans_{skipna}.zarr")
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    jxds.to_zarr(fc.copy(data=data), nan_path)
  clim = jxds.open_zarr(paths["climatology"])
  outs = {}
  for tag in ("port", "jax"):
    dc = _data_config(paths, tmp / f"nans_{skipna}_{tag}", (500, 700, 850))
    dc.paths.forecast = nan_path
    if tag == "port":
      _run_port(dc, _bench_config(clim), skipna=skipna,
                input_chunks={"init_time": 4})
    else:
      jevaluation.evaluate_with_mesh(dc, _bench_config(clim), skipna=skipna,
                                     input_chunks={"init_time": 4})
    outs[tag] = jxds.open_netcdf(
        str(tmp / f"nans_{skipna}_{tag}" / "deterministic.nc"))
  for k in outs["jax"].keys():
    np.testing.assert_array_equal(np.isnan(outs["port"][k].values),
                                  np.isnan(outs["jax"][k].values), err_msg=k)
  t2m = outs["port"]["2m_temperature"].values
  # scattered NaNs poison regions under skipna=False, none under True
  assert np.isnan(t2m).any() if not skipna else np.isfinite(t2m).all()
  _assert_results_close(outs["port"], outs["jax"], f"nans skipna={skipna}")

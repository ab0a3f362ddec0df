"""The probabilistic suite through the port's engines, on the CPU.

Inputs are made from seeds with the JAX package's factories at 30 degrees
(12 x 7 cells) and written uncompressed:

  (a) the committed goldens ``tests/golden/<config>.nc`` of the eight
      probabilistic configs (``tests/golden/common.py``: 5 members, three
      regions, quantile thresholds at 0.25/0.75), through the port's
      ``evaluate_in_memory`` and its streaming engine, rank-histogram counts
      equal;
  (b) the eight configs as ``scripts/evaluate.py`` builds them, on stores
      with NaN members, NaN truth cells and thresholds that put +inf
      ignorance cells inside and outside the regions: the port's streaming
      engine against the JAX package's ``evaluate_with_mesh``, in both
      ``skipna`` modes, in chunks of 4 inits over 10 (the last chunk is
      padded);
  (c) a probabilistic group killed after its first chunk and resumed, equal
      bit for bit to the uninterrupted run.

Tolerance, as in ``tests/test_torch_evaluation.py``: the port reduces in
float32 where the JAX runs here (x64 on) reduce in float64, so each variable
is held to ``rtol=1e-5`` plus ``atol=1e-5 x max|reference|``; rank
histograms are counts and are held equal.
"""
import os

import numpy as np
import pytest

from tests.golden import common
from tests.test_torch_official_configs import assert_results_close
from weatherbench2_tpu import config as jconfig
from weatherbench2_tpu import evaluation as jevaluation
from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import thresholds as jthresholds
from weatherbench2_tpu import utils as jutils
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.regions import ExtraTropicalRegion, SliceRegion
from weatherbench2_torch import convert
from weatherbench2_torch import evaluation
from weatherbench2_torch.parallel import streaming

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
ENSEMBLE_CONFIGS = ["probabilistic", "ensemble_binary",
                    "ensemble_forecast_vs_era_experimental_metrics",
                    "probabilistic_spatial", "ensemble_binary_spatial",
                    "probabilistic_spatial_histograms"]
GAUSSIAN_CONFIGS = ["gaussian_probabilistic", "gaussian_binary"]
CONFIGS = ENSEMBLE_CONFIGS + GAUSSIAN_CONFIGS
VARIABLES = ["geopotential", "2m_temperature"]
AUX = [f"{v}_std" for v in VARIABLES]
QUANTILES = (0.25, 0.75)
TIME_SLICE = slice("2020-01-01", "2020-01-10")  # 10 daily inits


def open_result(out_dir, name):
  path = os.path.join(str(out_dir), name)
  if os.path.exists(path + ".zarr"):
    return jxds.open_zarr(path + ".zarr")
  return jxds.open_netcdf(path + ".nc")


def assert_histograms_equal(got, want, n_inits, what):
  """Rank histograms are counts: the time means times the number of inits
  are whole numbers, and equal (the means themselves may differ in the last
  bits: the in-memory engine averages in float32, the streaming ones sum in
  float64)."""
  assert sorted(got.keys()) == sorted(want.keys()), what
  for k in want.keys():
    counts = [np.asarray(ds[k].transpose(*want[k].dims).values,
                         np.float64) * n_inits for ds in (got, want)]
    for c in counts:
      np.testing.assert_allclose(c, np.rint(c), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(*(np.rint(c) for c in counts),
                                  err_msg=f"{what}/{k}")


# -- (a) goldens ---------------------------------------------------------------


@pytest.fixture(scope="module")
def golden_stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_golden_probabilistic")
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    return tmp, common.build_inputs(str(tmp))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("engine", ["in_memory", "streaming"])
def test_port_reproduces_golden(golden_stores, engine, name):
  tmp, paths = golden_stores
  cfg = {name: common.eval_configs(
      jxds.open_zarr(paths["climatology"]),
      jxds.open_zarr(paths["qclim"]))[name]}
  gaussian = name.startswith("gaussian")
  dc = jconfig.Data(
      selection=jconfig.Selection(
          variables=VARIABLES, aux_variables=AUX if gaussian else [],
          levels=[500, 850], time_slice=slice("2020-01-01", "2020-01-15")),
      paths=jconfig.Paths(
          forecast=paths["gaussian" if gaussian else "ensemble"],
          obs=paths["truth"], climatology=paths["climatology"],
          output_dir=str(tmp / f"{engine}_{name}")),
      by_init=True)
  port_dc, port_cfg = (convert.from_reference(dc),
                       convert.eval_configs_from_reference(cfg))
  if engine == "in_memory":
    evaluation.evaluate_in_memory(port_dc, port_cfg, device="cpu")
  else:
    stats = evaluation.evaluate_with_mesh(port_dc, port_cfg, device="cpu",
                                          input_chunks={"init_time": 4})
    assert stats["chunks"] == 4
  got = open_result(tmp / f"{engine}_{name}", name)
  want = jxds.open_netcdf(os.path.join(GOLDEN_DIR, f"{name}.nc"))
  # the goldens' lead_time labels read back 1000x too small here (a
  # reference-side encoding quirk): data and the other labels are compared
  assert_results_close(got, want, f"{engine}/{name}", time_coords=False)
  if name == "probabilistic_spatial_histograms":
    assert_histograms_equal(got, want, 15, f"{engine}/{name}")


# -- (b) against the JAX streaming engine ------------------------------------------


def build_stores(tmp_dir: str) -> dict:
  """Fixed-seed stores, uncompressed: daily truth with NaN cells; a
  5-member ensemble (10 daily inits x 4 daily leads) with NaN members; a
  Gaussian forecast (the variables and their ``_std``) with NaN cells; and
  a climatology holding the variables, their ``_std`` and ``_quantile``
  fields.  The quantile surfaces are at ±0.6, so that whole ensembles fall
  on one side and ignorance scores reach +inf, except on the equator (the
  tropics' one row here), where they are at ±10 and every score is
  finite."""
  kwargs = dict(variables_3d=VARIABLES[:1], variables_2d=VARIABLES[1:],
                levels=(500, 850), spatial_resolution_in_degrees=30.0)
  truth = jutils.random_like(jschema.mock_truth_data(
      time_start="2020-01-01", time_stop="2020-01-16", **kwargs), seed=31)
  fc_kwargs = dict(time_start="2020-01-01", time_stop="2020-01-11",
                   lead_stop="3 days", **kwargs)
  ens = jutils.random_like(jschema.mock_forecast_data(
      ensemble_size=5, **fc_kwargs), seed=32)
  gauss = jutils.random_like(jschema.mock_forecast_data(**fc_kwargs),
                             seed=33)
  clim = jutils.random_like(jschema.mock_hourly_climatology_data(
      hour_interval=6, **kwargs), seed=34)
  rs = np.random.RandomState(35)

  def with_nans(ds, share):
    out = {}
    for k in ds.keys():
      a = np.array(ds[k].values)
      nan = rs.rand(*a.shape) < share
      if ds is truth:
        nan[..., 3] = False  # a NaN truth's ignorance is +inf too
      a[nan] = np.nan
      out[k] = a
    return ds.copy(data=out)

  truth, ens, gauss = (with_nans(ds, 0.02) for ds in (truth, ens, gauss))
  for v in VARIABLES:
    gauss[f"{v}_std"] = abs(gauss[v]) + 0.5
    base = clim[v]
    clim[f"{v}_std"] = jxds.Variable(base.dims, np.full(base.shape, 0.8,
                                                        np.float32))
    surfaces = np.stack([np.full(base.shape, -0.6), np.full(base.shape, 0.6)])
    surfaces[..., 3] *= 10 / 0.6  # latitude 0
    clim[f"{v}_quantile"] = jxds.Variable(("quantile",) + base.dims,
                                          surfaces.astype(np.float32))
  clim = clim.assign_coords(quantile=np.asarray(QUANTILES))
  paths = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    for name, ds in (("truth", truth), ("ensemble", ens),
                     ("gaussian", gauss), ("climatology", clim)):
      paths[name] = os.path.join(tmp_dir, f"{name}.zarr")
      jxds.to_zarr(ds, paths[name])
  return paths


def three_regions():
  return {"global": SliceRegion(),
          "tropics": SliceRegion(lat_slice=slice(-20, 20)),
          "extra-tropics": ExtraTropicalRegion()}


def official_configs(clim, regions, method="quantile", seed=771) -> dict:
  """The eight configs as ``scripts/evaluate.py:296-399`` builds them with
  ``--ensemble_dim=realization`` and two quantile thresholds, in the
  reference package's classes; the rank histogram is seeded."""
  ens = dict(ensemble_dim="realization")
  thr = [jthresholds.get_threshold_cls(method)(climatology=clim, quantile=q)
         for q in QUANTILES]
  return {
      "probabilistic": jconfig.Eval(metrics={
          "crps": jmetrics.CRPS(**ens),
          "crps_spread": jmetrics.CRPSSpread(**ens),
          "crps_skill": jmetrics.CRPSSkill(**ens),
          "ensemble_mean_mse": jmetrics.EnsembleMeanMSE(**ens),
          "debiased_ensemble_mean_mse": jmetrics.DebiasedEnsembleMeanMSE(
              **ens),
          "ensemble_variance": jmetrics.EnsembleVariance(**ens)},
          regions=regions),
      "ensemble_binary": jconfig.Eval(metrics={
          "brier_score": jmetrics.EnsembleBrierScore(thresholds=thr, **ens),
          "debiased_brier_score": jmetrics.DebiasedEnsembleBrierScore(
              thresholds=thr, **ens),
          "ignorance_score": jmetrics.EnsembleIgnoranceScore(
              thresholds=thr, **ens)}, regions=regions),
      "ensemble_forecast_vs_era_experimental_metrics": jconfig.Eval(metrics={
          "energy_score": jmetrics.EnergyScore(**ens),
          "energy_score_spread": jmetrics.EnergyScoreSpread(**ens),
          "energy_score_skill": jmetrics.EnergyScoreSkill(**ens),
          "ensemble_mean_rmse_sqrt_before_time_avg": (
              jmetrics.EnsembleMeanRMSESqrtBeforeTimeAvg(**ens)),
          "ensemble_stddev_sqrt_before_time_avg": (
              jmetrics.EnsembleStddevSqrtBeforeTimeAvg(**ens))}),
      "probabilistic_spatial": jconfig.Eval(metrics={
          "crps": jmetrics.SpatialCRPS(**ens),
          "crps_spread": jmetrics.SpatialCRPSSpread(**ens),
          "crps_skill": jmetrics.SpatialCRPSSkill(**ens),
          "ensemble_mean_mse": jmetrics.SpatialEnsembleMeanMSE(**ens),
          "debiased_ensemble_mean_mse": (
              jmetrics.DebiasedSpatialEnsembleMeanMSE(**ens)),
          "ensemble_variance": jmetrics.SpatialEnsembleVariance(**ens)},
          output_format="zarr"),
      "ensemble_binary_spatial": jconfig.Eval(metrics={
          "brier_score": jmetrics.SpatialEnsembleBrierScore(
              thresholds=thr, **ens),
          "debiased_brier_score": jmetrics.SpatialDebiasedEnsembleBrierScore(
              thresholds=thr, **ens),
          "ignorance_score": jmetrics.SpatialEnsembleIgnoranceScore(
              thresholds=thr, **ens)}, output_format="zarr"),
      "probabilistic_spatial_histograms": jconfig.Eval(
          metrics={"rank_histogram": jmetrics.RankHistogram(seed=seed,
                                                             **ens)},
          output_format="zarr"),
      "gaussian_probabilistic": jconfig.Eval(metrics={
          "crps": jmetrics.GaussianCRPS(),
          "ensemble_variance": jmetrics.GaussianVariance()},
          regions=regions),
      "gaussian_binary": jconfig.Eval(metrics={
          "brier_score": jmetrics.GaussianBrierScore(thresholds=thr),
          "ignorance_score": jmetrics.GaussianIgnoranceScore(
              thresholds=thr)}, regions=regions),
  }


def data_config(paths, out_dir, gaussian=False):
  return jconfig.Data(
      selection=jconfig.Selection(
          variables=VARIABLES, aux_variables=AUX if gaussian else None,
          levels=[500, 850], time_slice=TIME_SLICE),
      paths=jconfig.Paths(
          forecast=paths["gaussian" if gaussian else "ensemble"],
          obs=paths["truth"], climatology=paths["climatology"],
          output_dir=str(out_dir)),
      by_init=True)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_probabilistic")
  return tmp, build_stores(str(tmp))


def run_both(paths, out, cfgs, engine, **kw):
  """Every config of ``cfgs`` through one engine, the ensemble and the
  Gaussian configs in a stream each; the port's counts."""
  stats = {}
  for gaussian, names in ((False, ENSEMBLE_CONFIGS), (True, GAUSSIAN_CONFIGS)):
    group = {n: cfgs[n] for n in names if n in cfgs}
    if not group:
      continue
    dc = data_config(paths, out, gaussian)
    if engine == "jax":
      jevaluation.evaluate_with_mesh(dc, group, **kw)
    else:
      s = evaluation.evaluate_with_mesh(
          convert.from_reference(dc),
          convert.eval_configs_from_reference(group), device="cpu", **kw)
      stats = {k: stats.get(k, 0) + v for k, v in s.items()}
  return stats


@pytest.fixture(scope="module")
def engine_runs(stores):
  """{skipna: {engine: {config: results}}}, chunks of 4 of 10 inits."""
  tmp, paths = stores
  cfgs = official_configs(jxds.open_zarr(paths["climatology"]),
                          three_regions())
  runs = {}
  for skipna in (False, True):
    runs[skipna] = {}
    for engine in ("port", "jax"):
      out = tmp / f"engine_{engine}_{skipna}"
      runs[skipna][f"{engine}_stats"] = run_both(
          paths, out, cfgs, engine, skipna=skipna,
          input_chunks={"init_time": 4})
      runs[skipna][engine] = {n: open_result(out, n) for n in CONFIGS}
  return runs


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("skipna", [False, True])
def test_streaming_matches_jax_streaming(engine_runs, skipna, name):
  got = engine_runs[skipna]["port"][name]
  want = engine_runs[skipna]["jax"][name]
  assert_results_close(got, want, f"skipna={skipna}/{name}")
  if name == "probabilistic_spatial_histograms":
    assert_histograms_equal(got, want, 10, name)
  # three chunks, the last one padded, in each of the two streams
  assert engine_runs[skipna]["port_stats"]["chunks"] == 6


def test_nans_bite_and_skipna_skips_them(engine_runs):
  """NaN members and truth cells poison the regional means without
  ``skipna`` and are skipped with it."""
  off = engine_runs[False]["port"]["probabilistic"]["geopotential"].values
  on = engine_runs[True]["port"]["probabilistic"]["geopotential"].values
  assert np.isnan(off).mean() > 0.5
  assert np.isfinite(on).all()


def test_ignorance_reaches_inf_inside_and_outside_regions(stores,
                                                          engine_runs):
  """+inf ignorance cells exist; a region holding one is +inf, a region
  without any stays finite: the indicator rows of the kernel's launch."""
  tmp, paths = stores
  spatial = engine_runs[True]["port"]["ensemble_binary_spatial"]
  binary = engine_runs[True]["port"]["ensemble_binary"]
  k = list(np.asarray(spatial.coords_dict()["metric"].data)).index(
      "ignorance_score")
  cells = spatial["2m_temperature"].isel(metric=k)  # per-cell time means
  inf_cells = np.isinf(cells.values)
  assert inf_cells.any() and not inf_cells.all()
  assert not np.isinf(cells.isel(latitude=3).values).any()
  regions = list(np.asarray(binary.coords_dict()["region"].data))
  regional = binary["2m_temperature"].isel(metric=k)
  assert np.isinf(regional.isel(region=regions.index("global")).values).all()
  assert np.isfinite(
      regional.isel(region=regions.index("tropics")).values).all()


# -- (c) resume ----------------------------------------------------------------------


def test_probabilistic_group_resumes_bit_for_bit(stores, monkeypatch):
  tmp, paths = stores
  cfgs = official_configs(jxds.open_zarr(paths["climatology"]),
                          three_regions())
  group = {n: cfgs[n] for n in ("probabilistic", "probabilistic_spatial",
                                "probabilistic_spatial_histograms",
                                "ensemble_binary")}
  run = lambda out, **kw: evaluation.evaluate_with_mesh(
      convert.from_reference(data_config(paths, out)),
      convert.eval_configs_from_reference(group), device="cpu",
      input_chunks={"init_time": 4}, **kw)
  run(tmp / "resume_full")
  cpath = str(tmp / "resume_ckpt")
  real = os.replace

  class Died(Exception):
    pass

  def replace(src, dst):
    real(src, dst)
    raise Died(dst)

  monkeypatch.setattr(streaming.os, "replace", replace)
  with pytest.raises(Died):
    run(tmp / "resume_killed", checkpoint_path=cpath, checkpoint_every=1)
  monkeypatch.setattr(streaming.os, "replace", real)
  state = streaming.StreamingState.load(cpath + "." + "+".join(sorted(group)))
  assert state.chunk_index == 1
  stats = run(tmp / "resume_resumed", checkpoint_path=cpath,
              checkpoint_every=1)
  assert stats["chunks"] == 2
  for name in group:
    got = open_result(tmp / "resume_resumed", name)
    want = open_result(tmp / "resume_full", name)
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
      np.testing.assert_array_equal(got[k].values, want[k].values,
                                    err_msg=f"{name}/{k}")

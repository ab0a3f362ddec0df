"""The four official deterministic eval configs through the port, on the CPU.

Stores are made from seeds with the JAX package's factories at 30 degrees
(12 x 7 cells), written uncompressed: geopotential and both wind
components at three levels, 2m temperature and 24 h precipitation (with
NaNs), 12-hourly inits from 2020-02-24 (so that valid times cross the leap
day), an hourly climatology at 12-hour steps with the two SEEPS fields
(dry fraction spread over (0, 1) so that the p1 mask bites), and a
``land_sea_mask`` in the obs store.  The same inputs go through the JAX
package and its counterpart in the port:

  (a) every new metric's ``compute_chunk`` and ``pointwise_chunk``;
  (b) the committed golden ``deterministic_spatial.nc``;
  (c) the configs that ``scripts/evaluate.py`` builds (wind vectors, SEEPS,
      sixteen regions or none, both ``skipna`` modes): the port's streaming
      run against its ``evaluate_in_memory`` and against the JAX package's
      ``evaluate_with_mesh``;
  (d) a metric forced to the unfused loop against its fused result;
      ``lead_time`` chunks against the unchunked run; both baselines; a
      ``supports_jit = False`` metric;
  (e) the repaired faults: tier routing with wind vectors, the per-metric
      ``fused_nan_mode``, the full group key.

Tolerance, as in ``tests/test_torch_evaluation.py``: the port reduces in
float32 where the JAX run here (x64 on) reduces in float64, so each
variable is held to ``rtol=1e-5`` plus ``atol=1e-5 x max|reference|``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.golden import common
from weatherbench2_tpu import config as jconfig
from weatherbench2_tpu import evaluation as jevaluation
from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import utils as jutils
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.parallel import streaming as jstreaming
from weatherbench2_tpu.regions import (CombinedRegion, LandRegion,
                                       SliceRegion)
from weatherbench2_torch import config
from weatherbench2_torch import convert
from weatherbench2_torch import evaluation
from weatherbench2_torch import metrics
from weatherbench2_torch import xds
from weatherbench2_torch.cli import evaluate as cli
from weatherbench2_torch.parallel import streaming

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
RTOL = 1e-5
PRECIP = "total_precipitation_24hr"
VARIABLES = ["geopotential", "u_component_of_wind", "v_component_of_wind",
             "2m_temperature", PRECIP]
TIME_SLICE = slice("2020-02-24", "2020-03-02T12")  # 16 inits


def build_stores(tmp_dir: str) -> dict:
  """Fixed-seed truth (with a land-sea mask), forecast and climatology
  (with the SEEPS fields) stores, uncompressed; {name: path}."""
  kwargs = dict(
      variables_3d=VARIABLES[:3], variables_2d=VARIABLES[3:],
      spatial_resolution_in_degrees=30.0)
  truth = jutils.random_like(jschema.mock_truth_data(
      time_start="2020-02-20", time_stop="2020-03-12",
      time_resolution="12 hours", **kwargs), seed=11)
  forecast = jutils.random_like(jschema.mock_forecast_data(
      time_start="2020-02-24", time_stop="2020-03-07",
      time_resolution="12 hours", lead_stop="3 days",
      lead_resolution="12 hours", **kwargs), seed=12)
  clim = jutils.random_like(jschema.mock_hourly_climatology_data(
      hour_interval=12, **kwargs), seed=13)
  rs = np.random.RandomState(14)

  def precipitation(ds):
    shape = ds[PRECIP].shape
    values = np.abs(rs.randn(*shape)) * 2e-3 * (rs.rand(*shape) > 0.3)
    values[rs.rand(*shape) < 0.03] = np.nan
    return ds.copy(data={PRECIP: values.astype(np.float32)})

  truth, forecast = precipitation(truth), precipitation(forecast)
  n_lon, n_lat = truth.sizes["longitude"], truth.sizes["latitude"]
  truth["land_sea_mask"] = jxds.Variable(
      ("longitude", "latitude"), rs.rand(n_lon, n_lat).astype(np.float32))
  cshape = clim[PRECIP].shape  # (dayofyear, hour, longitude, latitude)
  base = rs.rand(n_lon, n_lat)  # per cell: some below 0.1, some above 0.85
  clim[f"{PRECIP}_seeps_dry_fraction"] = jxds.Variable(
      clim[PRECIP].dims,
      np.clip(base + 0.02 * rs.randn(*cshape), 0, 1).astype(np.float32))
  clim[f"{PRECIP}_seeps_threshold"] = jxds.Variable(
      clim[PRECIP].dims,
      (5e-4 + 2.5e-3 * rs.rand(*cshape)).astype(np.float32))
  paths = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    for name, ds in (("truth", truth), ("forecast", forecast),
                     ("climatology", clim)):
      paths[name] = os.path.join(tmp_dir, f"{name}.zarr")
      jxds.to_zarr(ds, paths[name])
  return paths


def data_config(paths, out_dir, time_slice=TIME_SLICE, variables=VARIABLES):
  """The reference ``config.Data`` over the stores (by init)."""
  return jconfig.Data(
      selection=jconfig.Selection(variables=list(variables),
                                  levels=[500, 700, 850],
                                  time_slice=time_slice),
      paths=jconfig.Paths(forecast=paths["forecast"], obs=paths["truth"],
                          climatology=paths["climatology"],
                          output_dir=str(out_dir)),
      by_init=True)


def sixteen_regions(paths) -> dict:
  """``scripts/evaluate.py``'s region list with the obs store's mask, in
  the reference package's classes."""
  mask = jxds.open_zarr(paths["truth"])["land_sea_mask"]
  et_lats = [slice(None, -20), slice(20, None)]
  regions = {
      name: SliceRegion(lat_slice=r.lat_slice, lon_slice=r.lon_slice)
      for name, r in cli.predefined_regions_dict().items()}
  lr = LandRegion(land_sea_mask=mask)
  regions["global_land"] = lr
  regions["extra-tropics_land"] = CombinedRegion(
      regions=[SliceRegion(lat_slice=et_lats), lr])
  regions["tropics_land"] = CombinedRegion(
      regions=[SliceRegion(lat_slice=slice(-20, 20)), lr])
  return regions


def official_configs(clim, regions, **baselines) -> dict:
  """The four deterministic configs as ``scripts/evaluate.py:233-295``
  builds them with ``--compute_seeps`` and the default wind pair, in the
  reference package's classes."""
  wind = lambda cls: [cls(u_name="u_component_of_wind",
                          v_name="v_component_of_wind",
                          vector_name="wind_vector")]
  seeps = dict(climatology=clim, precip_name=PRECIP, dry_threshold_mm=0.25)
  deterministic = {
      "mse": jmetrics.MSE(wind_vector_mse=wind(jmetrics.WindVectorMSE)),
      "acc": jmetrics.ACC(climatology=clim),
      "bias": jmetrics.Bias(),
      "mae": jmetrics.MAE(),
      "seeps_24hr": jmetrics.SEEPS(**seeps),
  }
  return {
      "deterministic": jconfig.Eval(metrics=deterministic, regions=regions,
                                    **baselines),
      "deterministic_spatial": jconfig.Eval(
          metrics={"bias": jmetrics.SpatialBias(),
                   "mse": jmetrics.SpatialMSE(),
                   "mae": jmetrics.SpatialMAE(),
                   "seeps_24hr": jmetrics.SpatialSEEPS(**seeps)},
          output_format="zarr", **baselines),
      "deterministic_temporal": jconfig.Eval(
          metrics={**deterministic,
                   "rmse_sqrt_before_time_avg": jmetrics.RMSESqrtBeforeTimeAvg(
                       wind_vector_rmse=wind(
                           jmetrics.WindVectorRMSESqrtBeforeTimeAvg))},
          regions=regions, temporal_mean=False, **baselines),
      "deterministic_vs_analysis": jconfig.Eval(
          metrics=deterministic, against_analysis=True, regions=regions),
  }


def assert_results_close(got, want, what, time_coords=True):
  """Labels equal and values within the tolerance.  Metrics are matched by
  name: the JAX package's per-time results come out of its jitted program
  in alphabetical metric order (jit sorts the keys of a dict it returns),
  the port keeps the config's order everywhere."""
  assert sorted(got.keys()) == sorted(want.keys()), what
  if "metric" in want.coords_dict():
    names = list(np.asarray(got.coords_dict()["metric"].data))
    wanted = list(np.asarray(want.coords_dict()["metric"].data))
    assert sorted(names) == sorted(wanted), what
    if names != wanted:
      got = got.isel(metric=np.asarray([names.index(n) for n in wanted]))
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
    gv = np.asarray(g.values, dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv),
                                  err_msg=f"{what}/{k} NaN pattern")
    np.testing.assert_allclose(gv, wv, rtol=RTOL,
                               atol=RTOL * np.nanmax(np.abs(wv)),
                               err_msg=f"{what}/{k}")


def run_port(dc, eval_configs, **kw):
  return evaluation.evaluate_with_mesh(
      convert.from_reference(dc),
      convert.eval_configs_from_reference(eval_configs), device="cpu", **kw)


def open_result(out_dir, name):
  """A config's results, NetCDF or (where the config says so) Zarr."""
  path = os.path.join(str(out_dir), name)
  if os.path.exists(path + ".zarr"):
    return jxds.open_zarr(path + ".zarr")
  return jxds.open_netcdf(path + ".nc")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_official")
  return tmp, build_stores(str(tmp))


# -- (a) metrics ---------------------------------------------------------------


def _chunk_pair(seed, with_valid_time=True):
  """A (forecast, truth) chunk with u, v and precipitation, NaNs included,
  as the reference package's and as the port's datasets."""
  rs = np.random.RandomState(seed)
  lat = np.linspace(-90, 90, 7)
  lon = np.linspace(0, 360, 12, endpoint=False)
  init = np.datetime64("2020-02-27", "ns") + np.arange(
      4) * np.timedelta64(12, "h")
  lead = np.arange(3) * np.timedelta64(1, "D")
  dims = ("init_time", "lead_time", "longitude", "latitude")
  shape = (4, 3, 12, 7)
  coords = {"init_time": init, "lead_time": lead.astype("timedelta64[ns]"),
            "longitude": lon, "latitude": lat}
  out = []
  for _ in range(2):
    arrays = {"u": rs.randn(*shape), "v": rs.randn(*shape),
              PRECIP: np.abs(rs.randn(*shape)) * 2e-3 * (
                  rs.rand(*shape) > 0.3)}
    arrays["u"][1, 2, 3, 4] = np.nan
    arrays[PRECIP][rs.rand(*shape) < 0.05] = np.nan
    out.append(arrays)
  valid = (("init_time", "lead_time"), init[:, None] + lead[None, :])
  pair = {}
  for tag in ("jax", "port"):
    dss = []
    for arrays in out:
      if tag == "jax":
        ds = jxds.Dataset({k: (dims, a) for k, a in arrays.items()},
                          coords=coords)
        if with_valid_time:
          ds = ds.assign_coords(valid_time=jxds.Variable(*valid))
      else:
        ds = convert.dataset_from_arrays(
            {k: (dims, a) for k, a in arrays.items()},
            {**coords, **({"valid_time": valid} if with_valid_time else {})})
      dss.append(ds)
    pair[tag] = dss
  return pair, lat, lon


def _seeps_climatology(seed, lat, lon):
  rs = np.random.RandomState(seed)
  dims = ("dayofyear", "hour", "longitude", "latitude")
  shape = (366, 2, len(lon), len(lat))
  base = rs.rand(len(lon), len(lat))
  arrays = {
      f"{PRECIP}_seeps_dry_fraction": np.clip(
          base + 0.02 * rs.randn(*shape), 0, 1),
      f"{PRECIP}_seeps_threshold": 5e-4 + 2.5e-3 * rs.rand(*shape)}
  coords = {"dayofyear": 1 + np.arange(366), "hour": np.array([0, 12]),
            "longitude": lon, "latitude": lat}
  return (jxds.Dataset({k: (dims, a) for k, a in arrays.items()},
                       coords=coords),
          convert.dataset_from_arrays(
              {k: (dims, a) for k, a in arrays.items()}, coords))


def _region_pair(lat, lon):
  rs = np.random.RandomState(5)
  lsm = rs.rand(len(lat), len(lon))
  from weatherbench2_torch import regions as pregions
  from weatherbench2_tpu import regions as jregions

  def make(mod, mod_xds):
    return mod.CombinedRegion(regions=[
        mod.SliceRegion(lat_slice=slice(-60, 60)),
        mod.LandRegion(land_sea_mask=mod_xds.DataArray(
            lsm, dims=("latitude", "longitude"),
            coords={"latitude": lat, "longitude": lon}))])
  return make(jregions, jxds), make(pregions, xds)


def _wind(mod, cls_name):
  return [getattr(mod, cls_name)(u_name="u", v_name="v", vector_name="wv")]


def _metric_pairs(jclim, pclim):
  """(name, reference metric, port metric) for every metric of the slice."""
  seeps = dict(precip_name=PRECIP, dry_threshold_mm=0.25)
  pairs = []
  for name, build in (
      ("WindVectorMSE", lambda m, c: m.WindVectorMSE("u", "v", "wv")),
      ("WindVectorRMSESqrtBeforeTimeAvg",
       lambda m, c: m.WindVectorRMSESqrtBeforeTimeAvg("u", "v", "wv")),
      ("MSE+wind", lambda m, c: m.MSE(
          wind_vector_mse=_wind(m, "WindVectorMSE"))),
      ("RMSE+wind", lambda m, c: m.RMSESqrtBeforeTimeAvg(
          wind_vector_rmse=_wind(m, "WindVectorRMSESqrtBeforeTimeAvg"))),
      ("SpatialMSE", lambda m, c: m.SpatialMSE()),
      ("SpatialMAE", lambda m, c: m.SpatialMAE()),
      ("SpatialBias", lambda m, c: m.SpatialBias()),
      ("SpatialSEEPS", lambda m, c: m.SpatialSEEPS(climatology=c, **seeps)),
      ("SEEPS", lambda m, c: m.SEEPS(climatology=c, **seeps)),
  ):
    pairs.append((name, build(jmetrics, jclim), build(metrics, pclim)))
  return pairs


def _as_dataset(result, name="value"):
  return result if hasattr(result, "keys") else result.to_dataset(name=name)


def _assert_same_values(got, want, what):
  got, want = _as_dataset(got), _as_dataset(want)
  assert list(got.keys()) == list(want.keys()), what
  for k in want.keys():
    assert got[k].dims == want[k].dims, f"{what}/{k}"
    np.testing.assert_allclose(
        np.asarray(got[k].values, np.float64),
        np.asarray(want[k].values, np.float64), rtol=1e-12, atol=1e-15,
        err_msg=f"{what}/{k}")


METRIC_NAMES = ["WindVectorMSE", "WindVectorRMSESqrtBeforeTimeAvg",
                "MSE+wind", "RMSE+wind", "SpatialMSE", "SpatialMAE",
                "SpatialBias", "SpatialSEEPS", "SEEPS"]


@pytest.mark.parametrize("skipna", [False, True])
@pytest.mark.parametrize("name", METRIC_NAMES)
def test_compute_chunk_matches(name, skipna):
  pair, lat, lon = _chunk_pair(3)
  jclim, pclim = _seeps_climatology(4, lat, lon)
  jregion, pregion = _region_pair(lat, lon)
  _, jm, pm = next(p for p in _metric_pairs(jclim, pclim) if p[0] == name)
  for jr, pr in ((None, None), (jregion, pregion)):
    want = jm.compute_chunk(*pair["jax"], region=jr, skipna=skipna)
    got = pm.compute_chunk(*pair["port"], region=pr, skipna=skipna)
    _assert_same_values(got, want, f"{name} region={jr is not None}")
    # and on tensors, as the engine calls it
    tensors = [xds.to_device(ds, torch.device("cpu")) for ds in pair["port"]]
    got_t = pm.compute_chunk(*tensors, region=pr, skipna=skipna)
    _assert_same_values(got_t, want, f"{name} tensors")


@pytest.mark.parametrize("name", ["MSE+wind", "RMSE+wind", "SEEPS"])
def test_pointwise_chunk_matches(name):
  pair, lat, lon = _chunk_pair(6)
  jclim, pclim = _seeps_climatology(7, lat, lon)
  _, jm, pm = next(p for p in _metric_pairs(jclim, pclim) if p[0] == name)
  want = jm.pointwise_chunk(*pair["jax"], jm.prepare_chunk(*pair["jax"]),
                            False)
  got = pm.pointwise_chunk(*pair["port"], pm.prepare_chunk(*pair["port"]),
                           False)
  _assert_same_values(got, want, name)
  if name == "SEEPS":
    # NaN where precipitation is NaN and where p1 is outside the mask
    p1 = pm.p1.values
    outside = (p1 <= pm.min_p1) | (p1 >= pm.max_p1)
    assert outside.any() and not outside.all()
    values = got[PRECIP].values
    assert np.isnan(values[..., outside]).all()
    inside_nan = np.isnan(values[..., ~outside])
    data_nan = (np.isnan(pair["port"][0][PRECIP].values)
                | np.isnan(pair["port"][1][PRECIP].values))[..., ~outside]
    np.testing.assert_array_equal(inside_nan, data_nan)
    assert pm.fused_nan_mode == jm.fused_nan_mode == "skip"
  else:
    assert "wv" in got.keys()
    assert pm.fused_nan_mode == jm.fused_nan_mode == "global"


@pytest.mark.parametrize("name", ["MSE+wind", "RMSE+wind", "SEEPS"])
def test_pointwise_chunk_declines_without_its_variables(name):
  """A wind pair whose component is missing, or a missing precipitation
  variable, declines the pointwise tier on both sides."""
  pair, lat, lon = _chunk_pair(8)
  jclim, pclim = _seeps_climatology(9, lat, lon)
  _, jm, pm = next(p for p in _metric_pairs(jclim, pclim) if p[0] == name)
  keep = ["u", PRECIP] if name != "SEEPS" else ["u", "v"]
  jf, jt = (ds[keep] for ds in pair["jax"])
  pf, pt = (ds[keep] for ds in pair["port"])
  prepared_j = None if name != "SEEPS" else jm.prepare_chunk(*pair["jax"])
  prepared_p = None if name != "SEEPS" else pm.prepare_chunk(*pair["port"])
  assert jm.pointwise_chunk(jf, jt, prepared_j, False) is None
  assert pm.pointwise_chunk(pf, pt, prepared_p, False) is None


def test_seeps_compact_truth_branch_matches():
  """``prepare_chunk`` on the deduplicated truth of a streaming chunk (a
  1-d time axis of unique valid times, the leap day among them) gathers
  one threshold row per unique time, as the reference does."""
  pair, lat, lon = _chunk_pair(10)
  jclim, pclim = _seeps_climatology(11, lat, lon)
  jm = jmetrics.SEEPS(climatology=jclim, precip_name=PRECIP)
  pm = metrics.SEEPS(climatology=pclim, precip_name=PRECIP)
  times = np.unique(np.asarray(pair["port"][0]["valid_time"].values))
  assert np.datetime64("2020-02-29") in times.astype("datetime64[D]")
  shape = (len(times), 12, 7)
  data = np.random.RandomState(1).rand(*shape)
  dims = ("time", "longitude", "latitude")
  coords = {"time": times, "longitude": lon, "latitude": lat}
  want = jm.prepare_chunk(
      pair["jax"][0], jxds.Dataset({PRECIP: (dims, data)}, coords=coords))
  got = pm.prepare_chunk(
      pair["port"][0],
      convert.dataset_from_arrays({PRECIP: (dims, data)}, coords))
  assert got["wet"].dims == want["wet"].dims == dims
  np.testing.assert_array_equal(got["wet"].values, want["wet"].values)
  np.testing.assert_allclose(got["p1"].values, want["p1"].values,
                             rtol=1e-12)


def test_metric_compute_takes_the_time_mean():
  pair, _, _ = _chunk_pair(12)
  want = jmetrics.MSE().compute(*pair["jax"], skipna=True)
  got = metrics.MSE().compute(*pair["port"], skipna=True)
  _assert_same_values(got, want, "MSE.compute")
  assert "init_time" not in got["u"].dims
  no_time = pair["port"][0].isel(init_time=0, drop=True)
  with pytest.raises(ValueError, match="neither time nor init_time"):
    metrics.MSE().compute(no_time, no_time)


def test_base_class_protocol_defaults():
  assert metrics.Metric.supports_jit is True
  assert metrics.Metric.fused_nan_mode == "global"
  assert metrics.Metric.supports_pointwise_fused is False
  for cls in (metrics.SpatialMSE, metrics.SpatialMAE, metrics.SpatialBias,
              metrics.SpatialSEEPS, metrics.WindVectorMSE):
    assert not cls.supports_pointwise_fused
  assert not hasattr(metrics, "_no_wind_vectors")


# -- (b) golden ----------------------------------------------------------------


@pytest.fixture(scope="module")
def golden_stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_golden_spatial")
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    return tmp, common.build_inputs(str(tmp))


@pytest.mark.parametrize("engine", ["streaming", "streaming_chunks4",
                                    "in_memory"])
def test_port_reproduces_golden_deterministic_spatial(golden_stores, engine):
  tmp, paths = golden_stores
  clim = jxds.open_zarr(paths["climatology"])
  name = "deterministic_spatial"
  cfg = {name: common.eval_configs(clim)[name]}
  dc = jconfig.Data(
      selection=jconfig.Selection(
          variables=["geopotential", "2m_temperature"], levels=[500, 850],
          time_slice=slice("2020-01-01", "2020-01-15")),
      paths=jconfig.Paths(forecast=paths["forecast"], obs=paths["truth"],
                          climatology=paths["climatology"],
                          output_dir=str(tmp / engine)),
      by_init=True)
  if engine == "in_memory":
    evaluation.evaluate_in_memory(
        convert.from_reference(dc),
        convert.eval_configs_from_reference(cfg), device="cpu")
  else:
    chunks = {"init_time": 4} if engine.endswith("4") else {}
    stats = run_port(dc, cfg, input_chunks=chunks)
    assert stats["chunks"] == (4 if chunks else 1)
  got = open_result(tmp / engine, name)
  want = jxds.open_netcdf(os.path.join(GOLDEN_DIR, f"{name}.nc"))
  # the goldens' lead_time labels read back 1000x too small here (a
  # reference-side encoding quirk): data and the other labels are compared
  assert_results_close(got, want, engine, time_coords=False)


# -- (c) the four configs ------------------------------------------------------


CASES = {"regions": (True, False), "regions_skipna": (True, True),
         "no_regions": (False, False)}
CONFIG_NAMES = ["deterministic", "deterministic_spatial",
                "deterministic_temporal", "deterministic_vs_analysis"]


@pytest.fixture(scope="module")
def official_runs(stores):
  """{case: {engine: {config: results}}} for the port's streaming engine
  (chunks of 4 inits), its in-memory engine and the JAX package's
  streaming engine."""
  tmp, paths = stores
  clim = jxds.open_zarr(paths["climatology"])
  runs = {}
  for case, (with_regions, skipna) in CASES.items():
    regions = sixteen_regions(paths) if with_regions else None
    cfgs = official_configs(clim, regions)
    runs[case] = {}
    for engine in ("port", "port_memory", "jax"):
      out = tmp / f"{case}_{engine}"
      dc = data_config(paths, out)
      if engine == "port":
        runs[case]["stats"] = run_port(dc, cfgs, skipna=skipna,
                                       input_chunks={"init_time": 4})
      elif engine == "port_memory":
        evaluation.evaluate_in_memory(
            convert.from_reference(dc),
            convert.eval_configs_from_reference(cfgs), skipna=skipna,
            device="cpu")
      else:
        jevaluation.evaluate_with_mesh(dc, cfgs, skipna=skipna,
                                       input_chunks={"init_time": 4})
      runs[case][engine] = {name: open_result(out, name) for name in cfgs}
      # the streaming engines write the spatial config as Zarr
      assert os.path.exists(out / "deterministic_spatial.zarr") == (
          engine != "port_memory")
  return runs


@pytest.mark.parametrize("name", CONFIG_NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_streaming_matches_jax(official_runs, case, name):
  got = official_runs[case]["port"][name]
  want = official_runs[case]["jax"][name]
  assert_results_close(got, want, f"{case}/{name}")
  if name != "deterministic_spatial":
    assert "wind_vector" in got.keys()
    metric_names = list(np.asarray(got.coords_dict()["metric"].data))
    assert metric_names[:5] == ["mse", "acc", "bias", "mae", "seeps_24hr"]
  if CASES[case][0] and name != "deterministic_spatial":
    assert got.sizes["region"] == 16
  else:
    assert "region" not in got.sizes
  if name == "deterministic_temporal":
    assert got.sizes["init_time"] == 16
    # a divergence kept on purpose: the reference's per-time results list
    # their metrics alphabetically, the port in the config's order
    assert list(np.asarray(want.coords_dict()["metric"].data)) == sorted(
        metric_names)
    assert metric_names[5] == "rmse_sqrt_before_time_avg"


@pytest.mark.parametrize("name", CONFIG_NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_streaming_matches_in_memory(official_runs, case, name):
  assert_results_close(official_runs[case]["port"][name],
                       official_runs[case]["port_memory"][name],
                       f"{case}/{name}")


def test_official_run_streams_two_groups(official_runs):
  # 16 inits in chunks of 4, once for the three configs that share their
  # inputs and once for deterministic_vs_analysis
  assert official_runs["regions"]["stats"]["chunks"] == 8


def test_seeps_ignores_skipna(official_runs):
  """SEEPS is ``sums / wsum_valid`` whatever ``skipna`` says: the p1 mask
  and NaN precipitation never poison a regional mean."""
  for name in ("deterministic", "deterministic_temporal"):
    off = official_runs["regions"]["port"][name]
    on = official_runs["regions_skipna"]["port"][name]
    i = list(np.asarray(off.coords_dict()["metric"].data)).index(
        "seeps_24hr")
    a = off[PRECIP].isel(metric=i).values
    b = on[PRECIP].isel(metric=i).values
    # (a region whose every cell is outside the p1 mask has no SEEPS)
    assert np.isfinite(a).mean() > 0.5
    glob = list(np.asarray(off.coords_dict()["region"].data)).index("global")
    assert np.isfinite(off[PRECIP].isel(metric=i, region=glob).values).all()
    np.testing.assert_array_equal(a, b)
    # while mse of the same variable is poisoned by its NaN cells
    j = list(np.asarray(off.coords_dict()["metric"].data)).index("mse")
    poisoned = np.isnan(off[PRECIP].isel(metric=j).values).mean()
    assert poisoned > 0.1
    assert np.isnan(on[PRECIP].isel(metric=j).values).mean() < poisoned / 5


# -- (d) tiers, lead chunks, baselines, host metrics -------------------------------


@dataclasses.dataclass
class LoopMSE(metrics.MSE):
  """MSE kept out of both fused tiers."""
  supports_pointwise_fused = False


@dataclasses.dataclass
class LoopACC(metrics.ACC):
  supports_pointwise_fused = False


@dataclasses.dataclass
class LoopSEEPS(metrics.SEEPS):
  supports_pointwise_fused = False


@dataclasses.dataclass
class HostMAE(metrics.MAE):
  """A metric that must see numpy chunks on the host."""
  supports_jit = False
  supports_pointwise_fused = False

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    for ds in (forecast, truth):
      assert all(isinstance(v.data, np.ndarray)
                 for v in ds.variables_dict().values())
    return super().compute_chunk(forecast, truth, region, skipna)


def _port_suite(paths, out_dir, suite, regions=True, **eval_kwargs):
  dc = convert.from_reference(data_config(paths, out_dir))
  port_regions = (convert.from_reference(sixteen_regions(paths))
                  if regions else None)
  return dc, {"d": config.Eval(metrics=suite, regions=port_regions,
                               **eval_kwargs)}


@pytest.mark.parametrize("skipna", [False, True])
def test_unfused_loop_equals_fused_tiers(stores, skipna):
  tmp, paths = stores
  clim = convert.from_reference(jxds.open_zarr(paths["climatology"]))
  wind = [metrics.WindVectorMSE("u_component_of_wind",
                                "v_component_of_wind", "wind_vector")]
  seeps = dict(climatology=clim, precip_name=PRECIP)
  suites = {
      "fused": {"mse": metrics.MSE(wind_vector_mse=wind),
                "acc": metrics.ACC(climatology=clim),
                "seeps": metrics.SEEPS(**seeps)},
      "loop": {"mse": LoopMSE(wind_vector_mse=wind),
               "acc": LoopACC(climatology=clim),
               "seeps": LoopSEEPS(**seeps)}}
  results = {}
  for tag, suite in suites.items():
    out = tmp / f"tiers_{tag}_{skipna}"
    dc, cfgs = _port_suite(paths, out, suite)
    plans = streaming._partition_fused(
        suite, cfgs["d"].regions,
        evaluation.open_forecast_and_truth_datasets(dc, cfgs["d"],
                                                    lazy=True)[0])
    assert list(plans[3]) == ([] if tag == "fused" else list(suite))
    evaluation.evaluate_with_mesh(dc, cfgs, device="cpu", skipna=skipna,
                                  input_chunks={"init_time": 8})
    results[tag] = open_result(out, "d")
  assert_results_close(results["loop"], results["fused"], "loop vs fused")


@pytest.mark.parametrize("lead_chunk", [2, 3, 7])
def test_lead_time_chunks_equal_unchunked(stores, official_runs, lead_chunk):
  """7 leads in slices of 2 (ragged), 3 (ragged) and 7 (one slice)."""
  tmp, paths = stores
  clim = jxds.open_zarr(paths["climatology"])
  cfgs = official_configs(clim, sixteen_regions(paths))
  del cfgs["deterministic_vs_analysis"]
  out = tmp / f"lead{lead_chunk}"
  stats = run_port(data_config(paths, out), cfgs,
                   input_chunks={"init_time": 4, "lead_time": lead_chunk})
  assert stats["chunks"] == 4 * -(-7 // lead_chunk)
  for name in cfgs:
    got = open_result(out, name)
    assert_results_close(got, official_runs["regions"]["port"][name],
                         f"lead chunks vs unchunked, {name}")
    assert_results_close(got, official_runs["regions"]["jax"][name],
                         f"lead chunks vs jax, {name}")


def test_lead_time_chunks_match_jax_lead_chunks(stores):
  tmp, paths = stores
  clim = jxds.open_zarr(paths["climatology"])
  cfgs = {"deterministic": official_configs(
      clim, sixteen_regions(paths))["deterministic"]}
  chunks = {"init_time": 8, "lead_time": 3}
  run_port(data_config(paths, tmp / "lead_port"), cfgs, input_chunks=chunks)
  jevaluation.evaluate_with_mesh(data_config(paths, tmp / "lead_jax"), cfgs,
                                 input_chunks=chunks)
  assert_results_close(open_result(tmp / "lead_port", "deterministic"),
                       open_result(tmp / "lead_jax", "deterministic"),
                       "lead chunks")


@pytest.mark.parametrize("baseline", ["evaluate_persistence",
                                      "evaluate_climatology"])
def test_baselines_match_jax(stores, baseline):
  tmp, paths = stores
  clim = jxds.open_zarr(paths["climatology"])
  variables = VARIABLES[:4]  # the climatology forecast has no NaNs to offer
  regions = sixteen_regions(paths)
  wind = [jmetrics.WindVectorMSE("u_component_of_wind",
                                 "v_component_of_wind", "wind_vector")]
  cfgs = {
      "deterministic": jconfig.Eval(
          metrics={"mse": jmetrics.MSE(wind_vector_mse=wind),
                   "acc": jmetrics.ACC(climatology=clim),
                   "bias": jmetrics.Bias()},
          regions=regions, **{baseline: True}),
      "deterministic_spatial": jconfig.Eval(
          metrics={"mae": jmetrics.SpatialMAE()}, **{baseline: True}),
  }
  outs = {}
  for engine in ("port", "port_memory", "jax"):
    out = tmp / f"{baseline}_{engine}"
    dc = data_config(paths, out, variables=variables)
    if engine == "port":
      run_port(dc, cfgs, input_chunks={"init_time": 4})
    elif engine == "port_memory":
      evaluation.evaluate_in_memory(
          convert.from_reference(dc),
          convert.eval_configs_from_reference(cfgs), device="cpu")
    else:
      jevaluation.evaluate_with_mesh(dc, cfgs, input_chunks={"init_time": 4})
    outs[engine] = {name: open_result(out, name) for name in cfgs}
  for name in cfgs:
    assert_results_close(outs["port"][name], outs["jax"][name],
                         f"{baseline}/{name} streaming")
    assert_results_close(outs["port_memory"][name], outs["jax"][name],
                         f"{baseline}/{name} in memory")
  if baseline == "evaluate_persistence":
    # persistence is the truth at lead 0
    mse0 = outs["port"]["deterministic"]["geopotential"].isel(
        metric=0, lead_time=0).values
    np.testing.assert_array_equal(mse0, 0.0)


def test_by_valid_persistence_matches_jax(stores):
  """The by-valid persistence forecast (in memory only: the streaming
  engine refuses it, as the reference's does)."""
  tmp, paths = stores
  cfgs = {"d": jconfig.Eval(metrics={"mse": jmetrics.MSE()},
                            regions={"global": SliceRegion()},
                            evaluate_persistence=True)}
  outs = {}
  for engine in ("port", "jax"):
    dc = data_config(paths, tmp / f"by_valid_persistence_{engine}",
                     time_slice=slice("2020-02-24", "2020-03-03"),
                     variables=VARIABLES[:4])
    dc.by_init = False
    if engine == "port":
      evaluation.evaluate_in_memory(
          convert.from_reference(dc),
          convert.eval_configs_from_reference(cfgs), device="cpu")
      with pytest.raises(ValueError, match="by-init"):
        run_port(dc, cfgs, input_chunks={"time": 4})
    else:
      jevaluation.evaluate_in_memory(dc, cfgs)
    outs[engine] = open_result(tmp / f"by_valid_persistence_{engine}", "d")
  assert_results_close(outs["port"], outs["jax"], "by-valid persistence")


def test_probabilistic_climatology_baseline_validates_its_years():
  """The baseline runs (tests/test_torch_derived_eval.py); without its
  years it is refused as the JAX package refuses it."""
  config.Eval(metrics={}, evaluate_probabilistic_climatology=True,
              probabilistic_climatology_start_year=1990,
              probabilistic_climatology_end_year=2000).validate()
  for missing in ("start", "end"):
    kwargs = {"probabilistic_climatology_start_year": 1990,
              "probabilistic_climatology_end_year": 2000}
    del kwargs[f"probabilistic_climatology_{missing}_year"]
    for cls in (config.Eval, jconfig.Eval):
      with pytest.raises(ValueError, match="start and end years"):
        cls(metrics={}, evaluate_probabilistic_climatology=True,
            **kwargs).validate()
  config.Eval(metrics={}, evaluate_persistence=True).validate()
  config.Eval(metrics={}, evaluate_climatology=True).validate()


@pytest.mark.parametrize("temporal_mean", [True, False])
@pytest.mark.parametrize("skipna", [False, True])
def test_host_metric_runs_on_numpy_chunks(stores, skipna, temporal_mean):
  tmp, paths = stores
  outs = {}
  for tag, suite in (("host", {"mae": HostMAE(), "mse": metrics.MSE()}),
                     ("device", {"mae": metrics.MAE(),
                                 "mse": metrics.MSE()})):
    out = tmp / f"host_metric_{tag}_{skipna}_{temporal_mean}"
    dc, cfgs = _port_suite(paths, out, suite, temporal_mean=temporal_mean)
    stats = evaluation.evaluate_with_mesh(
        dc, cfgs, device="cpu", skipna=skipna, input_chunks={"init_time": 6})
    outs[tag] = (open_result(out, "d"), stats)
  assert_results_close(outs["host"][0], outs["device"][0], "host metric")
  # a host metric switches the truth dedup off: the chunk-shaped truth
  # crosses instead of its unique times
  assert outs["host"][1]["h2d_bytes"] > outs["device"][1]["h2d_bytes"]


def test_host_metric_matches_jax_host_metric(stores):
  tmp, paths = stores

  @dataclasses.dataclass
  class JaxHostMAE(jmetrics.MAE):
    supports_jit = False
    supports_pointwise_fused = False

  regions = {"global": SliceRegion(),
             "tropics": SliceRegion(lat_slice=slice(-20, 20))}
  out_j = tmp / "host_metric_jax"
  jevaluation.evaluate_with_mesh(
      data_config(paths, out_j),
      {"d": jconfig.Eval(metrics={"mae": JaxHostMAE()}, regions=regions)},
      input_chunks={"init_time": 6})
  out_p = tmp / "host_metric_port"
  evaluation.evaluate_with_mesh(
      convert.from_reference(data_config(paths, out_p)),
      {"d": config.Eval(metrics={"mae": HostMAE()},
                        regions=convert.from_reference(regions))},
      device="cpu", input_chunks={"init_time": 6})
  assert_results_close(open_result(out_p, "d"), open_result(out_j, "d"),
                       "host metric vs jax")


def test_result_without_chunk_dim_counts_once():
  """``_masked_sum_count`` on a result that does not depend on time."""
  result = xds.Dataset({"v": (("region",), torch.tensor([1.0, 2.0]))})
  mask = torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64)
  s, c = streaming._masked_sum_count(result, "init_time", mask, False)
  np.testing.assert_array_equal(s["v"].values, [1.0, 2.0])
  np.testing.assert_array_equal(c["v"].values, [1.0, 1.0])


# -- (e) the repaired faults -------------------------------------------------------


def test_wind_vector_metrics_leave_the_deterministic_kernel():
  """``_det_stat_of`` follows the reference: MSE and RMSE WITH wind vectors
  are pointwise-tier metrics."""
  wind = [metrics.WindVectorMSE("u", "v", "wv")]
  jwind = [jmetrics.WindVectorMSE("u", "v", "wv")]
  for port, ref in (
      (metrics.MSE(), jmetrics.MSE()),
      (metrics.MSE(wind_vector_mse=wind), jmetrics.MSE(wind_vector_mse=jwind)),
      (metrics.MSE(wind_vector_mse=[]), jmetrics.MSE(wind_vector_mse=[])),
      (metrics.RMSESqrtBeforeTimeAvg(), jmetrics.RMSESqrtBeforeTimeAvg()),
      (metrics.RMSESqrtBeforeTimeAvg(wind_vector_rmse=wind),
       jmetrics.RMSESqrtBeforeTimeAvg(wind_vector_rmse=jwind)),
      (metrics.MAE(), jmetrics.MAE()), (metrics.Bias(), jmetrics.Bias()),
      (metrics.SpatialMSE(), jmetrics.SpatialMSE()),
      (LoopMSE(), None)):
    want = jstreaming._det_stat_of(ref) if ref is not None else None
    assert streaming._det_stat_of(port) == want, port
  assert streaming._det_stat_of(metrics.MSE(wind_vector_mse=wind)) is None


@dataclasses.dataclass
class SkipNaNField(metrics.Metric):
  """f - t as a pointwise field under either NaN mode."""
  supports_pointwise_fused = True

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    return forecast - truth


@dataclasses.dataclass
class AlwaysSkip(SkipNaNField):
  fused_nan_mode = "skip"


@pytest.mark.parametrize("skipna", [False, True])
def test_pointwise_tier_honours_fused_nan_mode(skipna):
  lat = np.linspace(-90, 90, 7)
  lon = np.linspace(0, 360, 12, endpoint=False)
  rs = np.random.RandomState(0)
  f = rs.randn(3, 12, 7).astype(np.float32)
  f[1, 4, 3] = np.nan
  dims = ("init_time", "longitude", "latitude")
  coords = {"init_time": np.arange(3), "longitude": lon, "latitude": lat}
  f_c = xds.to_device(convert.dataset_from_arrays({"x": (dims, f)}, coords),
                      torch.device("cpu"))
  t_c = xds.to_device(convert.dataset_from_arrays(
      {"x": (dims, np.zeros_like(f))}, coords), torch.device("cpu"))
  suite = {"global": SkipNaNField(), "skip": AlwaysSkip()}
  from weatherbench2_torch.regions import SliceRegion as PortSlice
  _, _, plan, rest = streaming._partition_fused(
      suite, {"all": PortSlice(), "north": PortSlice(
          lat_slice=slice(50, 90))}, f_c)
  assert not rest
  plan["region_w_dev"] = torch.as_tensor(plan["region_w"])
  results, leftover = streaming._pointwise_chunk_results(
      plan, suite, f_c, t_c, {"global": None, "skip": None}, skipna)
  assert leftover == []
  glob = results["global"]["x"].values  # (region, init_time)
  skip = results["skip"]["x"].values
  assert np.isfinite(skip).all()
  # the NaN cell (latitude 0) lies in "all" only
  assert np.isnan(glob[0, 1]) == (not skipna)
  assert np.isfinite(np.delete(glob.ravel(), 1)).all()
  np.testing.assert_array_equal(np.delete(glob.ravel(), 1),
                                np.delete(skip.ravel(), 1))
  want = np.nansum(f[1] * plan["region_w"][0].reshape(12, 7)) / (
      plan["region_w"][0].sum() - plan["region_w"][0].reshape(12, 7)[4, 3])
  np.testing.assert_allclose(skip[0, 1], want, rtol=1e-5)


def test_configs_that_differ_in_baselines_do_not_share_a_stream(stores):
  tmp, paths = stores
  regions = {"global": SliceRegion()}
  mk = lambda **kw: jconfig.Eval(metrics={"mse": jmetrics.MSE()},
                                 regions=regions, **kw)
  cfgs = {"forecast": mk(), "persistence": mk(evaluate_persistence=True),
          "forecast_too": mk()}
  stats = run_port(data_config(paths, tmp / "groups"), cfgs,
                   input_chunks={"init_time": 8})
  assert stats["chunks"] == 4  # two groups of two chunks
  outs = {name: open_result(tmp / "groups", name) for name in cfgs}
  for name in ("forecast", "persistence"):
    run_port(data_config(paths, tmp / f"groups_{name}"),
             {name: cfgs[name]}, input_chunks={"init_time": 8})
    alone = open_result(tmp / f"groups_{name}", name)
    for k in alone.keys():
      np.testing.assert_array_equal(outs[name][k].values, alone[k].values)
  np.testing.assert_array_equal(outs["forecast"]["geopotential"].values,
                                outs["forecast_too"]["geopotential"].values)
  assert not np.allclose(outs["forecast"]["geopotential"].values,
                         outs["persistence"]["geopotential"].values)
  keys = {streaming.input_key(convert.from_reference(c))
          for c in cfgs.values()}
  assert len(keys) == 2
  # and the engine itself refuses a mixed group
  dc = convert.from_reference(data_config(paths, tmp / "mixed"))
  port_cfgs = convert.eval_configs_from_reference(cfgs)
  forecast, truth, clim = evaluation.open_forecast_and_truth_datasets(
      dc, port_cfgs["forecast"], lazy=True)
  with pytest.raises(ValueError, match="identical input construction"):
    streaming.evaluate_streaming_multi(
        forecast, truth, clim, port_cfgs, dc, {"init_time": 8},
        device="cpu")

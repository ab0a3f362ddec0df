"""Derived variables and the probabilistic-climatology baseline through the
port's engines, against the JAX package's, on the CPU.

Stores are made from seeds with the JAX package's factories at 30 degrees
(12 x 7 cells), written uncompressed: wind components at two levels, 2 m
temperature and a forecast ``total_precipitation`` that accumulates along
the lead axis (6-hourly leads to 2 days, with small decreases that the
accumulation clamps), 6-hourly truth and an hourly climatology at 6-hour
steps that holds the derived variables too.  Each case runs the same
config through the JAX package's ``evaluate_with_mesh`` or
``evaluate_in_memory`` and through its counterpart in the port:

  * ``wind_speed`` and ``total_precipitation_24hr`` (a lead-core derived
    variable: full lead axis, no truth dedup) with MSE/Bias/MAE/ACC and
    three regions, in both engines;
  * the lead-chunk guard, and the truth-dedup gate;
  * the probabilistic climatology (years as members) in both engines, as
    ``tests/test_eval_configs.py`` sets it up (2018-2019, hour interval 24),
    with the probabilistic config's six metrics and three regions;
  * day 366: a leap year's member and NaN for the other years;
  * configs split into two streams by a differently defined derived
    variable of the same name;
  * a run with derived variables that the JAX package began, finished by
    the port from the state file.

Tolerance, as in ``tests/test_torch_evaluation.py``: ``rtol=1e-5`` plus
``atol=1e-5 x max|reference|`` per variable (float32 sums on the port's
side, float64 on the JAX package's under the tests' x64), NaNs in the same
places.
"""
import os

import numpy as np
import pytest

from tests.test_torch_official_configs import (assert_results_close,
                                               open_result, run_port)
from weatherbench2_tpu import config as jconfig
from weatherbench2_tpu import derived_variables as jdv
from weatherbench2_tpu import evaluation as jevaluation
from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import regions as jregions
from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import utils as jutils
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.parallel import streaming as jstreaming
from weatherbench2_torch import convert
from weatherbench2_torch import evaluation
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.parallel import streaming

WIND = ["u_component_of_wind", "v_component_of_wind"]
WIND_10M = ["10m_u_component_of_wind", "10m_v_component_of_wind"]
TP = "total_precipitation"
TIME_SLICE = slice("2020-01-01", "2020-01-04T12")  # 8 12-hourly inits


def _write(paths, tmp_dir, **datasets):
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    for name, ds in datasets.items():
      paths[name] = os.path.join(tmp_dir, f"{name}.zarr")
      jxds.to_zarr(ds, paths[name])
  return paths


def build_stores(tmp_dir: str) -> dict:
  """Fixed-seed truth, forecast and climatology stores; {name: path}."""
  kwargs = dict(variables_3d=WIND + ["geopotential"],
                variables_2d=["2m_temperature", TP] + WIND_10M,
                levels=(500, 850), spatial_resolution_in_degrees=30.0)
  truth = jutils.random_like(jschema.mock_truth_data(
      time_start="2020-01-01", time_stop="2020-01-08",
      time_resolution="6 hours", **kwargs), seed=31)
  forecast = jutils.random_like(jschema.mock_forecast_data(
      time_start="2020-01-01", time_stop="2020-01-05",
      time_resolution="12 hours", lead_stop="2 days",
      lead_resolution="6 hours", **kwargs), seed=32)
  # accumulated precipitation: non-negative steps along the lead axis, a
  # few slightly negative (the accumulation clamps those to zero)
  rs = np.random.RandomState(33)
  steps = np.abs(rs.randn(*forecast[TP].shape)) * 1e-3
  steps[rs.rand(*steps.shape) < 0.05] *= -0.01
  ax = forecast[TP].dims.index("prediction_timedelta")
  forecast = forecast.copy(data={TP: np.cumsum(steps, axis=ax)})
  truth = truth.copy(data={TP: np.abs(truth[TP].values) * 1e-3})
  clim = jutils.random_like(jschema.mock_hourly_climatology_data(
      hour_interval=6, **dict(
          kwargs, variables_3d=WIND + ["geopotential", "wind_speed"],
          variables_2d=["2m_temperature", TP, "total_precipitation_24hr",
                        "10m_wind_speed"] + WIND_10M)), seed=34)
  return _write({}, tmp_dir, truth=truth, forecast=forecast,
                climatology=clim)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_derived")
  return tmp, build_stores(str(tmp))


def _regions():
  return {"global": jregions.SliceRegion(),
          "tropics": jregions.SliceRegion(lat_slice=slice(-20, 20)),
          "extra-tropics": jregions.ExtraTropicalRegion()}


def _data_config(paths, out_dir, variables=("2m_temperature",),
                 time_slice=TIME_SLICE, by_init=True):
  return jconfig.Data(
      selection=jconfig.Selection(variables=list(variables),
                                  levels=[500, 850], time_slice=time_slice),
      paths=jconfig.Paths(forecast=paths["forecast"], obs=paths["truth"],
                          climatology=paths.get("climatology"),
                          output_dir=str(out_dir)),
      by_init=by_init)


def _derived(*names):
  return {n: jdv.DERIVED_VARIABLE_DICT[n] for n in names}


def _det_configs(paths, names=("wind_speed", "total_precipitation_24hr"),
                 regions=True):
  clim = jxds.open_zarr(paths["climatology"])
  return {"d": jconfig.Eval(
      metrics={"mse": jmetrics.MSE(), "bias": jmetrics.Bias(),
               "mae": jmetrics.MAE(), "acc": jmetrics.ACC(climatology=clim)},
      regions=_regions() if regions else None,
      derived_variables=_derived(*names))}


@pytest.mark.parametrize("engine", ["mesh", "memory"])
def test_derived_variables_match_the_jax_package(stores, engine):
  """wind_speed and a 24 h precipitation accumulation, with the base
  variables the selection gains."""
  tmp, paths = stores
  cfgs = _det_configs(paths)
  out = {}
  for side in ("jax", "port"):
    dc = _data_config(paths, tmp / f"det_{engine}_{side}")
    if side == "jax" and engine == "mesh":
      jevaluation.evaluate_with_mesh(dc, cfgs, input_chunks={"init_time": 4})
    elif side == "jax":
      jevaluation.evaluate_in_memory(dc, cfgs)
    elif engine == "mesh":
      stats = run_port(dc, cfgs, input_chunks={"init_time": 4})
      assert stats["chunks"] == 2
    else:
      evaluation.evaluate_in_memory(
          convert.from_reference(dc), convert.eval_configs_from_reference(cfgs),
          device="cpu")
    out[side] = open_result(tmp / f"det_{engine}_{side}", "d")
  assert_results_close(out["port"], out["jax"], engine)
  assert sorted(out["port"].keys()) == sorted(
      ["2m_temperature", TP, *WIND, "wind_speed", "total_precipitation_24hr"])
  tp24 = out["port"]["total_precipitation_24hr"]
  lead = list(np.asarray(tp24.coords_dict()["lead_time"].data))
  # NaN at the first lead, finite from the one that closes the first 24 h
  assert np.isnan(tp24.isel(metric=0, lead_time=0).values).all()
  assert np.isfinite(tp24.isel(
      metric=0, lead_time=lead.index(np.timedelta64(1, "D"))).values).all()


def test_add_base_variables_keeps_the_jax_order():
  dc = jconfig.Data(
      selection=jconfig.Selection(variables=["z", "u_component_of_wind"],
                                  time_slice=slice(None)),
      paths=jconfig.Paths(forecast="f", obs="o", output_dir="x"))
  cfg = jconfig.Eval(metrics={}, derived_variables=_derived(
      "ageostrophic_wind_speed", "wind_speed", "relative_humidity"))
  want = jevaluation._add_base_variables(dc, cfg).selection.variables
  got = evaluation._add_base_variables(
      convert.from_reference(dc),
      convert.eval_configs_from_reference({"c": cfg})["c"]
  ).selection.variables
  assert got == want == ["z", "u_component_of_wind", "geopotential",
                         "v_component_of_wind", "level",
                         "specific_humidity", "temperature"]


def test_lead_chunks_refuse_lead_core_derived_variables(stores):
  tmp, paths = stores
  dc = _data_config(paths, tmp / "lead_guard")
  with pytest.raises(ValueError, match="full lead_time"):
    run_port(dc, _det_configs(paths),
             input_chunks={"init_time": 4, "lead_time": 3})
  # wind_speed alone streams in lead slices, equal to the unsliced run
  cfgs = _det_configs(paths, names=("wind_speed",))
  for tag, chunks in (("sliced", {"init_time": 4, "lead_time": 3}),
                      ("whole", {"init_time": 4})):
    run_port(_data_config(paths, tmp / f"lead_{tag}"), cfgs,
             input_chunks=chunks)
  assert_results_close(open_result(tmp / "lead_sliced", "d"),
                       open_result(tmp / "lead_whole", "d"), "lead slices")


@pytest.mark.parametrize("names,dedup", [
    (("wind_speed",), True),
    (("wind_speed", "total_precipitation_24hr"), False)])
def test_truth_dedup_gate(stores, monkeypatch, names, dedup):
  """The truth crosses once per distinct valid time unless a derived
  variable needs the lead axis on the truth too."""
  tmp, paths = stores
  seen = []
  real = streaming._rename_utime
  monkeypatch.setattr(streaming, "_rename_utime",
                      lambda obj: seen.append(1) or real(obj))
  run_port(_data_config(paths, tmp / f"dedup_{dedup}"),
           _det_configs(paths, names), input_chunks={"init_time": 4})
  assert bool(seen) == dedup


def test_infinite_derived_variables_skip_the_kernels(stores, monkeypatch):
  """The geostrophic winds are ±inf on the equator by design; the tensor-
  core kernels take finite numbers only, so their inf cells reach kernel 2
  as 0 with indicator rows, and the results' inf and NaN cells are the JAX
  package's: a region without the equator stays finite."""
  tmp, paths = stores
  from weatherbench2_torch import ops

  for name in ("fused_deterministic_sums", "fused_region_sums"):
    real = getattr(ops, name)

    def finite_only(*args, real=real, **kwargs):
      assert all(bool(a.isfinite().all() | a.isnan().any())
                 for a in args if hasattr(a, "isfinite")), "inf reached"
      return real(*args, **kwargs)

    monkeypatch.setattr(ops, name, finite_only)
  geo = ("u_component_of_geostrophic_wind", "v_component_of_geostrophic_wind")
  cfgs = {"d": jconfig.Eval(
      metrics={"mse": jmetrics.MSE(wind_vector_mse=[jmetrics.WindVectorMSE(
                   *geo, vector_name="geostrophic_wind_vector")]),
               "bias": jmetrics.Bias()},
      regions=_regions(), derived_variables=_derived(
          "geostrophic_wind_speed", *geo))}
  out = {}
  for side in ("jax", "port"):
    dc = _data_config(paths, tmp / f"geo_{side}", variables=["geopotential"])
    if side == "jax":
      # the JAX package's streaming engine differentiates the lazily read
      # chunk and fails (ROADMAP C); its in-memory engine reads it whole
      with pytest.raises(TypeError, match="LazyArray"):
        jevaluation.evaluate_with_mesh(dc, cfgs, input_chunks={"init_time": 4})
      jevaluation.evaluate_in_memory(dc, cfgs)
    else:
      run_port(dc, cfgs, input_chunks={"init_time": 4})
    out[side] = open_result(tmp / f"geo_{side}", "d")
  got, want = out["port"], out["jax"]
  assert sorted(got.keys()) == sorted(want.keys())
  for k in want.keys():
    w = np.asarray(want[k].values, np.float64)
    g = np.asarray(got[k].transpose(*want[k].dims).values, np.float64)
    np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w), err_msg=k)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5,
                               atol=1e-5 * np.abs(w[fin]).max(), err_msg=k)
  # the equator's inf and NaN cells stay in the regions that hold them
  regions = list(np.asarray(got.coords_dict()["region"].data))
  speed = got["geostrophic_wind_speed"]
  assert np.isfinite(speed.isel(region=regions.index("extra-tropics")).values
                     ).all()
  assert np.isnan(speed.isel(region=regions.index("global")).values).all()


def test_inf_safe_region_sums_keep_each_inf_to_its_regions():
  """Rows with +inf, -inf, both and NaN cells against a reduction over each
  region's own cells (weight > 0), in float64."""
  import torch
  from weatherbench2_torch import ops

  rs = np.random.RandomState(9)
  x = rs.randn(6, 40)
  x[0, 3] = np.inf
  x[1, 3] = -np.inf
  x[2, [3, 30]] = [np.inf, -np.inf]
  x[3, 30] = np.nan
  x[4, [3, 31]] = [np.inf, np.nan]
  w = np.zeros((3, 40))
  w[0] = rs.rand(40)
  w[1, :20] = rs.rand(20)
  w[2, 20:] = rs.rand(20)
  sums, wsum, nanw = streaming._inf_safe_region_sums(
      torch.as_tensor(x), torch.as_tensor(w, dtype=torch.float32))
  want = np.full((3, 6), np.nan)
  for r in range(3):
    cells = w[r] > 0
    valid = cells & ~np.isnan(x)
    with np.errstate(invalid="ignore"):
      want[r] = (x * np.where(valid, w[r], 0)).sum(axis=1, where=valid)
  got = sums.numpy()
  np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
  np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
  fin = np.isfinite(want)
  np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
  plain = ops.fused_region_sums_plain(
      torch.as_tensor(np.where(np.isinf(x), 0, x), dtype=torch.float32),
      torch.as_tensor(w, dtype=torch.float32))
  np.testing.assert_allclose(wsum.numpy(), plain[1].numpy(), rtol=1e-6)
  np.testing.assert_array_equal(nanw.numpy(), plain[2].numpy())


def test_configs_split_by_a_differently_defined_derived_variable(stores):
  """Two configs whose ``wind_speed`` differ in definition stream apart
  (each computes its own), and each equals the JAX package's."""
  tmp, paths = stores
  base = _det_configs(paths, names=(), regions=False)["d"]
  cfgs = {
      "a": jconfig.Eval(metrics=dict(base.metrics),
                        derived_variables=_derived("wind_speed")),
      "b": jconfig.Eval(metrics=dict(base.metrics), derived_variables={
          "wind_speed": jdv.WindSpeed(u_name="u_component_of_wind",
                                      v_name="u_component_of_wind")}),
  }
  keys = {streaming.input_key(c)
          for c in convert.eval_configs_from_reference(cfgs).values()}
  assert len(keys) == 2
  stats = run_port(_data_config(paths, tmp / "split_port"), cfgs,
                   input_chunks={"init_time": 4})
  assert stats["chunks"] == 4  # two groups of two chunks
  jevaluation.evaluate_with_mesh(_data_config(paths, tmp / "split_jax"), cfgs,
                                 input_chunks={"init_time": 4})
  a, b = (open_result(tmp / "split_port", n) for n in "ab")
  for name, got in (("a", a), ("b", b)):
    assert_results_close(got, open_result(tmp / "split_jax", name), name)
  assert not np.allclose(a["wind_speed"].values, b["wind_speed"].values)


def test_unused_probabilistic_climatology_fields_keep_one_stream(stores):
  """The CLI gives the probabilistic climatology's years and hours to five
  configs, also with the baseline off: configs that differ only there share
  one chunk stream (the JAX package's key splits them)."""
  tmp, paths = stores
  base = _det_configs(paths, names=("wind_speed",), regions=False)["d"]
  cfgs = {"plain": base, "with_fields": jconfig.Eval(
      metrics=dict(base.metrics), derived_variables=_derived("wind_speed"),
      probabilistic_climatology_hour_interval=6)}
  stats = run_port(_data_config(paths, tmp / "one_stream"), cfgs,
                   input_chunks={"init_time": 4})
  assert stats["chunks"] == 2
  on = dict(evaluate_probabilistic_climatology=True,
            probabilistic_climatology_start_year=2018,
            probabilistic_climatology_end_year=2019)
  keys = {streaming.input_key(c) for c in convert.eval_configs_from_reference(
      {f"h{h}": jconfig.Eval(metrics={}, **on,
                             probabilistic_climatology_hour_interval=h)
       for h in (6, 12)}).values()}
  assert len(keys) == 2
  assert_results_close(open_result(tmp / "one_stream", "plain"),
                       open_result(tmp / "one_stream", "with_fields"),
                       "one stream")


def test_port_finishes_a_derived_run_the_jax_package_began(stores):
  """The JAX package streams the first 4 inits with wind_speed and leaves
  its state; the port loads it (variables in the JAX order) and finishes."""
  tmp, paths = stores
  cfgs = _det_configs(paths, names=("wind_speed",))
  cpath = str(tmp / "carried_jax_ckpt")
  jevaluation.evaluate_with_mesh(
      _data_config(paths, tmp / "carried_part",
                   time_slice=slice("2020-01-01", "2020-01-02T12")),
      cfgs, input_chunks={"init_time": 4}, checkpoint_path=cpath,
      checkpoint_every=1)
  state = convert.state_from_reference(
      jstreaming.StreamingState.load(cpath + ".d"))
  assert list(state.configs["d"][0]["mse"].keys()) == [
      "2m_temperature", *WIND, "wind_speed"]
  port_cpath = str(tmp / "carried_port_ckpt")
  state.save(port_cpath + ".d")
  stats = run_port(_data_config(paths, tmp / "carried_resumed"), cfgs,
                   input_chunks={"init_time": 4}, checkpoint_path=port_cpath,
                   checkpoint_every=1)
  assert stats["chunks"] == 1
  jevaluation.evaluate_with_mesh(_data_config(paths, tmp / "carried_full"),
                                 cfgs, input_chunks={"init_time": 4})
  assert_results_close(open_result(tmp / "carried_resumed", "d"),
                       open_result(tmp / "carried_full", "d"), "carried")


# -- the probabilistic climatology --------------------------------------------


def build_years_stores(tmp_dir: str) -> dict:
  """``tests/test_eval_configs.py``'s stores: daily truth from 2018, a
  forecast of January 2020 with 3-day leads; {name: path}."""
  kwargs = dict(variables_3d=[], variables_2d=["2m_temperature"],
                spatial_resolution_in_degrees=30.0)
  truth = jutils.random_like(jschema.mock_truth_data(
      time_start="2018-01-01", time_stop="2020-02-01", **kwargs), seed=0)
  forecast = jutils.random_like(jschema.mock_forecast_data(
      lead_stop="3 days", time_start="2020-01-01", time_stop="2020-01-15",
      **kwargs), seed=1)
  return _write({}, tmp_dir, truth=truth, forecast=forecast)


@pytest.fixture(scope="module")
def years_stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_prob_clim")
  return tmp, build_years_stores(str(tmp))


def _prob_configs():
  ens = dict(ensemble_dim="number")
  return {"p": jconfig.Eval(
      metrics={"crps": jmetrics.CRPS(**ens),
               "crps_spread": jmetrics.CRPSSpread(**ens),
               "crps_skill": jmetrics.CRPSSkill(**ens),
               "ensemble_mean_mse": jmetrics.EnsembleMeanMSE(**ens),
               "debiased_ensemble_mean_mse": jmetrics.DebiasedEnsembleMeanMSE(
                   **ens),
               "ensemble_variance": jmetrics.EnsembleVariance(**ens)},
      regions=_regions(), evaluate_probabilistic_climatology=True,
      probabilistic_climatology_start_year=2018,
      probabilistic_climatology_end_year=2019,
      probabilistic_climatology_hour_interval=24)}


@pytest.mark.parametrize("engine", ["mesh", "memory"])
def test_probabilistic_climatology_matches_the_jax_package(years_stores,
                                                           engine):
  tmp, paths = years_stores
  cfgs = _prob_configs()
  out = {}
  for side in ("jax", "port"):
    dc = _data_config(paths, tmp / f"pc_{engine}_{side}",
                      time_slice=slice("2020-01-01", "2020-01-12"))
    dc.selection.levels = None
    if side == "jax" and engine == "mesh":
      jevaluation.evaluate_with_mesh(dc, cfgs, input_chunks={"init_time": 5})
    elif side == "jax":
      jevaluation.evaluate_in_memory(dc, cfgs)
    elif engine == "mesh":
      stats = run_port(dc, cfgs, input_chunks={"init_time": 5})
      assert stats["chunks"] == 3
    else:
      evaluation.evaluate_in_memory(
          convert.from_reference(dc), convert.eval_configs_from_reference(cfgs),
          device="cpu")
    out[side] = open_result(tmp / f"pc_{engine}_{side}", "p")
  assert_results_close(out["port"], out["jax"], engine)
  assert np.isfinite(out["port"]["2m_temperature"].values).all()


def test_probabilistic_climatology_rides_the_probabilistic_plan(years_stores):
  """The members have the `number` dim of an ensemble forecast: the
  engine gives the CRPS family its fused plan."""
  tmp, paths = years_stores
  seen = []
  real = streaming._fused_prob_chunk_results
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(streaming, "_fused_prob_chunk_results",
               lambda *a: seen.append(a[1]) or real(*a))
    dc = _data_config(paths, tmp / "pc_plan",
                      time_slice=slice("2020-01-01", "2020-01-02"))
    dc.selection.levels = None
    run_port(dc, _prob_configs(), input_chunks={"init_time": 2})
  assert len(seen) == 1 and seen[0].sizes["number"] == 2


def _leap_truth():
  """Daily truth over 2019-01-01 .. 2021-01-02 (2020 is a leap year)."""
  ds = jutils.random_like(jschema.mock_truth_data(
      variables_3d=[], variables_2d=["2m_temperature"],
      spatial_resolution_in_degrees=30.0, time_start="2019-01-01",
      time_stop="2021-01-03"), seed=5)
  return ds, convert.from_reference(ds)


def test_day_366_is_a_leap_year_member_and_nan_elsewhere():
  jtruth, truth = _leap_truth()
  times = np.array(["2020-12-30", "2020-12-31", "2021-01-01"],
                   dtype="datetime64[ns]")
  want = jutils.make_probabilistic_climatology(jtruth, 2019, 2020, 24)
  jtimes = jxds.DataArray(times, dims=("time",), coords={"time": times})
  want = want.sel(dayofyear=jtimes.dt.dayofyear, hour=jtimes.dt.hour)
  got = utils.ProbabilisticClimatology(truth, 2019, 2020, 24).members(
      xds.DataArray(times, dims=("time",), coords={"time": times}),
      ["2m_temperature"])
  w = want["2m_temperature"]
  g = got["2m_temperature"].transpose(*w.dims)
  np.testing.assert_array_equal(g.values, w.values)
  day366 = g.isel(time=1)
  assert np.isnan(day366.sel(number=0).values).all()  # 2019: 365 days
  assert np.isfinite(day366.sel(number=1).values).all()
  np.testing.assert_array_equal(
      day366.sel(number=1).values,
      truth["2m_temperature"].sel(time="2020-12-31").isel(time=0).values)
  # the eager make_probabilistic_climatology equals the JAX package's
  eager = utils.make_probabilistic_climatology(truth, 2019, 2020, 24)
  full = jutils.make_probabilistic_climatology(jtruth, 2019, 2020, 24)
  assert eager["2m_temperature"].dims == full["2m_temperature"].dims
  np.testing.assert_array_equal(eager["2m_temperature"].values,
                                full["2m_temperature"].values)


def test_probabilistic_climatology_refusals():
  _, truth = _leap_truth()
  with pytest.raises(KeyError, match="year 2017"):
    utils.ProbabilisticClimatology(truth, 2017, 2019, 24)
  clim = utils.ProbabilisticClimatology(truth, 2019, 2020, 24)
  noon = np.array(["2020-01-05T12"], dtype="datetime64[ns]")
  with pytest.raises(KeyError, match="hours"):
    clim.members(xds.DataArray(noon, dims=("time",)), ["2m_temperature"])
  assert clim.size == 2


@pytest.mark.parametrize("helper", ["replace_time_with_doy", "select_hour"])
def test_time_helpers_match_the_jax_package(helper):
  jtruth, truth = (ds.isel(time=slice(360, 370)) for ds in _leap_truth())
  args = (12,) if helper == "select_hour" else ()
  if helper == "select_hour":  # 12-hourly times, so that an hour drops
    jtruth = jutils.random_like(jschema.mock_truth_data(
        variables_3d=[], variables_2d=["2m_temperature"],
        spatial_resolution_in_degrees=30.0, time_start="2020-12-29",
        time_stop="2021-01-02", time_resolution="12 hours"), seed=6)
    truth = convert.from_reference(jtruth)
  want = getattr(jutils, helper)(jtruth, *args)
  got = getattr(utils, helper)(truth, *args)
  assert got.sizes == want.sizes
  for k, v in want.coords_dict().items():
    np.testing.assert_array_equal(np.asarray(got.coords_dict()[k].data),
                                  np.asarray(v.data), err_msg=k)
  np.testing.assert_array_equal(got["2m_temperature"].values,
                                want["2m_temperature"].values)

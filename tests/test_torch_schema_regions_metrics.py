"""The port's host layer against the JAX package's: mock factories and time
conventions, latitude weights, region masks, the unfused metrics, and the
config conversion."""
import numpy as np
import pytest

from tests.golden import common
from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import regions as jregions
from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import xds as jxds
from weatherbench2_torch import config, convert, metrics, regions, schema
from weatherbench2_torch import xds


def _coords_equal(port_ds, jax_ds):
  assert sorted(port_ds.coords_dict()) == sorted(jax_ds.coords_dict())
  for k, v in jax_ds.coords_dict().items():
    p = port_ds.coords_dict()[k]
    assert p.dims == v.dims, k
    np.testing.assert_array_equal(np.asarray(p.data), np.asarray(v.data),
                                  err_msg=k)
    # same kind; the reference's time unit follows its pandas version
    assert np.asarray(p.data).dtype.kind == np.asarray(v.data).dtype.kind, k
  assert port_ds.sizes == jax_ds.sizes
  for k, v in jax_ds.variables_dict().items():
    assert port_ds.variables_dict()[k].dims == v.dims, k


_FACTORY_CASES = [
    dict(variables_3d=["geopotential"], variables_2d=["2m_temperature"],
         time_start="2020-01-01", time_stop="2020-02-01",
         spatial_resolution_in_degrees=30.0),
    dict(variables_3d=["geopotential"], variables_2d=["2m_temperature"],
         levels=(500, 700, 850), time_start="2020-01-01",
         time_stop="2021-01-11", time_resolution="6 hours",
         spatial_resolution_in_degrees=45.0),
    dict(variables_3d=[], variables_2d=["2m_temperature"],
         time_start="2019-12-30", time_stop="2020-01-02T06",
         time_resolution="3 hours", spatial_resolution_in_degrees=60.0),
]


@pytest.mark.parametrize("kwargs", _FACTORY_CASES)
def test_mock_truth_data_matches(kwargs):
  _coords_equal(schema.mock_truth_data(**kwargs),
                jschema.mock_truth_data(**kwargs))


@pytest.mark.parametrize("by_init", [True, False])
@pytest.mark.parametrize("leads", [
    dict(lead_stop="3 days"),
    dict(lead_start="0 days", lead_stop="10 days",
         lead_resolution="12 hours"),
])
def test_mock_forecast_and_time_conventions_match(by_init, leads):
  kwargs = {**_FACTORY_CASES[0], **leads}
  port = schema.mock_forecast_data(**kwargs)
  ref = jschema.mock_forecast_data(**kwargs)
  _coords_equal(port, ref)
  _coords_equal(schema.apply_time_conventions(port, by_init),
                jschema.apply_time_conventions(ref, by_init))


def test_mock_climatology_and_time_accessors_match():
  kwargs = dict(variables_3d=["geopotential"], variables_2d=[],
                spatial_resolution_in_degrees=45.0)
  _coords_equal(schema.mock_hourly_climatology_data(hour_interval=6,
                                                    **kwargs),
                jschema.mock_hourly_climatology_data(hour_interval=6,
                                                     **kwargs))
  times = np.arange(np.datetime64("2019-12-30T21", "ns"),
                    np.datetime64("2021-01-02", "ns"),
                    np.timedelta64(7, "h"))[:1200].reshape(-1, 4)
  port = xds.DataArray(times, dims=("a", "b"))
  ref = jxds.DataArray(times, dims=("a", "b"))
  for comp in ("dayofyear", "hour"):
    np.testing.assert_array_equal(getattr(port.dt, comp).values,
                                  getattr(ref.dt, comp).values, err_msg=comp)


def test_time_selection_matches():
  kwargs = dict(_FACTORY_CASES[1])
  port = schema.mock_truth_data(**kwargs)
  ref = jschema.mock_truth_data(**kwargs)
  for sl in (slice("2020-01-01", "2020-01-15"), slice("2020-02", "2020-03"),
             slice("2020", "2020"), slice("2020-06-01T06", None)):
    np.testing.assert_array_equal(
        port.sel(time=sl).coords_dict()["time"].data,
        ref.sel(time=sl).coords_dict()["time"].data, err_msg=str(sl))
  lead = np.arange(4) * np.timedelta64(6, "h")
  idx = xds.Index(lead.astype("m8[ns]"))
  assert idx.positions_for_labels(np.asarray(["12 hours", "18h"])).tolist() \
      == [2, 3]


def _grid(res):
  ds = jschema.mock_truth_data(variables_3d=[], variables_2d=["t"],
                               spatial_resolution_in_degrees=res,
                               time_stop="2020-01-02")
  return (np.asarray(ds.coords_dict()["latitude"].data),
          np.asarray(ds.coords_dict()["longitude"].data))


@pytest.mark.parametrize("res", [30.0, 1.5])
def test_lat_weights_match(res):
  lat, lon = _grid(res)
  port = metrics.get_lat_weights(xds.Dataset(coords={"latitude": lat}))
  ref = jmetrics.get_lat_weights(jxds.Dataset(coords={"latitude": lat}))
  np.testing.assert_array_equal(port.values, ref.values)


def _region_pairs(lat, lon):
  rs = np.random.RandomState(0)
  lsm = rs.rand(len(lat), len(lon))
  mk = lambda mod: mod.LandRegion(
      land_sea_mask=mod.xds.DataArray(
          lsm, dims=("latitude", "longitude"),
          coords={"latitude": lat, "longitude": lon}),
      threshold=0.5)
  pairs = []
  for mod in (regions, jregions):
    pairs.append([
        mod.SliceRegion(),
        mod.SliceRegion(lat_slice=slice(-20, 20)),
        mod.SliceRegion(lat_slice=[slice(-90, -60), slice(60, 90)],
                        lon_slice=slice(300, 60)),
        mod.ExtraTropicalRegion(),
        mod.ExtraTropicalRegion(threshold_lat=45),
        mk(mod),
        mod.CombinedRegion(regions=[mod.SliceRegion(
            lat_slice=slice(0, 90)), mk(mod)]),
    ])
  return list(zip(*pairs))


@pytest.mark.parametrize("res", [30.0, 5.625])
def test_region_masks_match(res):
  lat, lon = _grid(res)
  for port, ref in _region_pairs(lat, lon):
    np.testing.assert_array_equal(port.mask_weights(lat, lon),
                                  ref.mask_weights(lat, lon),
                                  err_msg=repr(ref))


def _fields(seed):
  lat, lon = _grid(30.0)
  rs = np.random.RandomState(seed)
  shape = (3, 2, len(lon), len(lat))
  f, t = rs.randn(*shape), rs.randn(*shape)
  f[0, 1, 2, 3] = np.nan
  coords = {"time": np.arange(3), "level": np.asarray([500, 850]),
            "longitude": lon, "latitude": lat}
  dims = ("time", "level", "longitude", "latitude")
  port = [convert.dataset_from_arrays({"z": (dims, a)}, coords)
          for a in (f, t)]
  ref = [jxds.Dataset({"z": (dims, a)}, coords=coords) for a in (f, t)]
  return lat, lon, port, ref


@pytest.mark.parametrize("skipna", [False, True])
def test_unfused_metrics_match(skipna):
  lat, lon, (pf, pt), (jf, jt) = _fields(1)
  names = ["MSE", "RMSESqrtBeforeTimeAvg", "MAE", "Bias"]
  for (port_region, ref_region) in _region_pairs(lat, lon):
    for name in names:
      got = getattr(metrics, name)().compute_chunk(
          pf, pt, region=port_region, skipna=skipna)
      want = getattr(jmetrics, name)().compute_chunk(
          jf, jt, region=ref_region, skipna=skipna)
      np.testing.assert_allclose(got["z"].values, want["z"].values,
                                 rtol=1e-12, err_msg=f"{name} {ref_region}")


def test_unfused_acc_matches():
  lat, lon, (pf, pt), (jf, jt) = _fields(2)
  days = 1 + np.arange(366)
  rs = np.random.RandomState(9)
  clim = rs.randn(366, 2, len(lon), len(lat))
  dims = ("dayofyear", "level", "longitude", "latitude")
  coords = {"dayofyear": days, "level": np.asarray([500, 850]),
            "longitude": lon, "latitude": lat}
  valid = np.datetime64("2020-02-27", "ns") + np.arange(3) * np.timedelta64(
      1, "D")
  pf = pf.assign_coords(valid_time=xds.Variable(("time",), valid))
  jf = jf.assign_coords(valid_time=jxds.Variable(("time",), valid))
  pf, pt, jf, jt = (d.rename({"time": "init_time"}) for d in (pf, pt, jf, jt))
  got = metrics.ACC(climatology=convert.dataset_from_arrays(
      {"z": (dims, clim)}, coords)).compute_chunk(pf, pt)
  want = jmetrics.ACC(climatology=jxds.Dataset(
      {"z": (dims, clim)}, coords=coords)).compute_chunk(jf, jt)
  np.testing.assert_allclose(got["z"].values, want["z"].values, rtol=1e-12)


def test_convert_round_trips_golden_configs(tmp_path):
  clim = jxds.Dataset(
      {"z": (("dayofyear", "latitude"), np.ones((2, 3)))},
      coords={"dayofyear": [1, 2], "latitude": [-1.0, 0.0, 1.0]})
  ref = common.eval_configs(clim)
  for name in ("deterministic", "deterministic_temporal",
               "deterministic_vs_analysis"):
    port = convert.eval_configs_from_reference({name: ref[name]})[name]
    assert isinstance(port, config.Eval)
    assert port.temporal_mean == ref[name].temporal_mean
    assert port.against_analysis == ref[name].against_analysis
    assert list(port.metrics) == list(ref[name].metrics)
    for k, m in port.metrics.items():
      assert type(m).__name__ == type(ref[name].metrics[k]).__name__
      assert type(m).__module__ == "weatherbench2_torch.metrics"
    assert {k: repr(v) for k, v in port.regions.items()} == {
        k: repr(v) for k, v in ref[name].regions.items()}
    if "acc" in port.metrics:
      np.testing.assert_array_equal(
          port.metrics["acc"].climatology["z"].values, clim["z"].values)
  with pytest.raises(NotImplementedError, match="CRPS"):
    convert.eval_configs_from_reference(
        {"probabilistic": ref["probabilistic"]})


def test_unported_config_fields_raise():
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    config.Eval(metrics={}, derived_variables={"x": object()}).validate()
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    config.Eval(metrics={},
                evaluate_probabilistic_climatology=True).validate()
  with pytest.raises(ValueError, match="output_format"):
    config.Eval(metrics={}, output_format="csv").validate()

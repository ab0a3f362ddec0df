"""The port's derived variables and labeled operations against the JAX
package's, on the CPU.

Inputs are made from a numpy seed at 30 degrees (12 x 7 cells: the equator
and both poles among the latitudes), five pressure levels with non-uniform
spacing, 6-hourly leads: every field of ``DERIVED_VARIABLE_DICT``'s base
variables, realistic temperatures and humidities, and precipitation that
accumulates along the lead axis.  Each entry of the dict, the zonal
spectrum and the spectral interpolation run on the same values through
the JAX package (numpy payloads, float64 under the tests' x64) and through
the port, on numpy and on torch payloads.  Tolerance: ``rtol=1e-6`` plus
``atol=1e-6 x max|reference|`` in float64 (the port's float64 payloads
take the same arithmetic in another order), ``rtol=1e-5`` in float32;
infinities and NaNs in the same places.
"""
import numpy as np
import pytest
import torch

from weatherbench2_tpu import derived_variables as jdv
from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import xds as jxds
from weatherbench2_torch import convert
from weatherbench2_torch import derived_variables as dv
from weatherbench2_torch import xds

LEVELS = (300, 500, 700, 850, 1000)
VARIABLES_3D = ["geopotential", "temperature", "u_component_of_wind",
                "v_component_of_wind", "specific_humidity",
                "specific_cloud_liquid_water_content",
                "specific_cloud_ice_water_content"]
VARIABLES_2D = ["10m_u_component_of_wind", "10m_v_component_of_wind",
                "total_precipitation", "total_precipitation_6hr",
                "total_precipitation_12hr"]
NAMES = list(jdv.DERIVED_VARIABLE_DICT)


def _inputs(seed=7):
  """A forecast-shaped dataset with every base variable (float64)."""
  ds = jschema.mock_forecast_data(
      variables_3d=VARIABLES_3D, variables_2d=VARIABLES_2D, levels=LEVELS,
      spatial_resolution_in_degrees=30.0, time_start="2020-01-01",
      time_stop="2020-01-02", time_resolution="12 hours", lead_stop="2 days",
      lead_resolution="6 hours")
  rs = np.random.RandomState(seed)
  data = {}
  for name, v in ds.variables_dict().items():
    x = rs.randn(*v.shape)
    if name == "temperature":
      x = 250 + 10 * x
    elif name.startswith("specific"):
      x = 5e-3 * rs.rand(*v.shape)
    elif name == "geopotential":
      x = 9.81 * (5000 + 100 * x)
    elif name.startswith("total_precipitation"):
      steps = 1e-3 * np.abs(x)
      steps[rs.rand(*v.shape) < 0.05] *= -0.01
      x = np.cumsum(steps, axis=v.dims.index("prediction_timedelta"))
    data[name] = x
  return ds.copy(data=data)


@pytest.fixture(scope="module")
def inputs():
  jds = _inputs()
  port = convert.from_reference(jds)
  return {"jax": jds, "numpy": port,
          "torch": port.copy(data={k: torch.as_tensor(np.asarray(v.data))
                                   for k, v in port.variables_dict().items()})}


def assert_close(got, want, what, rtol=1e-6):
  assert set(got.dims) == set(want.dims), what
  g = np.asarray(got.transpose(*want.dims).values, np.float64)
  w = np.asarray(want.values, np.float64)
  finite = np.isfinite(w)
  np.testing.assert_array_equal(np.isfinite(g), finite, err_msg=what)
  np.testing.assert_array_equal(g[~finite], w[~finite], err_msg=what)
  np.testing.assert_allclose(g[finite], w[finite], rtol=rtol,
                             atol=rtol * np.abs(w[finite]).max(),
                             err_msg=what)
  for d in want.dims:
    if d in want.coords:
      np.testing.assert_array_equal(np.asarray(got.coords[d].data),
                                    np.asarray(want.coords[d].data),
                                    err_msg=f"{what}/{d}")


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("name", NAMES)
def test_every_derived_variable_matches_the_jax_package(inputs, name,
                                                        payload):
  want = jdv.DERIVED_VARIABLE_DICT[name].compute(inputs["jax"])
  got = dv.DERIVED_VARIABLE_DICT[name].compute(inputs[payload])
  assert type(dv.DERIVED_VARIABLE_DICT[name]).__name__ == type(
      jdv.DERIVED_VARIABLE_DICT[name]).__name__
  assert dv.DERIVED_VARIABLE_DICT[name].base_variables == (
      jdv.DERIVED_VARIABLE_DICT[name].base_variables)
  assert dv.DERIVED_VARIABLE_DICT[name].core_dims == (
      jdv.DERIVED_VARIABLE_DICT[name].core_dims)
  assert isinstance(got.data, torch.Tensor) == (payload == "torch")
  assert_close(got, want, f"{name}/{payload}")


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("name", NAMES)
def test_a_float32_payload_stays_float32(inputs, name, payload):
  """Coefficients from float64 coordinates are cast to the payload's
  dtype; the values agree with the JAX package's float64 ones."""
  ds = inputs[payload]
  ds32 = ds.copy(data={k: v.data.to(torch.float32) if payload == "torch"
                       else np.asarray(v.data, np.float32)
                       for k, v in ds.variables_dict().items()})
  got = dv.DERIVED_VARIABLE_DICT[name].compute(ds32)
  assert got.dtype in (np.float32, torch.float32), (name, got.dtype)
  if name != "lapse_rate":  # a ratio of differences: float32 loses digits
    want = jdv.DERIVED_VARIABLE_DICT[name].compute(inputs["jax"])
    assert_close(got, want, f"{name}/{payload}/float32", rtol=2e-5)


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("name", ["geostrophic_wind_speed",
                                  "u_component_of_geostrophic_wind",
                                  "v_component_of_geostrophic_wind",
                                  "ageostrophic_wind_speed"])
def test_the_equator_is_infinite_on_both_sides(inputs, name, payload):
  want = jdv.DERIVED_VARIABLE_DICT[name].compute(inputs["jax"])
  got = dv.DERIVED_VARIABLE_DICT[name].compute(inputs[payload])
  w = want.values
  equator = list(np.asarray(want.coords["latitude"].data)).index(0.0)
  lat_ax = want.dims.index("latitude")
  assert not np.isfinite(np.take(w, equator, axis=lat_ax)).any()
  assert np.isfinite(np.delete(w, equator, axis=lat_ax)).all()
  g = got.transpose(*want.dims).values
  np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w))
  np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
  np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
  assert dv.DERIVED_VARIABLE_DICT[name].may_be_infinite
  assert not dv.DERIVED_VARIABLE_DICT["wind_speed"].may_be_infinite


def test_compute_on_renames_the_lead_dim(inputs):
  renamed = {p: inputs[p].rename({"prediction_timedelta": "lead_time"})
             for p in ("jax", "numpy")}
  for name in ("total_precipitation_24hr", "total_precipitation_24hr_from_6hr",
               "wind_speed"):
    want = jdv.compute_on(jdv.DERIVED_VARIABLE_DICT[name], renamed["jax"])
    got = dv.compute_on(dv.DERIVED_VARIABLE_DICT[name], renamed["numpy"])
    assert "lead_time" in got.dims and "prediction_timedelta" not in got.dims
    assert_close(got, want, name)


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("variable", ["geopotential", "2m_wind"])
def test_zonal_energy_spectrum_matches_the_jax_package(inputs, payload,
                                                       variable):
  jds, ds = inputs["jax"], inputs[payload]
  if variable == "2m_wind":
    jds = jds.rename({"10m_u_component_of_wind": variable})
    ds = ds.rename({"10m_u_component_of_wind": variable})
  want = jdv.ZonalEnergySpectrum(variable).compute(jds)
  got = dv.ZonalEnergySpectrum(variable).compute(ds)
  assert_close(got, want, variable)
  for coord in ("frequency", "wavelength"):
    np.testing.assert_array_equal(np.asarray(got.coords[coord].data),
                                  np.asarray(want.coords[coord].data))
    assert got.coords[coord].dims == want.coords[coord].dims
    assert got.coords[coord].attrs == want.coords[coord].attrs
  if payload == "torch":
    assert isinstance(got.data, torch.Tensor)
    assert got.data.dtype == torch.float64


def test_interpolate_spectral_frequencies_matches_the_jax_package(inputs):
  want_spec = jdv.ZonalEnergySpectrum("geopotential").compute(inputs["jax"])
  got_spec = dv.ZonalEnergySpectrum("geopotential").compute(inputs["torch"])
  for frequencies in (None, np.linspace(1e-7, 5e-7, 5)):
    want = jdv.interpolate_spectral_frequencies(
        want_spec, "zonal_wavenumber", frequencies)
    got = dv.interpolate_spectral_frequencies(
        got_spec, "zonal_wavenumber", frequencies)
    assert_close(got, want, f"interp {frequencies is None}")
    np.testing.assert_array_equal(np.asarray(got.coords["wavelength"].data),
                                  np.asarray(want.coords["wavelength"].data))
  with pytest.raises(ValueError, match="1-D"):
    dv.interpolate_spectral_frequencies(got_spec, "zonal_wavenumber",
                                        np.ones((2, 2)))


# -- the labeled operations --------------------------------------------------


def _labeled_pair(seed=3, nan=False):
  rs = np.random.RandomState(seed)
  level = np.array([100.0, 250.0, 300.0, 500.0, 925.0])
  x = rs.randn(5, 4, 6)
  if nan:
    x[2, 1, 3] = np.nan
  coords = {"level": level, "t": np.arange(4) * 3.0,
            "longitude": np.arange(6) * 60.0}
  dims = ("level", "t", "longitude")
  jda = jxds.DataArray(x, dims=dims, coords=coords, name="x")
  pda = xds.DataArray(x, dims=dims, coords=coords, name="x")
  return jda, {"numpy": pda, "torch": pda.copy(data=torch.as_tensor(x))}


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("op", [
    ("diff", ("t",), {}), ("diff", ("level",), {"n": 2}),
    ("differentiate", ("level",), {}), ("differentiate", ("longitude",), {}),
    ("integrate", ("level",), {}), ("integrate", ("t",), {}),
    ("rolling_sum", ("t", 2), {}), ("rolling_sum", ("level", 3), {}),
    ("rolling_sum", ("t", 9), {}),
], ids=lambda op: f"{op[0]}-{op[1][0]}-{op[1][-1]}-{op[2]}")
@pytest.mark.parametrize("nan", [False, True])
def test_labeled_operations_match_the_jax_package(payload, op, nan):
  name, args, kwargs = op
  jda, pdas = _labeled_pair(nan=nan)
  want = getattr(jda, name)(*args, **kwargs)
  got = getattr(pdas[payload], name)(*args, **kwargs)
  assert got.dims == want.dims
  g = np.asarray(got.values, np.float64)
  w = np.asarray(want.values, np.float64)
  np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12, equal_nan=True)
  assert sorted(got.coords) == sorted(want.coords)
  for k in want.coords:
    np.testing.assert_array_equal(np.asarray(got.coords[k].data),
                                  np.asarray(want.coords[k].data))


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_labeled_operations_keep_float32(payload):
  _, pdas = _labeled_pair()
  da = pdas[payload]
  da = da.copy(data=da.data.to(torch.float32) if payload == "torch"
               else np.asarray(da.data, np.float32))
  for out in (da.differentiate("level"), da.integrate("level"),
              da.rolling_sum("t", 2), da.diff("t")):
    assert out.dtype in (np.float32, torch.float32)


def test_drop_vars_matches_the_jax_package():
  jda, pdas = _labeled_pair()
  assert sorted(pdas["numpy"].drop_vars("t").coords) == sorted(
      jda.drop_vars("t").coords)
  assert sorted(pdas["numpy"].drop_vars(["t", "level"]).coords) == sorted(
      jda.drop_vars(["t", "level"]).coords)
  jds = jda.to_dataset().assign_coords(extra=np.arange(2))
  pds = pdas["numpy"].to_dataset().assign_coords(extra=np.arange(2))
  for names, errors in ((["x"], "raise"), (["extra", "nope"], "ignore")):
    want = jds.drop_vars(names, errors=errors)
    got = pds.drop_vars(names, errors=errors)
    assert list(got.keys()) == list(want.keys())
    assert sorted(got.coords_dict()) == sorted(want.coords_dict())
  for ds in (jds, pds):
    with pytest.raises(KeyError):
      ds.drop_vars(["nope"])

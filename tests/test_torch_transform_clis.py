"""The port's data-prep CLIs against the JAX package's scripts, on the CPU.

``weatherbench2_torch.cli.compute_derived_variables`` against
``scripts/compute_derived_variables.py`` and
``weatherbench2_torch.cli.compute_zonal_energy_spectrum`` against
``scripts/compute_zonal_energy_spectrum.py``, on the same uncompressed
stores made from seeds with the JAX package's factories at 30 degrees
(12 x 7 cells, the equator and both poles among the latitudes): a 6-hourly
truth with the five 3-d variables at 300/500/700/850/1000 hPa, the 10 m
winds and 2 m temperature, and a forecast whose ``total_precipitation``
accumulates along 6-hourly leads.  The reference scripts run under
``flagsaver`` as ``tests/test_pipeline_clis.py`` runs them, the port's
through ``main`` with ``--device=cpu``.  The reference script hands the
lazily read store to the derived variables, and eight of its fourteen
default entries (those that difference or integrate along an axis, and
relative humidity) fail there on the lazy payloads: those are held to the
JAX package's ``DERIVED_VARIABLE_DICT`` on the store read whole instead.
Values are held to ``rtol=1e-5`` plus ``atol=1e-5 x max|reference|`` per
variable, infinities (the geostrophic winds on the equator) and NaNs in the
same places.
"""
import os
import sys

import numpy as np
import pytest
import torch
from absl import flags
from absl.testing import flagsaver

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import compute_derived_variables as reference_derived  # noqa: E402
import compute_zonal_energy_spectrum as reference_spectrum  # noqa: E402

from weatherbench2_tpu import derived_variables as jdv  # noqa: E402
from weatherbench2_tpu import schema as jschema  # noqa: E402
from weatherbench2_tpu import utils as jutils  # noqa: E402
from weatherbench2_tpu import xds as jxds  # noqa: E402
from weatherbench2_torch import schema  # noqa: E402
from weatherbench2_torch import xds  # noqa: E402
from weatherbench2_torch.cli import compute_derived_variables as derived_cli  # noqa: E402,E501
from weatherbench2_torch.cli import compute_zonal_energy_spectrum as spectrum_cli  # noqa: E402,E501

FLAGS = flags.FLAGS
FLAGS.mark_as_parsed()
RTOL = 1e-5
VARIABLES_3D = ["geopotential", "temperature", "u_component_of_wind",
                "v_component_of_wind", "specific_humidity"]
VARIABLES_2D = ["10m_u_component_of_wind", "10m_v_component_of_wind",
                "2m_temperature"]
# the default entries that the reference script computes on a lazily read
# store
SCRIPT_VARIABLES = ["wind_speed", "10m_wind_speed", "eddy_kinetic_energy",
                    "integrated_vapor_transport", "total_precipitation_6hr",
                    "total_precipitation_24hr"]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_transform_clis")
  kwargs = dict(variables_3d=VARIABLES_3D, variables_2d=VARIABLES_2D,
                levels=(300, 500, 700, 850, 1000),
                spatial_resolution_in_degrees=30.0)
  truth = jutils.random_like(jschema.mock_truth_data(
      time_start="2020-01-01", time_stop="2020-01-04",
      time_resolution="6 hours", **kwargs), seed=41)
  rs = np.random.RandomState(42)
  truth = truth.copy(data={
      "temperature": 250 + 20 * rs.rand(*truth["temperature"].shape),
      "specific_humidity": 5e-3 * rs.rand(*truth["specific_humidity"].shape),
      "geopotential": np.cumsum(
          500 + 100 * rs.rand(*truth["geopotential"].shape),
          axis=truth["geopotential"].dims.index("level"))[
              tuple(slice(None, None, -1) if d == "level" else slice(None)
                    for d in truth["geopotential"].dims)]})
  forecast = jutils.random_like(jschema.mock_forecast_data(
      variables_3d=[], variables_2d=["total_precipitation"],
      spatial_resolution_in_degrees=30.0, time_start="2020-01-01",
      time_stop="2020-01-03", time_resolution="12 hours",
      lead_stop="2 days", lead_resolution="6 hours"), seed=43)
  steps = np.abs(rs.randn(*forecast["total_precipitation"].shape)) * 1e-3
  steps[rs.rand(*steps.shape) < 0.05] *= -0.01
  forecast = forecast.copy(data={"total_precipitation": np.cumsum(
      steps, axis=forecast["total_precipitation"].dims.index(
          "prediction_timedelta"))})
  paths = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    for name, ds in (("truth", truth), ("forecast", forecast)):
      paths[name] = str(tmp / f"{name}.zarr")
      jxds.to_zarr(ds, paths[name])
  return tmp, paths


def assert_stores_close(got, want, what):
  assert sorted(got.keys()) == sorted(want.keys()), what
  for k in want.keys():
    w = np.asarray(want[k].values, np.float64)
    g = np.asarray(got[k].transpose(*want[k].dims).values, np.float64)
    for d in want[k].dims:
      if d in want.coords_dict():
        np.testing.assert_array_equal(
            np.asarray(got.coords_dict()[d].data),
            np.asarray(want.coords_dict()[d].data), err_msg=f"{what}/{d}")
    finite = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), finite,
                                  err_msg=f"{what}/{k} non-finite cells")
    np.testing.assert_array_equal(g[~finite], w[~finite],
                                  err_msg=f"{what}/{k} inf and NaN")
    scale = np.abs(w[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(g[finite], w[finite], rtol=RTOL,
                               atol=RTOL * scale, err_msg=f"{what}/{k}")


def _run_derived(paths, tmp, store, tag, **extra):
  out = {}
  for side in ("ref", "port"):
    path = str(tmp / f"derived_{tag}_{side}.zarr")
    flag_values = dict(input_path=paths[store], output_path=path,
                       derived_variables=SCRIPT_VARIABLES, **extra)
    if side == "ref":
      with flagsaver.flagsaver(**{"working_chunks": {}, **flag_values}):
        reference_derived.main([])
    else:
      derived_cli.main([f"--{k}={_flag(v)}" for k, v in flag_values.items()]
                       + ["--device=cpu"])
    out[side] = jxds.open_zarr(path)
  return out


def _flag(value):
  if isinstance(value, dict):
    return ",".join(f"{k}={v}" for k, v in value.items())
  if isinstance(value, list):
    return ",".join(value)
  return value


@pytest.mark.parametrize("store,extra", [
    ("truth", {}),
    ("truth", {"working_chunks": {"time": 3}}),
    ("forecast", {}),
], ids=["truth", "truth_blocks_of_3", "forecast_precipitation"])
def test_compute_derived_variables_matches_the_jax_script(stores, store,
                                                          extra):
  tmp, paths = stores
  tag = f"{store}_{len(extra)}"
  out = _run_derived(paths, tmp, store, tag, **extra)
  assert_stores_close(out["port"], out["ref"], tag)
  added = set(out["port"].keys()) - set(VARIABLES_3D + VARIABLES_2D) - {
      "total_precipitation"}
  assert added == ({"total_precipitation_6hr", "total_precipitation_24hr"}
                   if store == "forecast" else
                   set(SCRIPT_VARIABLES[:4]))


def test_the_reference_script_fails_on_lazy_payloads(stores):
  """Pins a divergence from ``scripts/compute_derived_variables.py``: it
  hands the lazily read block to the derived variables, and those that
  difference along an axis fail on the lazy payload; the port reads each
  block whole first."""
  tmp, paths = stores
  with flagsaver.flagsaver(input_path=paths["truth"],
                           output_path=str(tmp / "lazy_ref.zarr"),
                           derived_variables=["divergence"],
                           working_chunks={}):
    with pytest.raises(TypeError, match="LazyArray"):
      reference_derived.main([])
  derived_cli.main([f"--input_path={paths['truth']}",
                    f"--output_path={tmp / 'lazy_port.zarr'}",
                    "--derived_variables=divergence", "--device=cpu"])
  assert "divergence" in jxds.open_zarr(str(tmp / "lazy_port.zarr")).keys()


@pytest.mark.parametrize("working_chunks", ["", "time=5"])
def test_default_list_matches_the_jax_package(stores, working_chunks):
  """The default list on the truth store: every entry whose inputs are
  present (all but the two accumulations), each equal to the JAX package's
  variable on the store read whole; the input's variables pass through."""
  tmp, paths = stores
  path = str(tmp / f"derived_default_{working_chunks}.zarr")
  counts = derived_cli.main([f"--input_path={paths['truth']}",
                             f"--output_path={path}",
                             f"--working_chunks={working_chunks}",
                             "--device=cpu"])
  got = jxds.open_zarr(path)
  truth = jxds.open_zarr(paths["truth"])
  names = [n for n in derived_cli._DEFAULT_DERIVED_VARIABLES
           if not n.startswith("total_precipitation")]
  assert set(got.keys()) == set(truth.keys()) | set(names)
  # every base variable crosses once, every derived one comes back once
  assert counts["blocks"] == (3 if working_chunks else 1)
  assert counts["h2d_bytes"] == sum(
      truth[k].values.nbytes for k in VARIABLES_3D + VARIABLES_2D[:2])
  assert counts["d2h_bytes"] == sum(got[n].values.nbytes for n in names)
  want = jxds.Dataset({n: jdv.DERIVED_VARIABLE_DICT[n].compute(truth)
                       for n in names}, coords=dict(truth.coords_dict()))
  assert_stores_close(got[names], want, "default list")
  assert_stores_close(got[list(truth.keys())], truth, "inputs")
  assert np.isinf(got["geostrophic_wind_speed"].values).any()


def test_compute_derived_variables_refuses_to_chunk_a_core_dim(stores):
  tmp, paths = stores
  with pytest.raises(ValueError, match="core dim"):
    derived_cli.main([f"--input_path={paths['forecast']}",
                      f"--output_path={tmp / 'refused.zarr'}",
                      "--working_chunks=prediction_timedelta=2",
                      "--device=cpu"])


def _run_spectrum(paths, tmp, tag, **extra):
  out = {}
  for side in ("ref", "port"):
    path = str(tmp / f"spectrum_{tag}_{side}.zarr")
    flag_values = dict(input_path=paths["truth"], output_path=path,
                       base_variables=["geopotential", "2m_temperature",
                                       "u_component_of_wind"],
                       time_start="2020-01-01", time_stop="2020-01-03",
                       levels=["500", "850"], **extra)
    if side == "ref":
      with flagsaver.flagsaver(**flag_values):
        reference_spectrum.main([])
    else:
      spectrum_cli.main([f"--{k}={_flag(v)}" for k, v in flag_values.items()]
                        + ["--device=cpu"])
    out[side] = jxds.open_zarr(path)
  return out


@pytest.mark.parametrize("averaging_dims", [["time"], ["longitude"], []],
                         ids=["time_averaged", "time_kept", "nothing_averaged"])
def test_zonal_energy_spectrum_matches_the_jax_script(stores, averaging_dims):
  tmp, paths = stores
  out = _run_spectrum(paths, tmp, "_".join(averaging_dims) or "none",
                      averaging_dims=averaging_dims)
  assert_stores_close(out["port"], out["ref"], str(averaging_dims))
  assert ("time" in out["port"]["geopotential"].dims) == (
      "time" not in averaging_dims)
  assert out["port"].sizes["zonal_wavenumber"] == 7


def test_zonal_spectrum_parseval_with_an_even_longitude_count(stores):
  """The spectrum sums to the zonal mean square times the circumference,
  plus the Nyquist bin once more (12 longitudes: the one-sided doubling
  counts it twice, as the reference does)."""
  tmp, paths = stores
  out = str(tmp / "parseval.zarr")
  spectrum_cli.main([f"--input_path={paths['truth']}", f"--output_path={out}",
                     "--base_variables=2m_temperature", "--averaging_dims=",
                     "--time_stop=2020-01-01T06", "--device=cpu"])
  spectrum = xds.open_zarr(out)["2m_temperature"]
  truth = xds.open_zarr(paths["truth"])["2m_temperature"].isel(
      time=slice(0, 2))
  x = np.asarray(truth.transpose("time", "longitude", "latitude").values,
                 np.float64)
  lat = np.asarray(truth.coords["latitude"].data)
  circumference = 2 * np.pi * schema.EARTH_RADIUS_M * np.cos(np.deg2rad(lat))
  nyquist = np.abs(np.fft.rfft(x, axis=1, norm="forward")[:, -1]) ** 2
  want = ((x ** 2).mean(axis=1) + nyquist) * circumference
  got = np.asarray(spectrum.sum("zonal_wavenumber").transpose(
      "time", "latitude").values, np.float64)
  np.testing.assert_allclose(got, want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cli", [derived_cli, spectrum_cli],
                         ids=["derived", "spectrum"])
def test_cli_runs_on_the_card_unless_asked(stores, monkeypatch, cli):
  tmp, paths = stores
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    cli.main([f"--input_path={paths['truth']}",
              f"--output_path={tmp / 'nocard.zarr'}"])
  assert not os.path.exists(tmp / "nocard.zarr")


@pytest.mark.parametrize("cli,reference", [
    (derived_cli, reference_derived), (spectrum_cli, reference_spectrum)],
    ids=["derived", "spectrum"])
def test_parser_defaults_are_the_reference_flags(cli, reference):
  """Every flag of the reference script exists in the port's parser with
  the same default; the port adds ``--device``."""
  defaults = vars(cli.build_parser().parse_args([]))
  holders = [v for v in vars(reference).values()
             if type(v).__name__.endswith("FlagHolder")]
  assert set(defaults) == {h.name for h in holders} | {"device"}
  for h in holders:
    want = h.default
    if isinstance(want, str) and not isinstance(defaults[h.name], str):
      # a flag another script defined first keeps this one's raw default
      want = FLAGS[h.name].parser.parse(want)
    assert defaults[h.name] == want, h.name
  assert defaults["device"] is None

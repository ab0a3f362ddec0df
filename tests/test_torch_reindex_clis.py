"""The port's slice_dataset, index_on_valid_time, expand_climatology and
compute_probabilistic_climatological_forecasts CLIs against the JAX
package's scripts, on the CPU.

Fixed-seed uncompressed stores from the JAX package's factories (30 and 60
degrees); the scripts run under ``flagsaver`` and the port's twins through
``main`` with ``--device=cpu``.  These twins gather and compute nothing, so
every output must equal the script's bit for bit (NaNs in the same places),
the sampled members included.  Small blocks (``BLOCK_BYTES`` patched) make
the windows that read each position once and keep their overlap on the
device run more than once.
"""
import os
import sys

import numpy as np
import pandas as pd
import pytest
from absl import flags

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import compute_probabilistic_climatological_forecasts as reference_pcf  # noqa: E402,E501
import expand_climatology as reference_expand  # noqa: E402
import index_on_valid_time as reference_valid  # noqa: E402
import slice_dataset as reference_slice  # noqa: E402

from tests.test_torch_prep_clis import as_argv  # noqa: E402
from tests.test_torch_prep_clis import run_reference  # noqa: E402
from weatherbench2_tpu import schema as jschema  # noqa: E402
from weatherbench2_tpu import utils as jutils  # noqa: E402
from weatherbench2_tpu import xds as jxds  # noqa: E402
from weatherbench2_torch.cli import compute_probabilistic_climatological_forecasts as pcf_cli  # noqa: E402,E501
from weatherbench2_torch.cli import expand_climatology as expand_cli  # noqa: E402
from weatherbench2_torch.cli import index_on_valid_time as valid_cli  # noqa: E402
from weatherbench2_torch.cli import slice_dataset as slice_cli  # noqa: E402
from weatherbench2_torch.xds import stream  # noqa: E402

FLAGS = flags.FLAGS
FLAGS.mark_as_parsed()


def _write(ds, path, chunks=None):
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    jxds.to_zarr(ds, path, chunks=chunks)
  return path


def _float32(ds, nan_every=None):
  data = {}
  for k, v in ds.variables_dict().items():
    x = np.asarray(v.data, np.float64).copy()
    if nan_every:
      x.reshape(-1)[::nan_every] = np.nan
    data[k] = x.astype(np.float32)
  return ds.copy(data=data)


def _mask(ds):
  """A static (longitude, latitude) variable."""
  shape = (ds.sizes["longitude"], ds.sizes["latitude"])
  return jxds.DataArray(
      np.linspace(0, 1, shape[0] * shape[1], dtype=np.float32).reshape(shape),
      dims=("longitude", "latitude"))


def assert_stores_equal(got_path, want_path):
  got, want = jxds.open_zarr(got_path), jxds.open_zarr(want_path)
  assert sorted(got.keys()) == sorted(want.keys())
  for k in want.keys():
    w = want[k]
    g = got[k]
    assert g.dims == w.dims, k
    assert g.dtype == w.dtype, k
    np.testing.assert_array_equal(np.asarray(g.values), np.asarray(w.values),
                                  err_msg=k)
  assert sorted(got.coords_dict()) == sorted(want.coords_dict())
  for c in want.coords_dict():
    np.testing.assert_array_equal(np.asarray(got.coords_dict()[c].data),
                                  np.asarray(want.coords_dict()[c].data),
                                  err_msg=c)


def _store_bytes(path):
  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, fs in os.walk(path) for f in fs
             if not f.startswith("."))


@pytest.fixture
def small_blocks(monkeypatch):
  monkeypatch.setitem(stream.BLOCK_BYTES, "cpu", 1000)


# -- slice_dataset ---------------------------------------------------------------


@pytest.fixture(scope="module")
def truth(tmp_path_factory):
  """10 days of 6-hourly truth at 30 degrees with the latitude decreasing
  (as ERA5's native stores have it)."""
  tmp = tmp_path_factory.mktemp("torch_reindex_clis")
  ds = jutils.random_like(jschema.mock_truth_data(
      variables_3d=["geopotential", "temperature"],
      variables_2d=["2m_temperature"], levels=(500, 700, 850),
      time_start="2020-01-01", time_stop="2020-01-11",
      time_resolution="6 hours", spatial_resolution_in_degrees=30.0),
      seed=81)
  ds = _float32(ds, nan_every=53).isel(latitude=slice(None, None, -1))
  return tmp, _write(ds, str(tmp / "truth.zarr"), {"time": 8})


@pytest.mark.parametrize("case", [
    dict(sel="level_list=500+850", make_dims_increasing="latitude",
         sel_strings="time_start=2020-01-02,time_stop=2020-01-05T12",
         keep_variables="geopotential,2m_temperature"),
    dict(isel="time_start=3,time_stop=30,time_step=2,longitude_list=0+5+2",
         drop_sel="level_list=700", drop_isel="time_list=0+-1",
         drop_variables="temperature", output_chunks="time=4"),
    dict(isel="latitude_step=-1", drop_sel_strings="time_list=2020-01-03",
         make_dims_increasing="longitude"),
], ids=["sel_increasing", "isel_drops", "flip_positions"])
def test_slice_dataset_matches_the_script(truth, small_blocks, case):
  tmp, path = truth
  tag = "_".join(sorted(case))
  want, got = str(tmp / f"slice_ref_{tag}"), str(tmp / f"slice_{tag}")
  run_reference(reference_slice, input_path=path, output_path=want, **case)
  counts = slice_cli.main(as_argv(input_path=path, output_path=got, **case))
  assert counts["windows"] > 1
  assert_stores_equal(got, want)
  lat = np.asarray(jxds.open_zarr(got).coords_dict()["latitude"].data)
  increasing = "latitude" in case.get("make_dims_increasing", "")
  flipped = "latitude_step=-1" in case.get("isel", "")
  assert (np.diff(lat) > 0).all() == (increasing or flipped)


def test_slice_dataset_refuses_a_non_monotonic_dim(truth, tmp_path):
  _, path = truth
  got = str(tmp_path / "x")
  slice_cli.main(as_argv(input_path=path, output_path=got,
                         isel="longitude_list=3+1+2"))
  with pytest.raises(ValueError, match="non-monotonic"):
    slice_cli.main(as_argv(input_path=got, output_path=got + "y",
                           make_dims_increasing="longitude"))


# -- index_on_valid_time -----------------------------------------------------------


@pytest.fixture(scope="module")
def forecast(tmp_path_factory):
  """12-hourly inits, 6-hourly leads to 2 days, NaNs, a land-sea mask."""
  tmp = tmp_path_factory.mktemp("torch_valid_time")
  fc = jutils.random_like(jschema.mock_forecast_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature"],
      levels=(500, 850), time_start="2020-01-01", time_stop="2020-01-06",
      time_resolution="12 hours", lead_stop="2 days",
      lead_resolution="6 hours", spatial_resolution_in_degrees=60.0),
      seed=82)
  fc = _float32(fc, nan_every=61)
  fc["land_sea_mask"] = _mask(fc)
  return tmp, _write(fc, str(tmp / "fc.zarr"), {"time": 3})


@pytest.mark.parametrize("desired", ["valid_and_delta", "valid_and_init"])
def test_index_on_valid_time_matches_the_script(forecast, small_blocks,
                                                desired):
  tmp, path = forecast
  want, got = str(tmp / f"ref_{desired}"), str(tmp / desired)
  run_reference(reference_valid, input_path=path, output_path=want,
                desired_time_dims=desired)
  counts = valid_cli.main(as_argv(input_path=path, output_path=got,
                                  desired_time_dims=desired))
  assert counts["blocks"] > 1
  assert_stores_equal(got, want)
  out = jxds.open_zarr(got)
  # the first valid time has only its lead-0 forecast: the rest is NaN
  first = out["2m_temperature"].isel(time=0).values
  assert np.isnan(first[1:]).all() and not np.isnan(first[0]).all()
  if desired == "valid_and_delta":
    # each init crosses to the device once, though the valid-time blocks
    # need overlapping init ranges: its leads 0, 12, 24, 36 and 48 h
    src = jxds.open_zarr(path)
    kept = src.isel(prediction_timedelta=slice(None, None, 2))
    assert counts["h2d_bytes"] == sum(
        np.asarray(kept[k].values).nbytes
        for k in ("geopotential", "2m_temperature"))


# -- expand_climatology ------------------------------------------------------------


@pytest.fixture(scope="module")
def climatologies(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_expand")
  hourly = _float32(jutils.random_like(jschema.mock_hourly_climatology_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature"],
      levels=(500,), hour_interval=6, spatial_resolution_in_degrees=60.0),
      seed=83))
  daily = hourly.isel(hour=0, drop=True)
  return (tmp, _write(hourly, str(tmp / "hourly.zarr")),
          _write(daily, str(tmp / "daily.zarr")))


@pytest.mark.parametrize("kind,start,stop,chunk", [
    ("hourly", "2020-02-26", "2020-03-02", 5),
    ("hourly", "2019-12-30T06", "2020-01-01T18", None),
    ("daily", "2020-12-29", "2021-01-02", 2),
], ids=["leap_day", "year_end", "daily_day_366"])
def test_expand_climatology_matches_the_script(climatologies, kind, start,
                                               stop, chunk):
  tmp, hourly, daily = climatologies
  path = hourly if kind == "hourly" else daily
  flag_values = dict(input_path=path, time_start=start, time_stop=stop)
  if chunk:
    flag_values["time_chunk_size"] = chunk
  tag = f"{kind}_{start}"
  want, got = str(tmp / f"ref_{tag}"), str(tmp / tag)
  run_reference(reference_expand, output_path=want, **flag_values)
  counts = expand_cli.main(as_argv(output_path=got, **flag_values))
  assert counts["read_bytes"] == _store_bytes(path)  # the climatology once
  assert_stores_equal(got, want)


# -- compute_probabilistic_climatological_forecasts ------------------------------


SAMPLER_CASES = {
    "wrap_replace": dict(with_replacement=True,
                         initial_time_edge_behavior="WRAP_YEAR"),
    "reflect_unique": dict(with_replacement=False, ensemble_size=12,
                           initial_time_edge_behavior="REFLECT_RANGE"),
    "no_edge_leave_out": dict(with_replacement=True,
                              initial_time_edge_behavior="NO_EDGE",
                              leave_out_if_in_climatology=True,
                              num_years_to_exclude=1),
    "hold_leave_out_unique": dict(with_replacement=False, sample_hold_days=2,
                                  leave_out_if_in_climatology=True,
                                  initial_time_edge_behavior="WRAP_YEAR"),
}


@pytest.mark.parametrize("name", sorted(SAMPLER_CASES))
def test_the_sampler_draws_the_scripts_members(name):
  """Inits across 29 February and 31 December of a leap year; every
  member equal to the script's, generator call for generator call."""
  kw = dict(climatology_start_year=1990, climatology_end_year=1996,
            day_window_size=9, ensemble_size=8, sample_hold_days=0, seed=5)
  kw.update(SAMPLER_CASES[name])
  for start, stop in (("1992-02-26", "1992-03-03"),
                      ("1992-12-28T12", "1993-01-02")):
    times = pd.date_range(start, stop, freq="12h")
    want = reference_pcf.get_sampled_init_times(times, **kw)
    got = pcf_cli.get_sampled_init_times(times.values, **kw)
    # (pandas may give microseconds where the port's times are in ns)
    np.testing.assert_array_equal(got, want.astype("datetime64[ns]"))


@pytest.fixture(scope="module")
def daily_truth(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_pcf")
  ds = _float32(jutils.random_like(jschema.mock_truth_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature"],
      levels=(500,), time_start="1989-12-20", time_stop="1996-01-20",
      time_resolution="12 hours", spatial_resolution_in_degrees=60.0),
      seed=84))
  ds["land_sea_mask"] = _mask(ds)
  return tmp, _write(ds, str(tmp / "truth.zarr"), {"time": 200})


@pytest.mark.parametrize("name", ["wrap_replace", "reflect_unique",
                                  "hold_leave_out_unique"])
def test_probabilistic_climatological_forecasts_match_the_script(
    daily_truth, small_blocks, name):
  tmp, path = daily_truth
  flag_values = {
      "input_path": path, "climatology_start_year": 1990,
      "climatology_end_year": 1995, "initial_time_start": "1992-02-27",
      "initial_time_end": "1992-03-02", "initial_time_spacing": "12h",
      "forecast_duration": "3 days", "timedelta_spacing": "12h",
      "day_window_size": 9, "ensemble_size": 6, "seed": 11,
      "add_source_time": True, **SAMPLER_CASES[name]}
  want, got = str(tmp / f"ref_{name}"), str(tmp / name)
  run_reference(reference_pcf, output_path=want, **flag_values)
  counts = pcf_cli.main(as_argv(output_path=got, **flag_values))
  assert counts["blocks"] > 1
  assert_stores_equal(got, want)
  out = jxds.open_zarr(got)
  assert out["2m_temperature"].dims == (
      "realization", "time", "prediction_timedelta", "longitude", "latitude")
  assert np.isfinite(out["geopotential"].values).all()

"""The port's pandas-free time code and resampling against pandas and the
JAX package, on the CPU: the timedelta grammar and the date ranges, the
resampling plan, the bin reductions, the rolling windows, and the
resample_in_time and resample_daily CLIs against their scripts.

The scripts run under ``flagsaver``, the port's twins through ``main`` with
``--device=cpu`` (the card's torch ops on CPU tensors), on one fixed-seed
uncompressed store at 60 degrees: 6-hourly times with a gap of two days
(empty bins), 2 m temperature with NaNs, geopotential at two levels and a
24 h precipitation.  Tolerances: the reductions ``rtol=1e-12`` (float64
segment sums against numpy's float64), the CLIs ``rtol=1e-5`` plus
``atol=1e-5·max|ref|``; NaNs in the same places; plans, labels and dtypes
equal.
"""
import itertools
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from absl import flags

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import resample_daily as reference_daily  # noqa: E402
import resample_in_time as reference_resample  # noqa: E402

from tests.test_torch_prep_clis import as_argv  # noqa: E402
from tests.test_torch_prep_clis import assert_stores_close  # noqa: E402
from tests.test_torch_prep_clis import run_reference  # noqa: E402
from weatherbench2_tpu import schema as jschema  # noqa: E402
from weatherbench2_tpu import utils as jutils  # noqa: E402
from weatherbench2_tpu import xds as jxds  # noqa: E402
from weatherbench2_torch import utils  # noqa: E402
from weatherbench2_torch import xds  # noqa: E402
from weatherbench2_torch.cli import resample_daily as daily_cli  # noqa: E402
from weatherbench2_torch.cli import resample_in_time as resample_cli  # noqa: E402

FLAGS = flags.FLAGS
FLAGS.mark_as_parsed()
TP24 = "total_precipitation_24hr"


# -- time without pandas -------------------------------------------------------


@pytest.mark.parametrize("text", [
    "1d", "1w", "2W", "3D", "6h", "12H", "30min", "15 days", "6 hours",
    "1 day", "2 W", "90 minutes", "6 hr"])
def test_timedelta_grammar_matches_pandas(text):
  want = pd.to_timedelta(jutils.normalize_timedelta_str(text))
  assert utils.normalize_timedelta_str(text) == (
      jutils.normalize_timedelta_str(text))
  assert utils.to_timedelta(text) == want.to_timedelta64()


@pytest.mark.parametrize("text", ["1.5h", "1 days 06:00:00", "P1D", "h",
                                  "6 fortnights"])
def test_strings_outside_the_grammar_raise_naming_them(text):
  with pytest.raises(ValueError, match=repr(text).replace(".", r"\.")):
    utils.to_timedelta(text)


@pytest.mark.parametrize("start,stop,step", [
    ("2020-01-01", "2020-12-31", "6h"), ("2017-01-01", "2017-12-31", "24h"),
    ("2020-02-27T06", "2020-03-02T18", "12h"), ("2020-01-01", "2020-01-01",
                                                "1d")])
def test_date_range_matches_pandas(start, stop, step):
  want = pd.date_range(start, stop,
                       freq=pd.to_timedelta(step)).values
  np.testing.assert_array_equal(utils.date_range(start, stop, step), want)


@pytest.mark.parametrize("stop,step", [("15 days", "6h"), ("10 days", "12h"),
                                       ("1d", "1d")])
def test_timedelta_range_matches_pandas(stop, step):
  want = pd.timedelta_range(pd.Timedelta(0), pd.Timedelta(stop),
                            freq=pd.Timedelta(step)).values
  np.testing.assert_array_equal(utils.timedelta_range(0, stop, step), want)


def test_time_parts_match_pandas():
  times = utils.date_range("2019-12-30T18", "2020-03-01T06", "6h")
  year, doy, hour = utils.time_parts(times)
  idx = pd.DatetimeIndex(times)
  np.testing.assert_array_equal(year, idx.year)
  np.testing.assert_array_equal(doy, idx.dayofyear)
  np.testing.assert_array_equal(hour, idx.hour)


# -- the plan and the reductions ---------------------------------------------------


def _gappy_times():
  """6-hourly from 06 UTC on 1 January, without 6-7 January."""
  times = utils.date_range("2020-01-01T06", "2020-01-15T18", "6h")
  day = times.astype("datetime64[D]")
  return times[(day < np.datetime64("2020-01-06"))
               | (day > np.datetime64("2020-01-07"))]


@pytest.mark.parametrize("period,label", [
    ("1d", "left"), ("1d", "right"), ("2d", "left"), ("12h", "right"),
    ("1w", "left")])
def test_resample_time_plan_matches_the_jax_package(period, label):
  times = _gappy_times()
  want = jutils.resample_time_plan(times, period, label)
  got = utils.resample_time_plan(times, period, label)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  if (period, label) == ("1d", "left"):
    assert (got[1] == got[2]).sum() == 2  # the two empty days


def test_a_decreasing_time_axis_raises():
  with pytest.raises(ValueError, match="monotonically increasing"):
    utils.resample_time_plan(_gappy_times()[::-1], "1d")


def _field(times, seed):
  rs = np.random.RandomState(seed)
  x = (280 + 5 * rs.randn(len(times), 3, 4)).astype(np.float32)
  x[5, 1, 2] = np.nan
  x[9:13, 0, 0] = np.nan  # a whole day of one cell
  x[20, 2, 3] = np.inf
  return x


@pytest.mark.parametrize("statistic,skipna", list(itertools.product(
    utils.STATISTICS, [False, True])))
def test_bin_reductions_match_the_jax_package(statistic, skipna):
  times = _gappy_times()
  x = _field(times, 3)
  dims = ("time", "longitude", "latitude")
  for label in ("left", "right"):
    plan = jutils.resample_time_plan(times, "1d", label)
    want = jutils.reduce_time_bins(
        jxds.Dataset({"x": (dims, x)}, coords={"time": times}),
        plan[1], plan[2], plan[0], statistic, skipna)
    ds = xds.Dataset({"x": (dims, x)}, coords={"time": times})
    host = utils.reduce_time_bins(ds, plan[1], plan[2], plan[0], statistic,
                                  skipna)
    tensors = utils.reduce_time_bins(
        ds.copy(data={"x": torch.as_tensor(x)}), plan[1], plan[2], plan[0],
        statistic, skipna)
    w = want["x"].values
    assert host["x"].data.dtype == w.dtype == np.float64
    np.testing.assert_allclose(host["x"].data, w, rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(tensors["x"].data.numpy(), w, rtol=1e-12,
                               equal_nan=True)
    np.testing.assert_array_equal(
        np.asarray(host.coords_dict()["time"].data),
        np.asarray(want.coords_dict()["time"].data))
    assert np.isnan(w[(plan[1] == plan[2])]).all()  # the empty bins


def test_bins_that_do_not_tile_a_range_are_gathered():
  x = torch.arange(12, dtype=torch.float32).reshape(12, 1)
  got = utils.bin_reduce(x, [1, 7, 4], [3, 9, 4], "sum")
  np.testing.assert_array_equal(got[:2, 0].numpy(), [3.0, 15.0])
  assert torch.isnan(got[2, 0])


@pytest.mark.parametrize("statistic,skipna", list(itertools.product(
    utils.STATISTICS, [False, True])))
def test_rolling_matches_the_jax_package(statistic, skipna):
  times = _gappy_times()
  x = _field(times, 4)
  dims = ("time", "longitude", "latitude")
  for window in (1, 4, 9):
    want = jutils.rolling_in_time(
        jxds.Dataset({"x": (dims, x)}, coords={"time": times}), window,
        statistic, skipna)["x"].values
    got = utils.rolling_in_time(
        xds.Dataset({"x": (dims, torch.as_tensor(x))},
                    coords={"time": times}), window, statistic,
        skipna)["x"].data.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9,
                               equal_nan=True, err_msg=f"window {window}")


# -- the CLIs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def store(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_resample")
  ds = jutils.random_like(jschema.mock_truth_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature", TP24],
      levels=(500, 850), time_start="2020-01-01", time_stop="2020-01-20",
      time_resolution="6 hours", spatial_resolution_in_degrees=60.0),
      seed=75)
  day = np.asarray(ds.coords_dict()["time"].data).astype("datetime64[D]")
  ds = ds.isel(time=np.nonzero((day < np.datetime64("2020-01-09"))
                               | (day > np.datetime64("2020-01-10")))[0])
  t2 = (280 + 5 * np.asarray(ds["2m_temperature"].values)).astype(np.float32)
  t2.reshape(-1)[::41] = np.nan
  ds = ds.copy(data={
      "2m_temperature": t2,
      "geopotential": (5e4 + 100 * np.asarray(ds["geopotential"].values)
                       ).astype(np.float32),
      TP24: np.abs(np.asarray(ds[TP24].values)).astype(np.float32) * 1e-3})
  path = str(tmp / "truth.zarr")
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    jxds.to_zarr(ds, path, chunks={"time": 10})
  daily = str(tmp / "daily.zarr")
  run_reference(reference_resample, input_path=path, output_path=daily,
                method="resample", period="1d", mean_vars=["ALL"],
                time_start="2020-01-01", time_stop="2020-01-08")
  return tmp, path, daily


def assert_same_dtypes(got, want):
  got, want = jxds.open_zarr(got), jxds.open_zarr(want)
  for k in want.keys():
    assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("case", [
    dict(method="resample", period="1d", mean_vars=["ALL"],
         min_vars=["2m_temperature"], max_vars=["2m_temperature"],
         add_mean_suffix=True),
    dict(method="resample", period="1d", label_side="right",
         sum_vars=[TP24], mean_vars=["2m_temperature"], skipna=True,
         working_chunks="time=5,longitude=2"),
    dict(method="resample", period="2d", max_vars=["ALL"],
         time_start="2020-01-03", time_stop="2020-01-16"),
    dict(method="rolling", period="1d", mean_vars=["2m_temperature"],
         min_vars=["geopotential"], sum_vars=[TP24], skipna=True,
         working_chunks="time=7"),
], ids=["left_suffixes", "right_skipna_tiles", "two_days_range",
        "rolling_blocks"])
def test_resample_in_time_matches_the_script(store, case):
  tmp, path, _ = store
  flag_values = {"input_path": path, "time_start": None, "time_stop": None,
                 **case}
  tag = "_".join(str(v) for v in case.values()).replace(",", "_")
  tag = "".join(c if c.isalnum() else "_" for c in tag)
  want, got = str(tmp / f"rs_ref_{tag}"), str(tmp / f"rs_{tag}")
  run_reference(reference_resample, output_path=want, **flag_values)
  argv = as_argv(output_path=got, **{k: v for k, v in flag_values.items()
                                     if v is not None})
  counts = resample_cli.main(argv)
  assert_stores_close(got, want)
  assert_same_dtypes(got, want)
  src_bytes = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(path) for f in fs
                  if not f.startswith("."))
  if "working_chunks" not in case:  # blocks as long as the store's chunks
    assert counts["read_bytes"] <= src_bytes  # each byte once at most
  if case.get("label_side") == "right":
    out = jxds.open_zarr(got)
    assert np.asarray(out.coords_dict()["time"].data)[0] == np.datetime64(
        "2020-01-02")  # the first bin dropped
    assert np.isnan(out["2m_temperature"].sel(
        time=np.datetime64("2020-01-10")).values).all()  # an empty bin


@pytest.mark.parametrize("case", [
    dict(method="resample", period="1d", statistics=["mean"]),
    dict(method="resample", period="1d", statistics=["mean", "min", "max"],
         add_statistic_suffix=True, working_chunks="time=4,latitude=2"),
], ids=["mean", "suffixes_tiles"])
def test_resample_daily_matches_the_script(store, case):
  tmp, path, _ = store
  tag = "_".join(str(v) for v in case.values())
  tag = "".join(c if c.isalnum() else "_" for c in tag)
  want, got = str(tmp / f"rd_ref_{tag}"), str(tmp / f"rd_{tag}")
  run_reference(reference_daily, input_path=path, output_path=want, **case)
  daily_cli.main(as_argv(input_path=path, output_path=got, **case))
  assert_stores_close(got, want)
  assert_same_dtypes(got, want)
  if case["statistics"] == ["mean"]:
    # the day labelled 1 January sums 06, 12, 18 UTC and the next 00 UTC
    src = jxds.open_zarr(path)[TP24].values
    np.testing.assert_allclose(
        jxds.open_zarr(got)[TP24].values[0], src[1:5].sum(axis=0),
        rtol=1e-6)


def test_resample_daily_rolls_weeks_over_daily_input(store):
  tmp, _, daily = store
  case = dict(method="roll", period="1w", statistics=["mean", "max"],
              add_statistic_suffix=True)
  want, got = str(tmp / "roll_ref"), str(tmp / "roll")
  run_reference(reference_daily, input_path=daily, output_path=want, **case)
  daily_cli.main(as_argv(input_path=daily, output_path=got,
                         working_chunks="time=3", **case))
  assert_stores_close(got, want)
  with pytest.raises(NotImplementedError, match="weekly"):
    daily_cli.main(as_argv(input_path=daily, output_path=got + "x",
                           method="roll", period="3d"))


def test_resample_daily_refuses_weeks_that_the_precipitation_misses(store):
  """Shifted an hour back, the accumulated variable's weeks start a day
  earlier than the others': both raise."""
  tmp, path, _ = store
  case = dict(method="resample", period="1w", statistics=["max"],
              add_statistic_suffix=True)
  with pytest.raises(ValueError, match="cannot be aligned"):
    run_reference(reference_daily, input_path=path,
                  output_path=str(tmp / "w_ref"), **case)
  with pytest.raises(ValueError, match="cannot be aligned"):
    daily_cli.main(as_argv(input_path=path, output_path=str(tmp / "w"),
                           **case))

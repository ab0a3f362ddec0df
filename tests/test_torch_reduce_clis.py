"""The port's compute_ensemble_mean, compute_averages and
compute_statistical_moments CLIs against the JAX package's scripts, on the
CPU.

Fixed-seed uncompressed stores from the JAX package's factories at 30
degrees (12 x 7 cells), float32, with NaNs; the scripts run under
``flagsaver`` and the port's twins through ``main`` with ``--device=cpu``
(kernel 2's plain version for the spatial averages and moments).
Tolerance, per variable: ``rtol=1e-5`` plus ``atol=1e-5·max|ref|`` (float32
sums in another order against the scripts' float64), NaNs in the same
places.
"""
import os
import sys

import numpy as np
import pytest
import torch
from absl import flags

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import compute_averages as reference_averages  # noqa: E402
import compute_ensemble_mean as reference_ensemble_mean  # noqa: E402
import compute_statistical_moments as reference_moments  # noqa: E402

from tests.test_torch_prep_clis import as_argv  # noqa: E402
from tests.test_torch_prep_clis import assert_stores_close  # noqa: E402
from tests.test_torch_prep_clis import run_reference  # noqa: E402
from weatherbench2_tpu import schema as jschema  # noqa: E402
from weatherbench2_tpu import utils as jutils  # noqa: E402
from weatherbench2_tpu import xds as jxds  # noqa: E402
from weatherbench2_torch import ops  # noqa: E402
from weatherbench2_torch.cli import compute_averages as averages_cli  # noqa: E402
from weatherbench2_torch.cli import compute_ensemble_mean as mean_cli  # noqa: E402,E501
from weatherbench2_torch.cli import compute_statistical_moments as moments_cli  # noqa: E402,E501

FLAGS = flags.FLAGS
FLAGS.mark_as_parsed()


def _write(ds, path, chunks):
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    jxds.to_zarr(ds, path, chunks=chunks)
  return path


def _float32(ds, offsets=None, nan_every=None):
  """``ds`` in float32, ``offsets[name]`` added, and NaN at every
  ``nan_every``-th value of each variable."""
  data = {}
  for k, v in ds.variables_dict().items():
    x = np.asarray(v.data, np.float64) + (offsets or {}).get(k, 0.0)
    if nan_every:
      x.reshape(-1)[::nan_every] = np.nan
    data[k] = x.astype(np.float32)
  return ds.copy(data=data)


@pytest.fixture(scope="module")
def truth(tmp_path_factory):
  """40 days of 6-hourly truth: geopotential at two levels near 5e4 (so
  that its squares reach 2.5e9) and 2 m temperature near 280 K with NaNs,
  one time of it NaN everywhere."""
  tmp = tmp_path_factory.mktemp("torch_reduce_clis")
  ds = jutils.random_like(jschema.mock_truth_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature"],
      levels=(500, 850), time_start="2020-01-01", time_stop="2020-02-10",
      time_resolution="6 hours", spatial_resolution_in_degrees=30.0),
      seed=71)
  ds = _float32(ds, {"geopotential": 5e4, "2m_temperature": 280.0})
  t2 = np.asarray(ds["2m_temperature"].values).copy()
  t2.reshape(-1)[::97] = np.nan
  t2[17] = np.nan
  ds = ds.copy(data={"2m_temperature": t2})
  return tmp, _write(ds, str(tmp / "truth.zarr"), {"time": 50})


@pytest.mark.parametrize("skipna", [False, True])
def test_compute_ensemble_mean_matches_the_script(tmp_path, skipna):
  ds = jutils.random_like(jschema.mock_forecast_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature"],
      levels=(500, 850), time_start="2020-01-01", time_stop="2020-01-08",
      lead_stop="2 days", ensemble_size=5,
      spatial_resolution_in_degrees=30.0), seed=72)
  path = _write(_float32(ds, nan_every=23), str(tmp_path / "ens.zarr"),
                {"time": 3})
  flag_values = dict(input_path=path, time_start="2020-01-02",
                     time_stop="2020-01-06", skipna=skipna)
  want, got = str(tmp_path / "ref"), str(tmp_path / "got")
  run_reference(reference_ensemble_mean, output_path=want, **flag_values)
  counts = mean_cli.main(as_argv(output_path=got, **flag_values))
  assert counts["blocks"] == 1 and counts["h2d_bytes"] > 0
  assert_stores_close(got, want)
  out = jxds.open_zarr(got)
  assert "realization" not in out.sizes and out.sizes["time"] == 5
  assert np.isnan(out["geopotential"].values).any() != skipna


@pytest.mark.parametrize("averaging_dims,skipna,variables", [
    ("latitude,longitude", True, None), ("latitude,longitude", False, None),
    ("time", True, None), ("time,latitude", False, "geopotential"),
    ("longitude", True, None)])
def test_compute_averages_matches_the_script(truth, averaging_dims, skipna,
                                             variables):
  tmp, path = truth
  flag_values = dict(input_path=path, averaging_dims=averaging_dims,
                     skipna=skipna, time_start="2020-01-01",
                     time_stop="2020-02-09", levels="500,850")
  if variables:
    flag_values["variables"] = variables
  tag = f"{averaging_dims}_{skipna}".replace(",", "_")
  want, got = str(tmp / f"avg_ref_{tag}"), str(tmp / f"avg_{tag}")
  run_reference(reference_averages, output_path=want, **flag_values)
  before = ops.fused_region_sums.launches
  counts = averages_cli.main(as_argv(output_path=got, **flag_values))
  assert counts["read_bytes"] > 0 and counts["blocks"] >= 1
  assert ops.fused_region_sums.launches == before  # the CPU: plain version
  assert_stores_close(got, want)
  want_ds = jxds.open_zarr(want)
  got_ds = jxds.open_zarr(got)
  for k in want_ds.keys():
    assert got_ds[k].dtype == want_ds[k].dtype, k
  if averaging_dims == "latitude,longitude":
    t2 = got_ds["2m_temperature"].values
    assert np.isnan(t2[17])  # the time without a valid cell
    src = np.isnan(jxds.open_zarr(path)["2m_temperature"].values)
    assert np.isnan(t2).sum() == (1 if skipna
                                  else src.any(axis=(1, 2)).sum()) > 0


def test_spatial_mean_divides_by_the_valid_count():
  """Σ w·x / N_valid with skipna (the script's mean of w·x), not the
  weighted mean Σ w·x / Σ w_valid."""
  lat = np.array([-60.0, 0.0, 60.0])
  w = np.array([0.5, 2.0, 0.5])
  x = np.array([[[1.0, 2.0, np.nan], [4.0, 5.0, 6.0]]], np.float32)
  da = averages_cli.xds.DataArray(torch.as_tensor(x),
                                  dims=("time", "longitude", "latitude"),
                                  coords={"latitude": lat})
  got = averages_cli.spatial_mean(da, w, skipna=True).values
  valid = ~np.isnan(x)
  want = np.nansum(x * w, axis=(1, 2)) / valid.sum(axis=(1, 2))
  np.testing.assert_allclose(got, want, rtol=1e-6)
  assert np.isnan(averages_cli.spatial_mean(da, w, skipna=False).values[0])


@pytest.mark.parametrize("years", [None, (2020, 2020)])
def test_compute_statistical_moments_matches_the_script(truth, years):
  tmp, path = truth
  flag_values = dict(input_path=path)
  if years:
    flag_values.update(start_year=years[0], end_year=years[1])
  tag = "years" if years else "all"
  want, got = str(tmp / f"mom_ref_{tag}"), str(tmp / f"mom_{tag}")
  run_reference(reference_moments, output_path=want, **flag_values)
  counts = moments_cli.main(as_argv(output_path=got, **flag_values))
  assert counts["blocks"] == 1 and counts["d2h_bytes"] > 0
  assert_stores_close(got, want)
  out = jxds.open_zarr(got)
  assert sorted(out.keys()) == sorted(
      f"{v}_{o}" for v in ("geopotential", "2m_temperature")
      for o in moments_cli.ORDERS)
  assert out["geopotential_second"].dims == ("moment", "level")


def test_spatial_moments_count_the_valid_cells():
  x = np.full((2, 3, 4), 3.0, np.float32)
  x[0, 0, 0] = np.nan
  x[1] = np.nan
  da = moments_cli.xds.DataArray(torch.as_tensor(x),
                                 dims=("time", "longitude", "latitude"))
  dims, m = moments_cli.spatial_moments(da)
  assert dims == ("time",)
  np.testing.assert_allclose(m["zeroth"].numpy(), [11 / 12, 0.0])
  np.testing.assert_allclose(m["first"].numpy()[0], 3.0)
  np.testing.assert_allclose(m["second"].numpy()[0], 9.0)
  assert np.isnan(m["first"].numpy()[1]) and np.isnan(m["second"].numpy()[1])


@pytest.mark.parametrize("name", [
    "compute_ensemble_mean", "compute_averages",
    "compute_statistical_moments", "expand_climatology", "slice_dataset",
    "index_on_valid_time", "resample_in_time", "resample_daily",
    "compute_probabilistic_climatological_forecasts"])
def test_the_twins_run_on_the_card_unless_told_cpu(name, tmp_path):
  """Without ``--device`` a twin asks for the card, and raises without
  one before it reads anything."""
  import importlib

  if torch.cuda.is_available():
    pytest.skip("a card is present: the twin would run on it")
  cli = importlib.import_module(f"weatherbench2_torch.cli.{name}")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    cli.main([f"--input_path={tmp_path / 'absent.zarr'}",
              f"--output_path={tmp_path / 'out.zarr'}"])

"""The port's regrid, compute_quantiles and compute_climatology CLIs against
the JAX package's scripts, on the CPU.

The same uncompressed stores, made from seeds with the JAX package's
factories at 30 degrees (12 x 7 cells): two years (one of them leap) of
6-hourly truth with
2 m temperature (a few NaNs), geopotential at 500/850 hPa and a 24 h
precipitation with dry cells.  The reference scripts run under
``flagsaver`` as ``tests/test_climatology_cli.py`` runs them, the port's
through ``main`` with ``--device=cpu`` (the card's torch ops on CPU
tensors).  Tolerances, per variable, NaNs in the same places:

  * regridding and quantiles: ``rtol=1e-5`` plus ``atol=1e-5·max|ref|``
    (the port's float32 matmuls, gathers and sorts against the script's
    float32 device path or float64 host path);
  * climatology means, weighted quantiles and SEEPS thresholds: the same;
    standard deviations (E[x²] - E[x]² in float32 on the card, two-pass
    float64 in the script) within ``rtol=1e-4`` plus
    ``atol=1e-4·max|ref|``.
"""
import os
import sys

import numpy as np
import pytest
import torch
from absl import flags
from absl.testing import flagsaver

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import compute_climatology as reference_climatology  # noqa: E402
import compute_quantiles as reference_quantiles  # noqa: E402
import regrid as reference_regrid  # noqa: E402

from weatherbench2_tpu import schema as jschema  # noqa: E402
from weatherbench2_tpu import utils as jutils  # noqa: E402
from weatherbench2_tpu import xds as jxds  # noqa: E402
from weatherbench2_torch.cli import compute_climatology as climatology_cli  # noqa: E402,E501
from weatherbench2_torch.cli import compute_quantiles as quantiles_cli  # noqa: E402
from weatherbench2_torch import flag_utils  # noqa: E402
from weatherbench2_torch.cli import regrid as regrid_cli  # noqa: E402

FLAGS = flags.FLAGS
FLAGS.mark_as_parsed()
RTOL = 1e-5
TP24 = "total_precipitation_24hr"


@pytest.fixture(scope="module")
def store(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_prep_clis")
  ds = jutils.random_like(jschema.mock_truth_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature", TP24],
      levels=(500, 850), time_start="2019-01-01", time_stop="2021-01-01",
      time_resolution="6 hours", spatial_resolution_in_degrees=30.0),
      seed=61)
  rs = np.random.RandomState(62)
  t2 = 280 + 10 * np.asarray(ds["2m_temperature"].values)
  t2[::97, 2, 3] = np.nan  # (time, longitude, latitude)
  t2[500, 7, 1] = np.nan
  tp = np.abs(np.asarray(ds[TP24].values)) * 1e-3
  tp[rs.rand(*tp.shape) < 0.4] = 0.0
  ds = ds.copy(data={"2m_temperature": t2.astype(np.float32),
                     TP24: tp.astype(np.float32),
                     "geopotential": np.asarray(
                         ds["geopotential"].values, np.float32)})
  path = str(tmp / "truth.zarr")
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    jxds.to_zarr(ds, path, chunks={"time": 100})
  return tmp, path


def assert_stores_close(got_path, want_path, rtol_of=lambda name: RTOL):
  got, want = jxds.open_zarr(got_path), jxds.open_zarr(want_path)
  assert sorted(got.keys()) == sorted(want.keys())
  for k in want.keys():
    w = want[k]
    g = got[k].transpose(*w.dims)
    gv = np.asarray(g.values, np.float64)
    wv = np.asarray(w.values, np.float64)
    assert gv.shape == wv.shape, k
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv), err_msg=k)
    fin = ~np.isnan(wv)
    assert fin.any(), k
    rtol = rtol_of(k)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=rtol,
                               atol=rtol * np.abs(wv[fin]).max(), err_msg=k)
  for c in want.coords_dict():
    np.testing.assert_array_equal(np.asarray(got.coords_dict()[c].data),
                                  np.asarray(want.coords_dict()[c].data),
                                  err_msg=c)


def run_reference(module, **flag_values):
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    with flagsaver.flagsaver(**flag_values):
      module.main([])


def as_argv(**flag_values):
  out = []
  for k, v in flag_values.items():
    if isinstance(v, (list, tuple)):
      v = ",".join(str(x) for x in v)
    elif isinstance(v, dict):
      v = ",".join(f"{d}={n}" for d, n in v.items())
    out.append(f"--{k}={v}")
  return out + ["--device=cpu"]


# -- regrid -------------------------------------------------------------------


@pytest.mark.parametrize("method,time_chunk_size", [
    ("conservative", 1000), ("bilinear", None), ("nearest", 1000)])
def test_regrid_matches_the_script(store, method, time_chunk_size):
  tmp, path = store
  flag_values = dict(input_path=path, latitude_nodes=5, longitude_nodes=8,
                     regridding_method=method,
                     latitude_spacing="EQUIANGULAR_WITH_POLES",
                     longitude_scheme="CENTER_AT_ZERO")
  if time_chunk_size:
    flag_values["time_chunk_size"] = time_chunk_size
  tag = f"{method}_{time_chunk_size}"
  want, got = str(tmp / f"regrid_ref_{tag}"), str(tmp / f"regrid_{tag}")
  run_reference(reference_regrid, output_path=want, **flag_values)
  counts = regrid_cli.main(as_argv(output_path=got, **flag_values))
  assert counts["blocks"] == (3 if time_chunk_size else 1)  # 2924 times
  assert counts["read_bytes"] > 0 and counts["h2d_bytes"] > 0
  assert_stores_close(got, want)


# -- compute_quantiles --------------------------------------------------------


@pytest.mark.parametrize("skipna,working_chunks", [
    (True, "latitude=3"), (False, "")])
def test_compute_quantiles_matches_the_script(store, skipna, working_chunks):
  tmp, path = store
  flag_values = dict(input_path=path, quantiles=["0.1", "0.5", "0.9"],
                     dim=["time"], skipna=skipna, name_suffix="_quantile",
                     time_start="2019-01-01", time_stop="2019-12-31")
  tag = f"{skipna}_{working_chunks}"
  want, got = str(tmp / f"q_ref_{tag}"), str(tmp / f"q_{tag}")
  run_reference(reference_quantiles, output_path=want,
                working_chunks=working_chunks, **flag_values)
  argv = as_argv(output_path=got, **flag_values)
  counts = quantiles_cli.main(argv + [f"--working_chunks={working_chunks}"])
  assert counts["tiles"] == (3 if working_chunks else 1)
  assert_stores_close(got, want)
  t2 = jxds.open_zarr(got)["2m_temperature_quantile"].values
  assert np.isnan(t2).any() != skipna  # a NaN poisons its pencil


def test_compute_quantiles_refuses_an_empty_selection(store):
  tmp, path = store
  with pytest.raises(SystemExit, match="selection left dimensions empty"):
    quantiles_cli.main(as_argv(input_path=path, output_path=str(tmp / "e"),
                               quantiles=["0.5"], dim=["time"],
                               time_start="1990-01-01",
                               time_stop="1990-12-31"))


# -- compute_climatology ------------------------------------------------------


CLIMATOLOGY_CASES = {
    "hourly_explicit": ("hourly", "explicit", "mean,std,quantile,seeps", ""),
    "daily_explicit_tiles": ("daily", "explicit", "mean,std,quantile,seeps",
                             "longitude=5"),
    "hourly_fast_tiles": ("hourly", "fast", "mean,std", "longitude=5"),
    "daily_fast": ("daily", "fast", "mean,std", ""),
}


def _climatology_rtol(name):
  return 1e-4 if name.endswith("_std") else RTOL


@pytest.mark.parametrize("case", list(CLIMATOLOGY_CASES))
def test_compute_climatology_matches_the_script(store, case):
  tmp, path = store
  frequency, method, statistics, working_chunks = CLIMATOLOGY_CASES[case]
  flag_values = dict(input_path=path, frequency=frequency, hour_interval=6,
                     window_size=15, start_year=2019, end_year=2020,
                     method=method, statistics=statistics.split(","),
                     quantiles=["0.2", "0.8"])
  want, got = str(tmp / f"clim_ref_{case}"), str(tmp / f"clim_{case}")
  run_reference(reference_climatology, output_path=want,
                working_chunks=working_chunks, **flag_values)
  counts = climatology_cli.main(as_argv(output_path=got, **flag_values)
                                + [f"--working_chunks={working_chunks}"])
  assert counts["tiles"] == (3 if working_chunks else 1)
  assert_stores_close(got, want, _climatology_rtol)
  out = jxds.open_zarr(got)
  if "seeps" in statistics:
    dry = np.asarray(out[f"{TP24}_seeps_dry_fraction"].values)
    assert 0.1 < np.nanmean(dry) < 0.9  # dry and wet days both


def test_compute_climatology_refuses_time_tiles(store):
  tmp, path = store
  with pytest.raises(ValueError, match="cannot include 'time'"):
    climatology_cli.main(as_argv(input_path=path,
                                 output_path=str(tmp / "t"))
                         + ["--working_chunks=time=10"])


# -- flags and devices --------------------------------------------------------


@pytest.mark.parametrize("port,reference", [
    (regrid_cli, reference_regrid), (quantiles_cli, reference_quantiles),
    (climatology_cli, reference_climatology)])
def test_parser_defaults_are_the_scripts(port, reference):
  parser = port.build_parser()
  names = {a.dest for a in parser._actions if a.dest != "help"}
  holders = [h for h in vars(reference).values()
             if all(hasattr(h, a) for a in ("name", "default", "value"))]
  defaults = {h.name: h.default for h in holders}
  assert set(defaults) == names - {"device"}
  assert parser.get_default("device") is None  # the card
  for name, want in defaults.items():
    if name in ("output_chunks", "working_chunks"):
      want = (flag_utils.parse_chunks(want) if isinstance(want, str)
              else dict(want))
    assert parser.get_default(name) == want, name


@pytest.mark.parametrize("cli,more", [
    (regrid_cli, ["--latitude_nodes=5", "--longitude_nodes=8"]),
    (quantiles_cli, ["--quantiles=0.5", "--dim=time"]),
    (climatology_cli, [])])
def test_the_clis_run_on_the_card_unless_asked(cli, more, store,
                                               monkeypatch):
  tmp, path = store
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    cli.main([f"--input_path={path}", f"--output_path={tmp / 'none'}"]
             + more)

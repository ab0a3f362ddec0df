"""The port's ``evaluate`` CLI against ``scripts/evaluate.py``, on the CPU.

Both CLIs run on the same uncompressed stores (those of
``tests/test_torch_official_configs.py``: wind components, precipitation
with NaNs, SEEPS climatology, a ``land_sea_mask`` in the obs store; for the
eight probabilistic configs those of ``tests/test_torch_probabilistic.py``:
a 5-member ensemble and a Gaussian forecast with NaNs, a climatology with
``_std`` and ``_quantile`` fields), the
reference one under ``flagsaver`` as ``tests/test_evaluate_cli.py`` runs
it, the port's through ``weatherbench2_torch.cli.evaluate.main`` with
``--device=cpu``.  Results are held to ``rtol=1e-5`` plus
``atol=1e-5 x max|reference|`` per variable, as in
``tests/test_torch_evaluation.py`` (float32 sums on the port's side,
float64 on the reference's under the tests' x64).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from absl import flags
from absl.testing import flagsaver

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import evaluate as reference_cli  # noqa: E402

from tests import test_torch_derived_eval as derived  # noqa: E402
from tests import test_torch_probabilistic as probabilistic  # noqa: E402
from tests.test_torch_official_configs import (  # noqa: E402
    PRECIP, VARIABLES, assert_results_close, build_stores, open_result)
from weatherbench2_tpu import flag_utils as jflag_utils  # noqa: E402
from weatherbench2_torch import flag_utils  # noqa: E402
from weatherbench2_torch.cli import evaluate as cli  # noqa: E402

FLAGS = flags.FLAGS
FLAGS.mark_as_parsed()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOUR = ["deterministic", "deterministic_spatial", "deterministic_temporal",
        "deterministic_vs_analysis"]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_cli")
  return tmp, build_stores(str(tmp))


def _reference_flags(paths, out_dir, **more):
  return dict(
      forecast_path=paths["forecast"], obs_path=paths["truth"],
      climatology_path=paths["climatology"], output_dir=str(out_dir),
      variables=VARIABLES, time_start="2020-02-24",
      time_stop="2020-03-02T12", **more)


def _port_args(paths, out_dir, *more, climatology=True):
  args = [f"--forecast_path={paths['forecast']}",
          f"--obs_path={paths['truth']}", f"--output_dir={out_dir}",
          "--variables=" + ",".join(VARIABLES), "--time_start=2020-02-24",
          "--time_stop=2020-03-02T12", "--device=cpu", *more]
  if climatology:
    args.append(f"--climatology_path={paths['climatology']}")
  return args


@pytest.fixture(scope="module")
def cli_runs(stores):
  """The four configs with wind vectors, SEEPS and ``--regions=all``,
  through both CLIs: streaming (``--use_mesh``) and in memory."""
  tmp, paths = stores
  runs = {}
  for engine, use_mesh in (("mesh", True), ("memory", False)):
    with flagsaver.flagsaver(**_reference_flags(
        paths, tmp / f"ref_{engine}", eval_configs=",".join(FOUR),
        regions=["all"], compute_seeps=True, use_mesh=use_mesh,
        input_chunks={"init_time": 4})):
      reference_cli.main([])
    runs[f"port_{engine}_stats"] = cli.main(_port_args(
        paths, tmp / f"port_{engine}", "--eval_configs=" + ",".join(FOUR),
        "--regions=all", "--compute_seeps", "--input_chunks=init_time=4",
        *(["--use_mesh"] if use_mesh else [])))
    for side in ("ref", "port"):
      runs[f"{side}_{engine}"] = {
          name: open_result(tmp / f"{side}_{engine}", name) for name in FOUR}
  return runs


def _common_regions(got, want):
  """``got`` cut to the regions of ``want``, by label."""
  if "region" not in want.sizes:
    return got
  names = list(np.asarray(got.coords_dict()["region"].data))
  wanted = list(np.asarray(want.coords_dict()["region"].data))
  return got.isel(region=np.asarray([names.index(n) for n in wanted]))


@pytest.mark.parametrize("name", FOUR)
@pytest.mark.parametrize("engine", ["mesh", "memory"])
def test_cli_matches_reference_cli(cli_runs, engine, name):
  want = cli_runs[f"ref_{engine}"][name]
  got = _common_regions(cli_runs[f"port_{engine}"][name], want)
  assert_results_close(got, want, f"{engine}/{name}")
  if name != "deterministic_spatial":
    assert "wind_vector" in got.keys()
    assert "seeps_24hr" in list(np.asarray(got.coords_dict()["metric"].data))


@pytest.mark.parametrize("name", FOUR)
def test_cli_in_memory_equals_streaming(cli_runs, name):
  assert_results_close(cli_runs["port_mesh"][name],
                       cli_runs["port_memory"][name], name)


def test_cli_returns_the_engines_counts(cli_runs):
  # 16 inits in chunks of 4, one stream for the three configs that share
  # their inputs and one for deterministic_vs_analysis
  assert cli_runs["port_mesh_stats"]["chunks"] == 8
  assert cli_runs["port_memory_stats"] is None


def test_land_sea_mask_in_the_obs_store_is_found(cli_runs):
  """Pins a divergence from ``scripts/evaluate.py:438``: the reference's
  probe uses ``np`` without importing numpy, swallows the NameError and
  never finds a mask in the obs store (thirteen regions); the port's CLI
  does what was meant and writes sixteen."""
  assert not hasattr(reference_cli, "np")
  ref = cli_runs["ref_mesh"]["deterministic"]
  port = cli_runs["port_mesh"]["deterministic"]
  ref_regions = list(np.asarray(ref.coords_dict()["region"].data))
  port_regions = list(np.asarray(port.coords_dict()["region"].data))
  assert len(ref_regions) == 13 and len(port_regions) == 16
  assert port_regions[:13] == ref_regions
  assert port_regions[13:] == ["global_land", "extra-tropics_land",
                               "tropics_land"]
  land = port["geopotential"].isel(metric=0, region=13).values
  assert np.isfinite(land).all()
  assert not np.allclose(
      land, port["geopotential"].isel(metric=0, region=0).values)


def test_lsm_dataset_flag(stores):
  tmp, paths = stores
  args = cli.build_parser().parse_args(
      _port_args(paths, tmp / "x", f"--lsm_dataset={paths['truth']}"))
  mask = cli.probe_land_sea_mask(args)
  assert set(mask.dims) == {"longitude", "latitude"}
  assert isinstance(mask.data, np.ndarray)
  # a store without a mask gives none; a named one that fails raises
  args = cli.build_parser().parse_args(
      _port_args(paths, tmp / "x", f"--lsm_dataset={paths['forecast']}"))
  assert cli.probe_land_sea_mask(args) is None
  args = cli.build_parser().parse_args(
      _port_args(paths, tmp / "x", f"--lsm_dataset={tmp / 'missing.zarr'}"))
  with pytest.raises(Exception):
    cli.probe_land_sea_mask(args)


def test_cli_named_regions_and_no_regions(stores):
  tmp, paths = stores
  cli.main(_port_args(paths, tmp / "named", "--regions=tropics,global",
                      "--use_mesh", "--input_chunks=init_time=8"))
  got = open_result(tmp / "named", "deterministic")
  assert list(np.asarray(got.coords_dict()["region"].data)) == [
      "global", "tropics"]
  assert list(np.asarray(got.coords_dict()["metric"].data)) == [
      "mse", "acc", "bias", "mae"]
  cli.main(_port_args(paths, tmp / "none", "--use_mesh"))
  assert "region" not in open_result(tmp / "none", "deterministic").sizes


def test_cli_missing_climatology_clear_error(stores):
  tmp, paths = stores
  with pytest.raises(ValueError, match="climatology_path"):
    cli.main(_port_args(paths, tmp / "noclim", "--regions=global",
                        climatology=False))
  with pytest.raises(ValueError, match="compute_seeps"):
    cli.main(_port_args(paths, tmp / "noclim", "--regions=global",
                        "--compute_seeps", climatology=False))
  # the spatial config needs none
  cli.main(_port_args(paths, tmp / "noclim",
                      "--eval_configs=deterministic_spatial", "--use_mesh",
                      climatology=False))
  assert os.path.exists(tmp / "noclim" / "deterministic_spatial.zarr")


# -- the eight probabilistic configs ---------------------------------------------


@pytest.fixture(scope="module")
def prob_stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_cli_probabilistic")
  return tmp, probabilistic.build_stores(str(tmp))


def _prob_flags(paths, out_dir, names, method):
  gaussian = names[0].startswith("gaussian")
  return dict(
      forecast_path=paths["gaussian" if gaussian else "ensemble"],
      obs_path=paths["truth"], climatology_path=paths["climatology"],
      output_dir=str(out_dir), variables=probabilistic.VARIABLES,
      aux_variables=probabilistic.AUX if gaussian else None,
      levels=["500", "850"], time_start="2020-01-01",
      time_stop="2020-01-10", eval_configs=",".join(names),
      regions=["global", "tropics", "extra-tropics"],
      ensemble_dim="realization", threshold_method=method,
      quantile_thresholds=[str(q) for q in probabilistic.QUANTILES])


def _port_prob_args(flags, use_mesh):
  args = [f"--{k}={','.join(v) if isinstance(v, list) else v}"
          for k, v in flags.items() if v is not None]
  return args + ["--device=cpu", "--input_chunks=init_time=4"] + (
      ["--use_mesh"] if use_mesh else [])


def _run_prob_clis(tmp, paths, tag, method, use_mesh):
  """The eight configs through both CLIs (the ensemble configs in one call,
  the Gaussian ones in another); {side: {config: results}}."""
  out = {}
  for side in ("ref", "port"):
    out_dir = tmp / f"{side}_{tag}"
    for names in (probabilistic.ENSEMBLE_CONFIGS,
                  probabilistic.GAUSSIAN_CONFIGS):
      flags = _prob_flags(paths, out_dir, names, method)
      if side == "ref":
        with flagsaver.flagsaver(**flags, use_mesh=use_mesh,
                                 input_chunks={"init_time": 4}):
          reference_cli.main([])
      else:
        cli.main(_port_prob_args(flags, use_mesh))
    out[side] = {n: open_result(out_dir, n) for n in probabilistic.CONFIGS}
  return out


@pytest.fixture(scope="module")
def prob_cli_runs(prob_stores):
  tmp, paths = prob_stores
  return {engine: _run_prob_clis(tmp, paths, engine, "quantile",
                                 engine == "mesh")
          for engine in ("mesh", "memory")}


@pytest.mark.parametrize("name", probabilistic.CONFIGS)
@pytest.mark.parametrize("engine", ["mesh", "memory"])
def test_cli_probabilistic_config_matches_reference_cli(prob_cli_runs,
                                                        engine, name):
  """Each of the eight config names, with --ensemble_dim and the quantile
  thresholds of --quantile_thresholds, through both CLIs."""
  # the name is one of the reference CLI's
  assert f'"{name}": config.Eval(' in open(
      os.path.join(REPO, "scripts", "evaluate.py")).read()
  got = prob_cli_runs[engine]["port"][name]
  want = prob_cli_runs[engine]["ref"][name]
  assert_results_close(got, want, f"{engine}/{name}")
  if name in ("ensemble_binary", "gaussian_binary",
              "ensemble_binary_spatial"):
    np.testing.assert_array_equal(
        np.asarray(got.coords_dict()["quantile"].data),
        probabilistic.QUANTILES)


def test_cli_gaussian_quantile_thresholds_match_reference_cli(prob_stores):
  """--threshold_method=gaussian_quantile: thresholds from the
  climatology's mean and ``_std``."""
  tmp, paths = prob_stores
  runs = _run_prob_clis(tmp, paths, "gaussian_quantile", "gaussian_quantile",
                        True)
  for name in ("ensemble_binary", "gaussian_binary"):
    assert_results_close(runs["port"][name], runs["ref"][name], name)
  with pytest.raises(NotImplementedError, match="Unknown threshold method"):
    cli.main(_port_prob_args(_prob_flags(
        paths, tmp / "bad_method", ["ensemble_binary"], "other"), True))


@pytest.mark.parametrize("flag,item", [("--n_devices=4", "A.12")])
def test_cli_unported_flag_names_its_roadmap_item(stores, flag, item):
  """The flag of ``item`` is ported (its runs are in
  tests/test_torch_mesh.py): it shards the streaming engine, so without
  ``--use_mesh`` it is refused by name rather than ignored."""
  tmp, paths = stores
  assert item == "A.12"
  with pytest.raises(ValueError, match="add --use_mesh"):
    cli.main(_port_args(paths, tmp / "unported_flag", flag))


# -- derived variables and the probabilistic climatology ---------------------


def _run_both_clis(flag_values, out_dir, use_mesh, configs):
  """The reference CLI under flagsaver and the port's, on the CPU, with
  the same flags; {side: {config: results}}."""
  out = {}
  for side in ("ref", "port"):
    values = dict(flag_values, output_dir=str(out_dir / side),
                  eval_configs=",".join(configs))
    if side == "ref":
      with flagsaver.flagsaver(**values, use_mesh=use_mesh):
        reference_cli.main([])
    else:
      cli.main(_port_prob_args(values, use_mesh))
    out[side] = {n: open_result(out_dir / side, n) for n in configs}
  return out


@pytest.fixture(scope="module")
def derived_stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_cli_derived")
  return tmp, derived.build_stores(str(tmp)), derived.build_years_stores(
      str(tmp / "years"))


@pytest.mark.parametrize("engine", ["mesh", "memory"])
def test_cli_derived_variables_match_reference_cli(derived_stores, engine):
  """--derived_variables=wind_speed,10m_wind_speed: the base winds join
  the selection, the derived ones are scored (MSE, ACC, bias, MAE, the
  wind-vector errors of the present pairs) in every region."""
  tmp, paths, _ = derived_stores
  configs = ["deterministic", "deterministic_temporal"]
  runs = _run_both_clis(dict(
      forecast_path=paths["forecast"], obs_path=paths["truth"],
      climatology_path=paths["climatology"], variables=["2m_temperature"],
      derived_variables=["wind_speed", "10m_wind_speed"],
      levels=["500", "850"], time_start="2020-01-01",
      time_stop="2020-01-04T12", regions=["global", "tropics"]),
      tmp / f"derived_{engine}", engine == "mesh", configs)
  for name in configs:
    got, want = runs["port"][name], runs["ref"][name]
    assert_results_close(got, want, f"{engine}/{name}")
    assert {"wind_speed", "10m_wind_speed", "u_component_of_wind",
            "10m_v_component_of_wind"} <= set(got.keys())
    assert np.isfinite(got["10m_wind_speed"].values).all()


@pytest.mark.parametrize("engine", ["mesh", "memory"])
def test_cli_probabilistic_climatology_matches_reference_cli(derived_stores,
                                                             engine):
  """--evaluate_probabilistic_climatology over 2018-2019 at hour interval
  24: the `probabilistic` config scores the years as members."""
  tmp, _, paths = derived_stores
  configs = ["probabilistic"]
  runs = _run_both_clis(dict(
      forecast_path=paths["forecast"], obs_path=paths["truth"],
      variables=["2m_temperature"], time_start="2020-01-01",
      time_stop="2020-01-12", regions=["global", "tropics"],
      evaluate_probabilistic_climatology=True,
      probabilistic_climatology_start_year=2018,
      probabilistic_climatology_end_year=2019,
      probabilistic_climatology_hour_interval=24),
      tmp / f"prob_clim_{engine}", engine == "mesh", configs)
  got = runs["port"]["probabilistic"]
  assert_results_close(got, runs["ref"]["probabilistic"], engine)
  assert np.isfinite(got["2m_temperature"].values).all()


def test_cli_unknown_config_name_raises(stores):
  tmp, paths = stores
  with pytest.raises(ValueError, match="not a subset"):
    cli.main(_port_args(paths, tmp / "unknown", "--eval_configs=nonsense"))


def test_cli_per_time_config_with_checkpoint_fails_fast(stores):
  tmp, paths = stores
  with pytest.raises(ValueError, match="requires temporal_mean=True"):
    cli.main(_port_args(
        paths, tmp / "temporal_ckpt", "--eval_configs=deterministic_temporal",
        "--regions=global", "--use_mesh",
        f"--checkpoint_path={tmp / 'temporal_ckpt_state'}",
        "--checkpoint_every=1"))
  assert not os.path.exists(tmp / "temporal_ckpt")


def test_cli_runs_on_the_card_unless_asked(stores, monkeypatch):
  tmp, paths = stores
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  args = [a for a in _port_args(paths, tmp / "nocard", "--regions=global")
          if a != "--device=cpu"]
  for more in ([], ["--use_mesh"]):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      cli.main(args + more)


def test_cli_baseline_flags(stores):
  """``--evaluate_persistence`` through both engines of the port's CLI."""
  tmp, paths = stores
  for engine, more in (("mesh", ["--use_beam"]), ("memory", [])):
    cli.main(_port_args(paths, tmp / f"persist_{engine}", "--regions=global",
                        "--evaluate_persistence", *more))
  a = open_result(tmp / "persist_mesh", "deterministic")
  b = open_result(tmp / "persist_memory", "deterministic")
  assert_results_close(a, b, "persistence")
  np.testing.assert_array_equal(
      a["geopotential"].isel(metric=0, lead_time=0).values, 0.0)


def test_cli_as_a_module(stores):
  tmp, paths = stores
  env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
  proc = subprocess.run(
      [sys.executable, "-m", "weatherbench2_torch.cli.evaluate",
       *_port_args(paths, tmp / "module", "--regions=global", "--use_mesh",
                   "--nocompute_seeps", "--skipna=true")],
      cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stderr[-2000:]
  got = open_result(tmp / "module", "deterministic")
  assert np.isfinite(got[PRECIP].values).all()  # skipna was taken


def test_parser_defaults_are_the_reference_flags(stores):
  """Every flag that ``scripts/evaluate.py`` defines exists in the port's
  parser with the same default; the port adds ``--device``."""
  defaults = vars(cli.build_parser().parse_args([]))
  holders = [v for v in vars(reference_cli).values()
             if type(v).__name__.endswith("FlagHolder")]
  names = {h.name for h in holders}
  assert len(names) == 38
  assert set(defaults) == names | {"device"}
  for h in holders:
    assert defaults[h.name] == h.default, h.name
  assert defaults["device"] is None


@pytest.mark.parametrize("text", ["", "time=10", "time=10,longitude=-1",
                                  "init_time=16,lead_time=7"])
def test_parse_chunks_matches(text):
  assert flag_utils.parse_chunks(text) == jflag_utils.parse_chunks(text)


@pytest.mark.parametrize("text", ["time", "time=a", "time=1,,x=2", "a=1.5"])
def test_parse_chunks_refuses(text):
  with pytest.raises(ValueError):
    jflag_utils.parse_chunks(text)
  with pytest.raises(ValueError):
    flag_utils.parse_chunks(text)


@pytest.mark.parametrize("text", ["", "level=500", "level=500,lat=-2.5",
                                  "name=abc,n=1e3,d=2020-01-01"])
def test_parse_dim_value_pairs_matches(text):
  got = flag_utils.parse_dim_value_pairs(text)
  want = jflag_utils.parse_dim_value_pairs(text)
  assert got == want
  assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
  for value in text.replace("=", ",").split(","):
    assert flag_utils.get_dim_value(value) == jflag_utils.get_dim_value(value)

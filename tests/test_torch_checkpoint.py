"""Checkpoint/resume of the port's streaming engine, on the CPU.

Counterpart of ``tests/test_checkpoint_round4.py`` and
``tests/test_checkpoint_order.py``.  A run is stopped in the middle (the
process dies right after a state file has been put in place: in process,
by an exception out of the snapshot thread's ``os.replace``; and once for
real, a child process that ``os._exit``s there), then a second call resumes
from the file and must write results equal BIT FOR BIT to the
uninterrupted run's: the same float64 sums in the same order.

Where a run that the JAX package began is finished by the port, the
tolerance is that of ``tests/test_torch_evaluation.py``: ``rtol=1e-5`` plus
``atol=1e-5 x max|reference|`` per variable (the port reduces each chunk in
float32, the JAX run here in float64).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from weatherbench2_tpu import config as jconfig
from weatherbench2_tpu import evaluation as jevaluation
from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import utils as jutils
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.parallel import streaming as jstreaming
from weatherbench2_tpu.regions import ExtraTropicalRegion, SliceRegion
from weatherbench2_torch import convert
from weatherbench2_torch import evaluation
from weatherbench2_torch import xds
from weatherbench2_torch.parallel import streaming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
VARIABLES = ["10m_u_component_of_wind", "10m_v_component_of_wind"]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  """10 daily inits x 4 daily leads of two 2-d variables at 30 degrees."""
  tmp = tmp_path_factory.mktemp("torch_checkpoint")
  kwargs = dict(variables_3d=[], variables_2d=VARIABLES,
                spatial_resolution_in_degrees=30.0, time_start="2020-01-01")
  truth = jutils.random_like(
      jschema.mock_truth_data(time_stop="2020-01-25", **kwargs), seed=0)
  forecast = jutils.random_like(
      jschema.mock_forecast_data(lead_stop="3 days", time_stop="2020-01-13",
                                 **kwargs), seed=1)
  paths = {"truth": str(tmp / "t.zarr"), "forecast": str(tmp / "f.zarr")}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    jxds.to_zarr(truth, paths["truth"])
    jxds.to_zarr(forecast, paths["forecast"])
  return tmp, paths


def _data_config(paths, out_dir, stop="2020-01-10"):
  return jconfig.Data(
      selection=jconfig.Selection(variables=VARIABLES,
                                  time_slice=slice("2020-01-01", stop)),
      paths=jconfig.Paths(forecast=paths["forecast"], obs=paths["truth"],
                          output_dir=str(out_dir)),
      by_init=True)


def _configs(which):
  """Reference-package configs: one, a group of two that share a stream,
  or a per-cell (``Spatial*``) one without regions."""
  wind = [jmetrics.WindVectorMSE(*VARIABLES, "10m_wind_vector")]
  det = jconfig.Eval(
      metrics={"mse": jmetrics.MSE(wind_vector_mse=wind),
               "bias": jmetrics.Bias()},
      regions={"global": SliceRegion()})
  extra = jconfig.Eval(
      metrics={"mae": jmetrics.MAE()},
      regions={"global": SliceRegion(),
               "extratropics": ExtraTropicalRegion()})
  spatial = jconfig.Eval(metrics={"mse": jmetrics.SpatialMSE(),
                                  "bias": jmetrics.SpatialBias()})
  return {"single": {"det": det},
          "grouped": {"det": det, "det_extra": extra},
          "spatial": {"det": det, "spatial": spatial}}[which]


def _run(paths, out_dir, cfgs, chunks, stop="2020-01-10", **kw):
  return evaluation.evaluate_with_mesh(
      convert.from_reference(_data_config(paths, out_dir, stop)),
      convert.eval_configs_from_reference(cfgs), device="cpu",
      input_chunks=chunks, **kw)


class _Died(Exception):
  """Stands for the death of the process."""


def _die_after(monkeypatch, n_snapshots):
  """Make the engine's ``os.replace`` raise once it has put the n-th state
  file in place: the run ends there, the file stays."""
  real = os.replace
  seen = []

  def replace(src, dst):
    real(src, dst)
    seen.append(dst)
    if len(seen) == n_snapshots:
      raise _Died(dst)

  monkeypatch.setattr(streaming.os, "replace", replace)
  return lambda: monkeypatch.setattr(streaming.os, "replace", real)


def _assert_identical(got_dir, want_dir, cfgs):
  for name in cfgs:
    got = xds.open_netcdf(os.path.join(str(got_dir), f"{name}.nc"))
    want = xds.open_netcdf(os.path.join(str(want_dir), f"{name}.nc"))
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
      assert got[k].dims == want[k].dims
      np.testing.assert_array_equal(got[k].values, want[k].values,
                                    err_msg=f"{name}/{k}")


# which configs, input chunks, snapshots before the death, and the state
# that the death leaves: (lead_index, chunk_index)
RESUME_CASES = {
    "single": ("single", {"init_time": 4}, 2, (0, 2)),
    "grouped": ("grouped", {"init_time": 4}, 1, (0, 1)),
    "lead_chunked_first_slice": (
        "grouped", {"init_time": 2, "lead_time": 2}, 3, (0, 3)),
    "lead_chunked_second_slice": (
        "grouped", {"init_time": 4, "lead_time": 2}, 4, (1, 1)),
    "lead_chunked_ragged_leads": (
        "single", {"init_time": 4, "lead_time": 3}, 5, (1, 2)),
    # 10 inits in chunks of 4: the state of the last, ragged chunk covers
    # the whole range although chunk_index * chunk_size > total
    "ragged_last_chunk": ("grouped", {"init_time": 4}, 3, (0, 3)),
    "per_cell_accumulators": ("spatial", {"init_time": 3}, 2, (0, 2)),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_kill_and_resume_equals_uninterrupted(stores, monkeypatch, case):
  tmp, paths = stores
  which, chunks, n_snapshots, left = RESUME_CASES[case]
  cfgs = _configs(which)
  full = tmp / f"{case}_full"
  stats_full = _run(paths, full, cfgs, chunks)

  cpath = str(tmp / f"{case}_ckpt")
  state_file = cpath + "." + "+".join(sorted(cfgs))
  restore = _die_after(monkeypatch, n_snapshots)
  with pytest.raises(_Died):
    _run(paths, tmp / f"{case}_killed", cfgs, chunks, checkpoint_path=cpath,
         checkpoint_every=1)
  restore()
  assert not os.path.exists(tmp / f"{case}_killed" / "det.nc")
  state = streaming.StreamingState.load(state_file)
  assert (state.lead_index, state.chunk_index) == left
  assert set(state.configs) == set(cfgs)
  assert state.chunk_size == chunks["init_time"] and state.total == 10
  assert len(state.completed_leads) == left[0]
  if case == "ragged_last_chunk":
    assert state.chunk_index * state.chunk_size > state.total
  if len(cfgs) == 1:  # the version-1 fields stay filled for one config
    assert state.sums is not None and state.counts is not None
  else:
    assert state.sums is None

  resumed = tmp / f"{case}_resumed"
  stats = _run(paths, resumed, cfgs, chunks, checkpoint_path=cpath,
               checkpoint_every=1)
  n_leads = stats_full["chunks"] // -(-10 // chunks["init_time"])
  done = left[0] * (stats_full["chunks"] // n_leads) + left[1]
  assert stats["chunks"] == stats_full["chunks"] - done
  _assert_identical(resumed, full, cfgs)


_CHILD = """
import os, pickle, sys
sys.path.insert(0, {repo!r})
real = os.replace
def replace(src, dst):
  real(src, dst)
  with open(dst, "rb") as f:
    if pickle.load(f)["chunk_index"] >= 2:
      os._exit(9)  # the process dies here, with no clean-up at all
os.replace = replace
from weatherbench2_torch.cli import evaluate
evaluate.main({argv!r})
"""


def _cli_args(paths, out_dir, cpath=None):
  args = [f"--forecast_path={paths['forecast']}",
          f"--obs_path={paths['truth']}", f"--output_dir={out_dir}",
          "--variables=" + ",".join(VARIABLES), "--time_start=2020-01-01",
          "--time_stop=2020-01-10", "--eval_configs=deterministic_spatial",
          "--use_mesh", "--input_chunks=init_time=3", "--device=cpu"]
  if cpath:
    args += [f"--checkpoint_path={cpath}", "--checkpoint_every=1"]
  return args


def test_killed_process_resumes_through_the_cli(stores):
  """A child process runs the CLI and dies hard once the state of the
  second chunk is in place; a second CLI call finishes the run."""
  from weatherbench2_torch.cli import evaluate as cli

  tmp, paths = stores
  cpath = str(tmp / "hard_kill_ckpt")
  script = tmp / "child.py"
  script.write_text(_CHILD.format(
      repo=REPO, argv=_cli_args(paths, tmp / "hard_killed", cpath)))
  env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
  proc = subprocess.run([sys.executable, str(script)], env=env, timeout=600,
                        capture_output=True, text=True)
  assert proc.returncode == 9, proc.stderr[-2000:]
  state_file = cpath + ".deterministic_spatial"
  state = streaming.StreamingState.load(state_file)
  assert state.chunk_index == 2
  assert not os.path.exists(tmp / "hard_killed" / "deterministic_spatial.zarr")

  stats = cli.main(_cli_args(paths, tmp / "hard_resumed", cpath))
  assert stats["chunks"] == 2  # chunks 3 and 4 of 4
  cli.main(_cli_args(paths, tmp / "hard_full"))
  got = xds.open_zarr(str(tmp / "hard_resumed" / "deterministic_spatial.zarr"))
  want = xds.open_zarr(str(tmp / "hard_full" / "deterministic_spatial.zarr"))
  for k in want.keys():
    np.testing.assert_array_equal(got[k].values, want[k].values, err_msg=k)


def _opened(paths, out_dir, cfgs):
  dc = convert.from_reference(_data_config(paths, out_dir))
  port_cfgs = convert.eval_configs_from_reference(cfgs)
  forecast, truth, clim = evaluation.open_forecast_and_truth_datasets(
      dc, next(iter(port_cfgs.values())), lazy=True)
  return forecast, truth, clim, port_cfgs, dc


def _some_state(stores, monkeypatch, tag, which="single", chunks=None):
  """The state that a run leaves when it dies after its second snapshot."""
  tmp, paths = stores
  cpath = str(tmp / f"{tag}_ckpt")
  cfgs = _configs(which)
  restore = _die_after(monkeypatch, 2)
  with pytest.raises(_Died):
    _run(paths, tmp / f"{tag}_killed", cfgs, chunks or {"init_time": 4},
         checkpoint_path=cpath, checkpoint_every=1)
  restore()
  return cpath, cpath + "." + "+".join(sorted(cfgs))


REFUSALS = {
    "chunk_size": (dict(), {"init_time": 2}, "single", "chunk_size=4"),
    "lead_slices": (dict(n_lead_slices=2), {"init_time": 4, "lead_time": 1},
                    "single", "lead slices"),
    "config_group": (dict(), {"init_time": 4}, "grouped", "covers configs"),
    "no_accumulators": (dict(configs=None, sums=None, counts=None),
                        {"init_time": 4}, "single", "no accumulators"),
    "too_many_chunks": (dict(chunk_index=7), {"init_time": 4}, "single",
                        "has only 10 entries"),
    "lead_index_beyond": (dict(lead_index=3, n_lead_slices=None),
                          {"init_time": 4, "lead_time": 2}, "single",
                          "does not fit a run of 2 lead slices"),
    "completed_slices_missing": (
        dict(lead_index=1, n_lead_slices=2, completed_leads=[]),
        {"init_time": 4, "lead_time": 2}, "single", "completed slices"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_resume_refuses_a_state_that_does_not_fit(stores, monkeypatch, case):
  tmp, paths = stores
  changes, chunks, which, message = REFUSALS[case]
  _, state_file = _some_state(stores, monkeypatch, f"refuse_{case}")
  state = streaming.StreamingState.load(state_file)
  for k, v in changes.items():
    setattr(state, k, v)
  forecast, truth, clim, cfgs, dc = _opened(paths, tmp / "refused",
                                            _configs(which))
  with pytest.raises(ValueError, match=message):
    streaming.evaluate_streaming_multi(forecast, truth, clim, cfgs, dc,
                                       chunks, device="cpu", state=state)


def test_legacy_state_into_grouped_run_raises(stores):
  tmp, paths = stores
  forecast, truth, clim, cfgs, dc = _opened(paths, tmp / "legacy",
                                            _configs("grouped"))
  legacy = streaming.StreamingState(sums={"x": 1}, counts={"x": 1},
                                    chunk_index=1, chunk_size=4)
  with pytest.raises(ValueError, match="legacy single-config"):
    streaming.evaluate_streaming_multi(forecast, truth, clim, cfgs, dc,
                                       {"init_time": 4}, device="cpu",
                                       state=legacy)


@pytest.mark.parametrize("through", ["evaluate_with_mesh", "engine_state",
                                     "engine_path"])
def test_per_time_config_refuses_checkpoints(stores, through):
  """``temporal_mean=False`` results are not in the state: refused before
  anything streams."""
  tmp, paths = stores
  cfgs = _configs("single")
  cfgs["det"].temporal_mean = False
  out = tmp / f"per_time_{through}"
  if through == "evaluate_with_mesh":
    with pytest.raises(ValueError, match="requires temporal_mean=True"):
      _run(paths, out, cfgs, {"init_time": 4},
           checkpoint_path=str(tmp / "per_time_ckpt"))
    assert not os.path.exists(out)
    return
  forecast, truth, clim, port_cfgs, dc = _opened(paths, out, cfgs)
  kw = (dict(state=streaming.StreamingState()) if through == "engine_state"
        else dict(checkpoint_path=str(tmp / "per_time_ckpt2"),
                  checkpoint_every=1))
  with pytest.raises(ValueError, match="requires temporal_mean=True"):
    streaming.evaluate_streaming_multi(forecast, truth, clim, port_cfgs, dc,
                                       {"init_time": 4}, device="cpu", **kw)


def _walk(tree, found):
  if isinstance(tree, dict):
    for v in tree.values():
      _walk(v, found)
  elif isinstance(tree, (list, tuple)):
    for v in tree:
      _walk(v, found)
  elif isinstance(tree, xds.Dataset):
    found.extend(v.data for v in tree.variables_dict().values())
  elif tree is not None:
    found.append(tree)
  return found


def test_state_file_holds_the_ports_objects_with_numpy_payloads(
    stores, monkeypatch):
  _, state_file = _some_state(stores, monkeypatch, "payloads",
                              which="grouped",
                              chunks={"init_time": 2, "lead_time": 2})
  with open(state_file, "rb") as f:
    raw = pickle.load(f)
  assert raw["version"] == 2
  assert sorted(raw) == sorted([
      "version", "sums", "counts", "chunk_index", "chunk_size", "total",
      "configs", "lead_index", "n_lead_slices", "completed_leads"])
  payloads = _walk((raw["configs"], raw["completed_leads"]), [])
  assert payloads and all(isinstance(p, np.ndarray) for p in payloads)
  assert all(p.dtype == np.float64 for p in payloads)
  for sums, counts in raw["configs"].values():
    assert all(type(ds) is xds.Dataset for ds in sums.values())
    assert all(type(ds) is xds.Dataset for ds in counts.values())
  # tensors given to save() are fetched; load() gives the same fields back
  state = streaming.StreamingState(
      configs={"c": ({"m": xds.Dataset({"v": (("a",), torch.ones(3))})},
                     {"m": xds.Dataset({"v": (("a",), torch.ones(3))})})},
      chunk_index=3, chunk_size=4, total=20, lead_index=1, n_lead_slices=2,
      completed_leads=[{}])
  state.save(state_file + ".again")
  back = streaming.StreamingState.load(state_file + ".again")
  assert isinstance(back.configs["c"][0]["m"]["v"].data, np.ndarray)
  assert (back.chunk_index, back.chunk_size, back.total, back.lead_index,
          back.n_lead_slices, back.completed_leads) == (3, 4, 20, 1, 2, [{}])


def test_v1_shaped_state_loads_and_resumes(stores, monkeypatch):
  """A file with the version-1 fields only (one config's sums and counts,
  no version, no configs, no lead fields) loads and finishes the run."""
  tmp, paths = stores
  cpath, state_file = _some_state(stores, monkeypatch, "v1")
  with open(state_file, "rb") as f:
    raw = pickle.load(f)
  with open(state_file, "wb") as f:
    pickle.dump({k: raw[k] for k in ("sums", "counts", "chunk_index",
                                     "chunk_size", "total")}, f)
  state = streaming.StreamingState.load(state_file)
  assert state.chunk_index == 2 and state.configs is None
  assert state.lead_index == 0 and state.completed_leads is None
  assert state.n_lead_slices is None
  cfgs = _configs("single")
  _run(paths, tmp / "v1_resumed", cfgs, {"init_time": 4},
       checkpoint_path=cpath, checkpoint_every=1)
  _run(paths, tmp / "v1_full", cfgs, {"init_time": 4})
  _assert_identical(tmp / "v1_resumed", tmp / "v1_full", cfgs)


def _reverse_variables(tree, xds_mod):
  if isinstance(tree, dict):
    return {k: _reverse_variables(v, xds_mod) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_reverse_variables(v, xds_mod) for v in tree)
  if isinstance(tree, xds_mod.Dataset):
    names = list(tree.variables_dict())
    return xds_mod.Dataset(
        {n: tree.variables_dict()[n] for n in reversed(names)},
        coords=dict(tree.coords_dict()), attrs=tree.attrs)
  return tree


def test_resume_from_scrambled_variable_order(stores, monkeypatch):
  """A state whose Datasets list their variables in another order resumes,
  and the results keep this run's order."""
  tmp, paths = stores
  cpath, state_file = _some_state(stores, monkeypatch, "scrambled")
  state = streaming.StreamingState.load(state_file)
  before = list(state.configs["det"][0]["mse"].keys())
  state.configs = _reverse_variables(state.configs, xds)
  state.sums = state.counts = None
  assert list(state.configs["det"][0]["mse"].keys()) == before[::-1]
  state.save(state_file)
  cfgs = _configs("single")
  _run(paths, tmp / "scrambled_resumed", cfgs, {"init_time": 4},
       checkpoint_path=cpath, checkpoint_every=1)
  _run(paths, tmp / "scrambled_full", cfgs, {"init_time": 4})
  _assert_identical(tmp / "scrambled_resumed", tmp / "scrambled_full", cfgs)


def test_reorder_like_guards_with_the_reference_tree():
  """``_reorder_like`` passes a key of ``obj`` that ``ref`` lacks through.

  Records a divergence from ``weatherbench2_tpu/parallel/streaming.py:79``,
  whose guard reads ``k in obj`` (always true) where ``k in ref`` was
  meant, so that the reference raises KeyError on such a key.
  """
  mk = lambda mod, names: mod.Dataset(
      {n: (("a",), np.arange(2.0)) for n in names})
  ref = {"x": mk(xds, "pq")}
  obj = {"x": mk(xds, "qp"), "only_in_obj": mk(xds, "qp")}
  out = streaming._reorder_like(ref, obj)
  assert list(out["x"].keys()) == ["p", "q"]
  assert list(out["only_in_obj"].keys()) == ["q", "p"]
  assert list(out) == ["x", "only_in_obj"]
  with pytest.raises(KeyError):
    jstreaming._reorder_like({"x": mk(jxds, "pq")},
                             {"x": mk(jxds, "qp"),
                              "only_in_obj": mk(jxds, "qp")})
  # trees that agree are aligned alike on both sides
  both = jstreaming._reorder_like({"x": (mk(jxds, "pq"), None)},
                                  {"x": (mk(jxds, "qp"), None)})
  port = streaming._reorder_like({"x": (mk(xds, "pq"), None)},
                                 {"x": (mk(xds, "qp"), None)})
  assert list(both["x"][0].keys()) == list(port["x"][0].keys()) == ["p", "q"]
  # different variable sets, lengths and types pass through
  other = mk(xds, "pz")
  assert streaming._reorder_like(mk(xds, "pq"), other) is other
  assert streaming._reorder_like((1, 2), (3,)) == (3,)
  assert streaming._reorder_like(None, 5) == 5


@pytest.mark.parametrize("chunks", [{"init_time": 4},
                                    {"init_time": 4, "lead_time": 2}])
def test_port_finishes_a_run_the_jax_package_began(stores, chunks):
  """The JAX package streams the first 8 inits (or, lead-chunked, dies in
  its second lead slice) and leaves its state; ``state_from_reference``
  carries it over and the port finishes the 10."""
  tmp, paths = stores
  tag = "carried_lead" if "lead_time" in chunks else "carried"
  cfgs = _configs("grouped")
  cpath = str(tmp / f"{tag}_jax_ckpt")
  group = ".det+det_extra"
  if "lead_time" in chunks:
    real = os.replace
    count = []

    def replace(src, dst):
      real(src, dst)
      count.append(dst)
      if len(count) == 4:
        raise _Died(dst)

    with pytest.MonkeyPatch.context() as mp:
      mp.setattr(jstreaming.os, "replace", replace)
      with pytest.raises(_Died):
        jevaluation.evaluate_with_mesh(
            _data_config(paths, tmp / f"{tag}_jax_part"), cfgs,
            input_chunks=chunks, checkpoint_path=cpath, checkpoint_every=1)
  else:
    jevaluation.evaluate_with_mesh(
        _data_config(paths, tmp / f"{tag}_jax_part", stop="2020-01-08"),
        cfgs, input_chunks=chunks, checkpoint_path=cpath, checkpoint_every=1)
  jstate = jstreaming.StreamingState.load(cpath + group)
  state = convert.state_from_reference(jstate)
  assert isinstance(state, streaming.StreamingState)
  assert (state.lead_index, state.chunk_index) == (
      (1, 1) if "lead_time" in chunks else (0, 2))
  assert type(state.configs["det"][0]["mse"]) is xds.Dataset
  if "lead_time" in chunks:
    assert type(state.completed_leads[0]["det"]) is xds.Dataset
  port_cpath = str(tmp / f"{tag}_port_ckpt")
  state.save(port_cpath + group)

  stats = _run(paths, tmp / f"{tag}_resumed", cfgs, chunks,
               checkpoint_path=port_cpath, checkpoint_every=1)
  assert stats["chunks"] == (2 if "lead_time" in chunks else 1)
  jevaluation.evaluate_with_mesh(_data_config(paths, tmp / f"{tag}_jax_full"),
                                 cfgs, input_chunks=chunks)
  for name in cfgs:
    got = jxds.open_netcdf(str(tmp / f"{tag}_resumed" / f"{name}.nc"))
    want = jxds.open_netcdf(str(tmp / f"{tag}_jax_full" / f"{name}.nc"))
    assert sorted(got.keys()) == sorted(want.keys())
    for k in want.keys():
      w = np.asarray(want[k].values, np.float64)
      g = np.asarray(got[k].transpose(*want[k].dims).values, np.float64)
      np.testing.assert_allclose(g, w, rtol=RTOL,
                                 atol=RTOL * np.nanmax(np.abs(w)),
                                 err_msg=f"{name}/{k}")

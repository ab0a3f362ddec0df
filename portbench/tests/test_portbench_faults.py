"""The comparison fails a run whose timed path is broken underneath, and
the lower-precision control; it passes the sound run (test_portbench_run).

Each test drives the harness's run on the CPU at a tiny size with one
fault planted in the program: the accumulator update returning its state
unchanged, half of the batch (the inits, or the members) left out with
the mean taken over the rest, and an answer altered where the finalize
produces it.  The exchange between chips does not exist in these one-chip
cells.  The control is the program's own bfloat16 transfer mode.
"""
import numpy as np
import pytest

import control
import run
from conftest import tiny_cell


def _state_unchanged(monkeypatch):
  from weatherbench2_torch.parallel import streaming

  monkeypatch.setattr(streaming, "_tree_add", lambda a, b: a)


def _half_batch(monkeypatch, dim):
  from weatherbench2_torch import evaluation

  original = evaluation.open_forecast_and_truth_datasets

  def halved(*args, **kwargs):
    forecast, truth, clim = original(*args, **kwargs)
    n = forecast.sizes[dim]
    return forecast.isel({dim: slice(0, max(1, n // 2))}), truth, clim

  monkeypatch.setattr(evaluation, "open_forecast_and_truth_datasets", halved)


def _answer_altered(monkeypatch):
  from weatherbench2_torch.parallel import streaming

  original = streaming._finalize_mean

  def altered(sums, counts):
    out = original(sums, counts)
    name = next(iter(out.keys()))
    values = np.array(out[name].values, dtype=np.float64)
    flat = values.reshape(-1)
    first = np.flatnonzero(np.isfinite(flat))[0]
    flat[first] *= 1.05
    out[name] = out[name].variable.copy(data=values) if hasattr(
        out[name], "variable") else values
    return out

  monkeypatch.setattr(streaming, "_finalize_mean", altered)


FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_inits": lambda mp: _half_batch(mp, "init_time"),
    "half_members": lambda mp: _half_batch(mp, "number"),
    "answer_altered": _answer_altered,
}


@pytest.mark.parametrize("workload,fault", [
    ("det15-raw", "state_unchanged"),
    ("det15-raw", "half_inits"),
    ("det15-raw", "answer_altered"),
    ("det15-zstd3", "state_unchanged"),
    ("det15-zstd3", "half_inits"),
    ("det15-zstd3", "answer_altered"),
    ("ens15-raw", "state_unchanged"),
    ("ens15-raw", "half_inits"),
    ("ens15-raw", "half_members"),
    ("ens15-raw", "answer_altered"),
])
def test_fault_is_not_correct(monkeypatch, tmp_path, workload, fault):
  FAULTS[fault](monkeypatch)
  line, notes = run.run_cell(tiny_cell(workload), 2**31 + 21, 0.0, False,
                             device="cpu", scratch=str(tmp_path))
  assert line["failed"] == 0, notes  # caught by the comparison, not a crash
  assert line["correct"] is False, (line["checks"], notes)


@pytest.mark.parametrize("workload", ["det15-raw", "ens15-raw",
                                      "det15-zstd3"])
def test_control_is_not_correct(tmp_path, workload):
  cell = tiny_cell(workload)
  out = control.readings(cell, 2**31 + 31, "cpu", ["program", "control"],
                         str(tmp_path))
  program, control_ = out["program"][0], out["control"][0]
  limit = cell.limits["worst_gap"]
  assert program.worst_gap <= limit and program.mismatched == 0
  assert control_.worst_gap > limit or control_.mismatched > 0

"""The cell ``ens15-spatial`` (the ensemble command's per-cell configs) on
the CPU at a tiny size: its runs are correct and read its new counters;
the faults of ``test_portbench_faults``, rank ties all broken to the lowest
bin, and the lower-precision control are not correct; the readers of the
new counters give known answers, and nothing where the program does not
count."""
import json
import pathlib

import pytest

import control
import run
from conftest import tiny_cell
from harness import fields
from test_portbench_faults import FAULTS

ROOT = pathlib.Path(__file__).resolve().parents[2]
WORKLOAD = "ens15-spatial"
SEED = 2**31 + 5  # its tiny fields hold ties: humidity at its floor of 0
READERS = ("metric_prep_ms_per_init", "generic_ms_per_init", "encode_gbps",
           "results_mib_per_init")


@pytest.mark.parametrize("trace", [False, True])
def test_runs_are_correct_and_read_the_new_counters(tmp_path, trace):
  cell = tiny_cell(WORKLOAD)
  line, notes = run.run_cell(cell, SEED, 0.0, trace, device="cpu",
                             scratch=str(tmp_path))
  assert line["correct"] is True and line["failed"] == 0, (
      line["checks"], notes)
  assert notes["compared"] > 0
  if not trace:
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    return
  for name in READERS:
    assert line["metrics"][f"{name}.spatial"]["value"] > 0, name
  assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_inits",
                                   "half_members", "answer_altered"])
def test_fault_is_not_correct(monkeypatch, tmp_path, fault):
  FAULTS[fault](monkeypatch)
  line, notes = run.run_cell(tiny_cell(WORKLOAD), 2**31 + 21, 0.0, False,
                             device="cpu", scratch=str(tmp_path))
  assert line["failed"] == 0, notes  # caught by the comparison, not a crash
  assert line["correct"] is False, (line["checks"], notes)


def test_ties_all_to_the_lowest_bin_fail_the_statistic(monkeypatch,
                                                       tmp_path):
  from weatherbench2_torch import metrics

  cell = tiny_cell(WORKLOAD)
  lay = fields.Layout(cell.config, cell.traffic)
  ref = cell.reference.Reference(lay, SEED, "cpu")
  ties = 0
  for name in lay.variables:
    truth = ref.fields.truth(name)[ref.vidx]  # (I, J, [L,] X, Y)
    ties += int((ref.fields.forecast(name) == truth[:, None]).sum())
  assert ties > 100

  original = metrics.RankHistogram.__init__

  def lowest(self, *args, **kwargs):
    original(self, *args, **{**kwargs, "break_ties_randomly": False})

  monkeypatch.setattr(metrics.RankHistogram, "__init__", lowest)
  line, notes = run.run_cell(cell, SEED, 0.0, False, device="cpu",
                             scratch=str(tmp_path))
  assert line["correct"] is False
  # every value within its bounds, every cell's bins summing to 1 ...
  assert line["checks"]["worst_gap"]["value"] <= cell.limits["worst_gap"]
  # ... but the mean rank far below what the draw allows
  assert notes["notes"] and all("statistic" in n for n in notes["notes"])


def test_control_is_not_correct(tmp_path):
  cell = tiny_cell(WORKLOAD)
  out = control.readings(cell, 2**31 + 31, "cpu", ["program", "control"],
                         str(tmp_path))
  (program, _), (control_, _) = out["program"], out["control"]
  assert program.worst_gap <= cell.limits["worst_gap"]
  assert program.mismatched == 0
  assert (control_.worst_gap > cell.limits["worst_gap"]
          or control_.mismatched > 0)


@pytest.fixture
def ctx():
  """Two jobs of 20 inits in all, counted as the program counts them."""
  jobs = [
      {"wall_s": 4.0, "metric_prep_s": 0.2, "generic_s": 0.5,
       "write_bytes": 3 * 2**20, "encode_bytes": 4e9, "encode_s": 2.0},
      {"wall_s": 6.0, "metric_prep_s": 0.3, "generic_s": 1.5,
       "write_bytes": 7 * 2**20, "encode_bytes": 2e9, "encode_s": 1.0},
  ]
  return {"jobs": jobs, "inits": 20, "window_s": 10.0, "trace": None,
          "decodes": (0, 0.0), "peak_bytes": 0, "step_bytes": 0}


def _read(name, ctx):
  # pylint: disable-next=protected-access
  return run._read_metric({"name": name}, ctx)


def test_the_readers_known_answers(ctx):
  got = {name: _read(name, ctx) for name in READERS}
  assert got == pytest.approx({
      "metric_prep_ms_per_init": 1e3 * 0.5 / 20,
      "generic_ms_per_init": 1e3 * 2.0 / 20,
      "encode_gbps": 6e9 / 3.0 / 1e9,
      "results_mib_per_init": 10 / 20})


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_from_a_program_that_does_not_count(ctx, name):
  """The parent of these counters reads as missing, without raising."""
  ctx["jobs"] = [{"wall_s": 4.0, "read_bytes": 1, "wait_host_s": 1.0}]
  assert _read(name, ctx) is None


def test_the_cells_entries():
  """The cell's configuration, its per-layer metrics (each with its
  reader, read in this cell alone) and one end-to-end rate or peak."""
  bench = json.loads((ROOT / "BENCHMARK.json").read_text())
  (cell,) = [w for w in bench["workloads"] if w["name"] == WORKLOAD]
  assert (cell["config"], cell["traffic"], cell["chips"]) == (
      "wb2-ens50-spatial-1.5deg", "raw-2inits", 1)
  reported = {m["name"] for m in bench["end_to_end"]
              if WORKLOAD in m.get("workloads", [WORKLOAD])}
  assert "setup_s" in reported and len(reported) == 2
  layer = [m for m in bench["per_layer"] if WORKLOAD in m["workloads"]]
  assert {m["name"].split(".")[0] for m in layer} >= set(READERS)
  for m in layer:
    assert m["workloads"] == [WORKLOAD] and m["name"].endswith(".spatial")
    assert m["moves"] in reported

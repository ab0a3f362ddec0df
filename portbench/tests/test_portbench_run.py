"""The harness's run on the CPU at a tiny size, the last line's keys and
the contract of BENCHMARK.json."""
import json
import pathlib
import re
import sys

import pytest

import run
from conftest import tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def bench():
  return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_contract(bench):
  assert set(bench) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert bench["command"] == ["python3", "portbench/run.py"]
  assert bench["paths"] == ["portbench"]
  assert 1 <= bench["run_seconds"] <= 51
  configs = {c["name"]: c for c in bench["configs"]}
  for c in bench["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    assert (BENCH / "jobs" / f"{cfg['job']}.py").exists()
    assert (BENCH / "reference" / f"{cfg['job']}.py").exists()
    assert set(cfg["limits"]) == {"worst_gap", "mismatched"}
  e2e = {m["name"]: m for m in bench["end_to_end"]}
  assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
  for m in bench["end_to_end"]:
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
  for m in bench["per_layer"]:
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["moves"] in e2e and m["better"] in ("lower", "higher")
    assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").exists()
  cells = {w["name"]: w for w in bench["workloads"]}
  for w in bench["workloads"]:
    assert w["config"] in configs and w["chips"] == 1
    assert len(w["why"]) <= 200 and NAME.match(w["name"])
    assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    reported = [m for m in bench["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
    assert len(reported) >= 2
    layer = [m for m in bench["per_layer"]
             if w["name"] in m.get("workloads", [])]
    assert layer and all(m["moves"] in {r["name"] for r in reported}
                         for m in layer)
  for m in bench["per_layer"] + bench["end_to_end"]:
    assert set(m.get("workloads", [])) <= set(cells)
  assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("workload", ["det15-lz4", "det15-raw",
                                      "det15-zstd3"])
def test_last_line_of_an_untraced_run(tmp_path, workload):
  cell = tiny_cell(workload)
  line, notes = run.run_cell(cell, 2**31 + 11, 0.0, False, device="cpu",
                             scratch=str(tmp_path))
  assert list(line) == KEYS + ["checks"]
  assert line["correct"] is True and line["failed"] == 0
  assert line["attempted"] >= 1
  assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
  for name, m in line["metrics"].items():
    if name == "job_peak_hbm_gib":
      # the device's peak, which a run without a card reads as 0
      assert m["value"] == line["device"]["memory_peak_bytes"] / 2**30
    else:
      assert m["value"] > 0, name
  assert set(line["device"]) == {"platform", "kind", "count",
                                 "memory_peak_bytes"}
  assert set(line["checks"]) == {"worst_gap", "mismatched"}
  assert notes["compared"] > 0


def test_last_line_of_a_traced_run(tmp_path):
  cell = tiny_cell("ens15-raw")
  line, _ = run.run_cell(cell, 2**32 + 3, 0.0, True, device="cpu",
                         scratch=str(tmp_path))
  assert list(line) == KEYS + ["breakdown", "checks"]
  assert line["correct"] is True
  assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
  assert "host_wait_share.ens" in line["metrics"]
  assert {"busy_s", "window_s"} <= set(line["device"])
  assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(monkeypatch, capsys):
  import torch

  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  rc = run.main(["--workload", "det15-raw", "--seed", "1", "--seconds", "1"])
  assert rc != 0
  assert capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
  assert "weatherbench2_torch" not in run.forbidden_modules()
  monkeypatch.setitem(sys.modules, "weatherbench2_tpu", object())
  monkeypatch.setitem(sys.modules, "jax.numpy", object())
  assert run.forbidden_modules() == ["jax", "weatherbench2_tpu"]


@pytest.mark.card
def test_cell_on_the_card(card):
  """A short run of each cell on the card is correct."""
  for workload in ("det15-raw", "ens15-raw"):
    line, _ = run.run_cell(run.Cell(workload), 7, 0.0, False, device=card)
    assert line["correct"] is True, line["checks"]

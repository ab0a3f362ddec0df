"""Shared fixtures of the benchmark's tests: the harness on the path, the
``card`` marker, and the cells cut to a size a CPU test can hold."""
import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (BENCH, os.path.dirname(BENCH)):
  if p not in sys.path:
    sys.path.insert(0, p)


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "card: needs a CUDA card; skips inside the test without one")


def tiny_cell(workload, members=5, inits=4):
  """``workload`` of BENCHMARK.json at 36x19, 5 leads, few inits and
  members in two chunks: every other setting as the cell's."""
  import run

  cell = run.Cell(workload)
  cfg, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
  cfg["grid"] = {"longitudes": 36, "latitudes": 19, "poles": True}
  cfg["leads"] = {"count": 5, "step_hours": 12}
  if cfg.get("members"):
    cfg["members"] = members
  traffic["inits_per_job"] = min(traffic["inits_per_job"], inits)
  # two chunks a job, as every cell streams
  traffic["input_chunks"] = f"init_time={max(1, traffic['inits_per_job'] // 2)}"
  return run.Cell(workload, config=cfg, traffic=traffic)


@pytest.fixture
def card():
  """Skips the test unless a CUDA card is present (decided in the test)."""
  import torch

  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return "cuda"

"""The comparison counts what the program wrote beyond the reference: a
label of the metric or region axis that the reference has not, or one
written twice, is counted in ``mismatched`` with each of its values."""
import numpy as np
import pytest
from scipy.io import netcdf_file

from harness import compare

METRICS = ["mse", "bias"]
REGIONS = ["global", "tropics"]
LEADS = 3


def _expected():
  values = np.arange(len(METRICS) * len(REGIONS) * LEADS,
                     dtype=np.float64).reshape(len(METRICS), len(REGIONS),
                                               LEADS) + 1.0
  return {"2m_temperature": (("metric", "region", "lead_time"),
                             {"metric": METRICS, "region": REGIONS}, values)}


def _write(path, metrics, regions, values):
  with netcdf_file(path, "w") as f:
    for axis, labels in (("metric", metrics), ("region", regions)):
      width = max(len(x) for x in labels)
      f.createDimension(axis, len(labels))
      f.createDimension(f"{axis}_chars", width)
      var = f.createVariable(axis, "c", (axis, f"{axis}_chars"))
      var[:] = np.array([list(x.ljust(width, "\0")) for x in labels], "S1")
    f.createDimension("lead_time", LEADS)
    var = f.createVariable("2m_temperature", "d",
                           ("metric", "region", "lead_time"))
    var[:] = values


def _tally(tmp_path, metrics, regions, values):
  path = str(tmp_path / "deterministic.nc")
  _write(path, metrics, regions, values)
  return compare.compare({"deterministic": path},
                         {"deterministic": _expected()})


def test_results_as_the_reference_match(tmp_path):
  values = _expected()["2m_temperature"][2]
  tally = _tally(tmp_path, METRICS, REGIONS, values)
  assert tally.mismatched == 0 and tally.worst_gap == 0.0


@pytest.mark.parametrize("axis", ["metric", "region"])
def test_a_label_not_in_the_reference_is_counted(tmp_path, axis):
  values = _expected()["2m_temperature"][2]
  if axis == "metric":
    metrics, regions = METRICS + ["acc"], REGIONS
    values = np.concatenate([values, values[:1] * 7.0], axis=0)
  else:
    metrics, regions = METRICS, REGIONS + ["arctic"]
    values = np.concatenate([values, values[:, :1] * 7.0], axis=1)
  tally = _tally(tmp_path, metrics, regions, values)
  slab = len(REGIONS) * LEADS if axis == "metric" else len(METRICS) * LEADS
  assert tally.mismatched == slab, tally.notes
  assert tally.worst_gap == 0.0  # the expected labels still match


def test_a_label_written_twice_is_counted(tmp_path):
  values = _expected()["2m_temperature"][2]
  regions = REGIONS + ["global"]
  values = np.concatenate([values, values[:, :1]], axis=1)
  tally = _tally(tmp_path, METRICS, regions, values)
  assert tally.mismatched == len(METRICS) * LEADS, tally.notes

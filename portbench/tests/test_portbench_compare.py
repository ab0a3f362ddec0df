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


# -- results defined up to a random draw, held to bounds ---------------------

LIMIT = 0.01  # the configurations' worst_gap limit


def _perturbed(values, rng):
  """The reference's values a little off, with a NaN planted where a value
  was finite: a tally with every part non-zero."""
  got = np.array(values, np.float64)
  got *= 1.0 + 1e-4 * rng.standard_normal(got.shape)
  finite = np.flatnonzero(np.isfinite(got))
  got.reshape(-1)[finite[len(finite) // 2]] = np.nan
  return got


def _fields(tally):
  return (tally.worst_gap, tally.where, tally.mismatched, tally.compared,
          tally.notes)


@pytest.mark.parametrize("workload", ["det15-raw", "ens15-raw"])
def test_exact_form_is_bounds_with_low_equal_high(workload):
  from conftest import tiny_cell
  from harness import fields

  cell = tiny_cell(workload)
  layout = fields.Layout(cell.config, cell.traffic)
  expected = cell.reference.Reference(layout, 2**31 + 41, "cpu").results()
  rng = np.random.default_rng(41)
  exact, bounded = compare.Tally(), compare.Tally()
  for config, want in expected.items():
    for name, (dims, labels, values) in sorted(want.items()):
      got = {name: (dims, _perturbed(values, rng))}
      compare.compare_config(got, labels, {name: (dims, labels, values)},
                             exact, config)
      compare.compare_config(
          got, labels,
          {name: (dims, labels, compare.Bounds(values.copy(),
                                               values.copy()))},
          bounded, config)
  assert exact.mismatched > 0 and exact.worst_gap > 0
  assert _fields(bounded) == _fields(exact)


BINS = 4
DIMS = ("metric", "longitude", "bins")


def _hist_tally(values, bounds):
  tally = compare.Tally()
  compare.compare_config({"x": (DIMS, values[None])}, {"metric": ["rh"]},
                         {"x": (DIMS, {"metric": ["rh"]}, bounds)}, tally,
                         "probabilistic_spatial_histograms")
  return tally


def _bounds(low, high, sums=True, mean=None, std=None):
  stat = None
  if mean is not None:
    stat = compare.Statistic("bins", np.arange(BINS), np.array([mean]),
                             np.array([std]))
  return compare.Bounds(
      low[None], high[None],
      compare.Sums("bins", np.ones((1,) + low.shape[:-1])) if sums else None,
      stat)


@pytest.mark.parametrize("offset,gap", [(0.0, 0.0), (0.25, 0.0),
                                        (0.75, 0.25)])
def test_values_held_to_their_bounds(offset, gap):
  low = np.array([[0.0, 0.5, 0.5, 0.0], [1.0, 0.0, 0.0, 0.0]])
  high = np.array([[0.0, 1.0, 1.0, 0.0], [1.0, 0.0, 0.0, 0.0]])
  got = low.copy()
  got[0, 1] += offset  # 0.5 + offset against [0.5, 1]
  tally = _hist_tally(got, _bounds(low, high, sums=False))
  assert tally.mismatched == 0 and tally.compared == low.size
  assert tally.worst_gap == pytest.approx(gap)  # over the largest |high|, 1


@pytest.mark.parametrize("low,high", [
    (np.array([1.0, np.nan]), np.array([1.0, 2.0])),
    (np.array([1.0, 2.0]), np.array([1.0, 1.5])),
])
def test_malformed_bounds_are_refused(low, high):
  with pytest.raises(ValueError):
    compare.Bounds(low, high)


# A tiny ensemble on a coarse grid of values, so that members often equal
# the truth exactly: 3 members (4 bins), 6 inits, 40 cells.
ENS, INITS, CELLS = "realization", 6, 40


def _ensemble(seed=5):
  rng = np.random.default_rng(seed)
  forecast = np.round(rng.standard_normal((BINS - 1, INITS, CELLS)) * 2) / 2
  truth = np.round(rng.standard_normal((INITS, CELLS)) * 2) / 2
  return forecast.astype(np.float32), truth.astype(np.float32)


def _rank_bounds(forecast, truth):
  """A plain count: each init's truth takes a rank uniform over
  [#members below, #below + #equal]; per-cell bounds of the histogram (the
  mean over inits), its sums, and the mean rank with its sd under the
  draw."""
  below = (forecast < truth).sum(0)
  equal = (forecast == truth).sum(0)
  bins = np.arange(BINS)[:, None, None]
  sure = (equal == 0) & (below == bins)
  can = (below <= bins) & (bins <= below + equal)
  low = sure.mean(1).T  # (cells, bins)
  high = can.mean(1).T
  n = INITS * CELLS
  mean = (below + equal / 2).sum() / n
  std = np.sqrt((((equal + 1) ** 2 - 1) / 12).sum()) / n
  return _bounds(low, high, mean=mean, std=std), int(equal.sum())


def _port_histogram(forecast, truth, **kwargs):
  from weatherbench2_torch import convert, metrics

  coords = {"init_time": np.arange(INITS), "longitude": np.arange(CELLS)}
  fc = convert.dataset_from_arrays(
      {"x": ((ENS, "init_time", "longitude"), forecast)},
      {ENS: np.arange(BINS - 1), **coords})
  tr = convert.dataset_from_arrays(
      {"x": (("init_time", "longitude"), truth)}, coords)
  hist = metrics.RankHistogram(ensemble_dim=ENS, **kwargs).compute_chunk(
      fc, tr)["x"]
  assert hist.dims == ("init_time", "longitude", "bins")
  return np.asarray(hist.values, np.float64).mean(0)


@pytest.mark.parametrize("seed", [11, 12])
def test_honest_draws_pass(seed):
  forecast, truth = _ensemble()
  bounds, ties = _rank_bounds(forecast, truth)
  assert ties > 50
  got = _port_histogram(forecast, truth, seed=seed)
  tally = _hist_tally(got, bounds)
  assert tally.mismatched == 0 and tally.worst_gap <= 1e-6, tally.notes


def test_ties_all_to_the_lowest_bin_fail_the_statistic():
  forecast, truth = _ensemble()
  bounds, _ = _rank_bounds(forecast, truth)
  got = _port_histogram(forecast, truth, break_ties_randomly=False)
  tally = _hist_tally(got, bounds)
  # every value lies inside its bounds and every cell sums to 1 ...
  assert tally.worst_gap <= 1e-6
  # ... but the mean rank lies far below what the draw allows
  assert tally.mismatched == got.size
  assert "statistic" in tally.notes[0]


def test_a_point_in_two_bins_fails_the_sums():
  forecast, truth = _ensemble()
  bounds, _ = _rank_bounds(forecast, truth)
  got = _port_histogram(forecast, truth, seed=11)
  cell = 7
  empty = np.flatnonzero(got[cell] < bounds.high[0, cell])[0]
  got[cell, empty] += 1.0 / INITS  # one init's truth counted twice
  tally = _hist_tally(got, bounds)
  assert tally.worst_gap > LIMIT
  assert tally.where.endswith("sums over bins")

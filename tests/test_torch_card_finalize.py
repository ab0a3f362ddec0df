"""The streaming engine's finalize of temporal means on the device.

Each metric's float64 sums and counts are divided where they lie and,
where every metric of a config has the same variables, dims and
coordinates, stacked by metric there; the host merge joins the rest.  The
results dataset must equal, value for value, what dividing on the host
(``where(count > 0, sum / max(count, 1), NaN)`` in numpy), ``expand_dims``
and ``merge_metric_results`` give: NaN where a count is 0, a sum is NaN or
a sum and count are both infinite.
"""
import numpy as np
import pytest
import torch

from weatherbench2_torch import evaluation
from weatherbench2_torch import xds
from weatherbench2_torch.parallel import streaming

DIMS = ("lead_time", "level", "latitude", "longitude")
SHAPE = (3, 2, 4, 8)


def _coords(levels=(500, 850)):
  return {
      "lead_time": xds.Variable(
          ("lead_time",), np.arange(3) * np.timedelta64(12, "h"),
          {"long_name": "lead time"}),
      "level": xds.Variable(("level",), np.asarray(levels, np.int64),
                            {"units": "hPa"}),
      "latitude": np.linspace(-67.5, 67.5, 4),
      "longitude": np.arange(8) * 45.0,
      "lead_hours": xds.Variable(("lead_time",), np.arange(3) * 12.0),
      "source": np.asarray("era5", dtype=object),
  }


def _sums_and_counts(seed, variables, dev, levels=(500, 850), extra=None):
  """A metric's float64 (sum, count) datasets on ``dev``, with counts of 0,
  NaN and +-inf sums, and an infinite sum over an infinite count."""
  rng = np.random.default_rng(seed)
  sums = xds.Dataset({}, coords=_coords(levels))
  counts = xds.Dataset({}, coords=_coords(levels))
  for name in variables:
    dims, shape = DIMS, SHAPE
    if name == extra:
      dims, shape = DIMS + ("quantile",), SHAPE + (2,)
    s = rng.standard_normal(shape) * 10.0
    c = rng.integers(0, 4, shape).astype(np.float64)
    flat_s, flat_c = s.reshape(-1), c.reshape(-1)
    flat_s[:5] = [np.nan, np.inf, -np.inf, np.inf, 7.0]
    flat_c[:5] = [2.0, 3.0, 1.0, np.inf, 0.0]
    sums[name] = xds.Variable(dims, torch.as_tensor(s, device=dev))
    counts[name] = xds.Variable(dims, torch.as_tensor(c, device=dev))
  return sums, counts


def _host_mean(sum_ds, count_ds):
  """The division as the host made it before the device took it over."""
  out = xds.Dataset({}, coords=dict(sum_ds.coords_dict()))
  for k in sum_ds.keys():
    s = np.asarray(sum_ds[k].values, dtype=np.float64)
    c = np.asarray(count_ds[k].values, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
      out[k] = xds.Variable(sum_ds[k].dims,
                            np.where(c > 0, s / np.maximum(c, 1), np.nan))
  return out


def _assert_same(got, want):
  assert list(got.keys()) == list(want.keys())
  assert list(got.coords_dict()) == list(want.coords_dict())
  assert got.attrs == want.attrs
  pairs = [(got.variables_dict()[k], want.variables_dict()[k])
           for k in want.keys()]
  pairs += [(got.coords_dict()[k], want.coords_dict()[k])
            for k in want.coords_dict()]
  for g, w in pairs:
    assert g.dims == w.dims and g.attrs == w.attrs
    g, w = np.asarray(g.data), np.asarray(w.data)
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


# per metric: its variables, its levels, the variable with an extra dim
SAME = {"mse": (("t2m", "z"), (500, 850), None),
        "bias": (("t2m", "z"), (500, 850), None),
        "crps": (("t2m", "z"), (500, 850), None)}
CASES = {
    "stacked": SAME,
    "one_metric": {"mse": SAME["mse"]},
    "variables_differ": {**SAME, "bias": (("t2m",), (500, 850), None)},
    "coords_differ": {**SAME, "bias": (("t2m", "z"), (500, 700), None)},
    "dims_differ": {**SAME, "crps": (("t2m", "z"), (500, 850), "z")},
    "cuda": SAME,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_finalize_equals_the_host_divide_and_merge(case):
  if case == "cuda" and not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  dev = torch.device("cuda" if case == "cuda" else "cpu")
  metrics = CASES[case]
  accumulators = {
      name: _sums_and_counts(i, variables, dev, levels, extra)
      for i, (name, (variables, levels, extra)) in enumerate(metrics.items())}
  want = evaluation.merge_metric_results([
      _host_mean(s, c).expand_dims(metric=np.asarray([name], dtype=object))
      for name, (s, c) in accumulators.items()])

  sums = {name: s for name, (s, _) in accumulators.items()}
  counts = {name: c for name, (_, c) in accumulators.items()}
  means = streaming._device_means(list(metrics), sums, counts, dev)
  assert not sums and not counts  # every accumulator released
  stacked = isinstance(means, xds.Dataset)
  assert stacked == (case in ("stacked", "one_metric", "cuda"))
  if stacked:
    assert all(v.data.device.type == dev.type
               for v in means.variables_dict().values())
    assert sum(v.data.numel() * 8 for v in means.variables_dict().values()) == (
        len(metrics) * 2 * int(np.prod(SHAPE)) * 8)
  got = evaluation.merge_metric_results(
      streaming._metric_results(streaming.batched_device_get(means)))
  _assert_same(got, want)
  assert np.isnan(got["t2m"].values.reshape(len(metrics), -1)[:, [0, 3, 4]]).all()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_a_large_leaf_crosses_whole_in_blocks(monkeypatch, device, layout):
  """A leaf of several blocks and a partial last one, contiguous or not,
  reaches the host value for value (on a card, through the pinned
  buffers)."""
  if device == "cuda" and not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  monkeypatch.setattr(streaming, "PACKED_LEAF_BYTES", 1024)
  monkeypatch.setattr(streaming, "D2H_BLOCK_BYTES", 4096)
  rng = np.random.default_rng(5)
  want = rng.standard_normal((37, 129))
  want.reshape(-1)[:3] = [np.nan, np.inf, -0.0]
  t = torch.as_tensor(want, device=device)
  if layout == "transposed":
    want, t = want.T, t.T
  got = streaming.batched_device_get({"x": t})["x"]
  assert isinstance(got, np.ndarray) and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(np.signbit(got), np.signbit(want))

"""The port's climatology statistics held to the JAX package's.

  * ``ops.climatology`` (torch, float32) against
    ``weatherbench2_tpu/ops/climatology.py`` (jax, float32): the circulant
    matrix bit for bit; the rolling mean and std and the windowed weighted
    quantile (an all-NaN pool, day blocks of any size) within
    ``rtol=1e-5`` plus ``atol=1e-5·max|reference|`` (float32 sums in
    another order), NaN in the same places.
  * ``utils`` on numpy payloads (the same torch code, on float64 CPU
    tensors) against ``weatherbench2_tpu.utils``'s float64 host code:
    ``rtol=1e-12`` plus ``atol=1e-12·max|ref|`` (float64 sums in another
    order, so a mean near zero differs in its last bits); the host
    weighted quantile, the JAX package's own float64 code, ``rtol=1e-12``.
  * ``utils`` on CPU tensors (the card's path) against the same float64
    host code: means and weighted quantiles (float32 values, float64
    cumulative weights) within ``rtol=1e-5`` plus ``atol=1e-5·max|ref|``;
    standard deviations, which the card forms as E[x²] - E[x]² in float32
    (on data centred on a per-pixel mean), within ``rtol=1e-4`` plus
    ``atol=1e-4·max|ref|``.
"""
import numpy as np
import pytest
import torch

from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import utils as jutils
from weatherbench2_tpu.ops import climatology as jclim
from weatherbench2_torch import convert, utils, xds
from weatherbench2_torch.ops import climatology as clim
from weatherbench2_torch.xds._xp import to_numpy as _to_numpy

RTOL = 1e-5


def assert_close(got, want, what, rtol=RTOL):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape, what
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
  fin = ~np.isnan(want)
  np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                             atol=rtol * np.abs(want[fin]).max(),
                             err_msg=what)


def _stacked(seed=0, years=4, pixels=(5, 3), ties=False):
  rs = np.random.RandomState(seed)
  x = (500 + 50 * rs.randn(years, 366, *pixels)).astype(np.float32)
  x[0::2, 365] = np.nan  # non-leap years lack day 366
  x[:, :, 0, 0] = np.nan  # a pixel without data: an all-NaN pool
  if ties:
    x = np.round(x / 25) * 25
  return x


def test_circulant_matrix_is_the_jax_packages():
  w = utils.create_window_weights(61).values
  np.testing.assert_array_equal(w, jutils.create_window_weights(61).values)
  np.testing.assert_array_equal(clim.circulant_window_matrix(w, 366),
                                jclim.circulant_window_matrix(w, 366))


@pytest.mark.parametrize("stat", ["mean", "std"])
def test_rolling_clim_matches_the_jax_device_function(stat):
  x = _stacked()
  w = utils.create_window_weights(15).values
  want = np.asarray(jclim.device_rolling_clim(x, w, stat))
  got = clim.device_rolling_clim(torch.as_tensor(x), w, stat)
  assert got.dtype == torch.float32
  assert_close(got.numpy(), want, stat)


@pytest.mark.parametrize("one_day_blocks", [False, True])
def test_window_quantile_matches_the_jax_device_function(one_day_blocks,
                                                         monkeypatch):
  """Tie-free pools (the JAX device function orders ties otherwise, see
  the next test), in one day block or in blocks of one day."""
  if one_day_blocks:
    monkeypatch.setitem(clim.QUANTILE_BLOCK_BYTES, "cpu", 1)
  x = _stacked(seed=1, years=3)
  q = [0.1, 0.5, 2 / 3, 0.95]
  w = utils.create_window_weights(9).values
  want = np.asarray(jclim.device_window_quantile(x, 9, q, w))
  got = clim.device_window_quantile(torch.as_tensor(x), 9, q, w)
  assert_close(got.numpy(), want, f"one_day_blocks={one_day_blocks}")
  assert np.isnan(got[:, :, 0, 0].numpy()).all()


def test_window_quantile_orders_ties_by_weight_as_the_host_path():
  """Equal values go in the order of the JAX host path's (value, weight)
  sort, whatever the pool order."""
  x = _stacked(seed=3, years=3, pixels=(2, 2), ties=True)
  q = [0.1, 0.5, 2 / 3, 0.95]
  w = utils.create_window_weights(9).values
  idx = clim.window_pool_index(366, 9)
  pools = x.reshape(3, 366, 4)[:, idx]  # (years, day, window, pixel)
  pools = pools.transpose(3, 1, 0, 2).reshape(4, 366, -1)  # year-major
  want = jutils.weighted_quantile(pools, q, np.tile(w, 3), axis=-1)
  got = clim.device_window_quantile(torch.as_tensor(x), 9, q, w)
  assert_close(got.numpy(),
               np.moveaxis(want, 1, 2).reshape(len(q), 366, 2, 2),
               "ties by weight")


@pytest.mark.parametrize("axis", [0, -1])
def test_weighted_quantile_on_tensors_and_numpy(axis):
  rs = np.random.RandomState(2)
  values = rs.randn(40, 6).astype(np.float32)
  values[rs.rand(40, 6) < 0.2] = np.nan
  values[:, 3] = np.nan
  weights = rs.rand(40) if axis == 0 else rs.rand(6)
  weights = weights[:, None] if axis == 0 else weights
  q = [0.2, 0.5, 0.9]
  want = jutils.weighted_quantile(values, q, weights, axis=axis)
  host = utils.weighted_quantile(values, q, weights, axis=axis)
  np.testing.assert_allclose(host, want, rtol=1e-12, equal_nan=True)
  got = utils.weighted_quantile(torch.as_tensor(values), q,
                                torch.as_tensor(weights), axis=axis)
  assert_close(got.numpy(), want, "tensor")


# -- the labeled statistics ----------------------------------------------------


@pytest.fixture(scope="module")
def obs():
  """Three years of 6-hourly 30-degree truth, the JAX package's and the
  port's, with a few NaNs."""
  ds = jutils.random_like(jschema.mock_truth_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature"],
      levels=(500,), time_start="2001-01-01", time_stop="2004-01-01",
      spatial_resolution_in_degrees=30.0, time_resolution="6 hours"),
      seed=7)
  t2 = np.asarray(ds["2m_temperature"].values).copy()
  t2[5:9, 2, 3] = np.nan
  ds = ds.copy(data={"2m_temperature": t2})
  return ds, convert.from_reference(ds)


CLIM_YEARS = slice("2001", "2003")
FUNCTIONS = {
    "hourly_mean": lambda m, ds: m.compute_hourly_stat(ds, 15, CLIM_YEARS, 6,
                                                       "mean"),
    "hourly_std": lambda m, ds: m.compute_hourly_stat(ds, 15, CLIM_YEARS, 12,
                                                      "std"),
    "daily_mean": lambda m, ds: m.compute_daily_stat(ds, 15, CLIM_YEARS,
                                                     "mean"),
    "daily_std": lambda m, ds: m.compute_daily_stat(ds, 15, CLIM_YEARS,
                                                    "std"),
    "hourly_mean_fast": lambda m, ds: m.compute_hourly_stat_fast(
        ds, 15, CLIM_YEARS, 6, "mean"),
    "hourly_std_fast": lambda m, ds: m.compute_hourly_stat_fast(
        ds, 15, CLIM_YEARS, 6, "std"),
    "daily_mean_fast": lambda m, ds: m.compute_daily_stat_fast(
        ds, 15, CLIM_YEARS, "mean"),
    "daily_std_fast": lambda m, ds: m.compute_daily_stat_fast(
        ds, 15, CLIM_YEARS, "std"),
    "resample_daily_mean": lambda m, ds: m.resample_daily_mean(ds),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_statistics_match_the_jax_package(obs, name):
  jds, ds = obs
  want = FUNCTIONS[name](jutils, jds)
  host = FUNCTIONS[name](utils, ds)
  on_tensors = FUNCTIONS[name](utils, xds.to_device(ds, torch.device("cpu")))
  rtol = 1e-4 if "std" in name else RTOL
  for v in want.keys():
    w = want[v]
    h = host[v].transpose(*w.dims)
    assert isinstance(h.data, np.ndarray) and h.data.dtype == np.float64
    assert_close(h.values, w.values, f"{name}/{v} host", rtol=1e-12)
    t = on_tensors[v]
    assert torch.is_tensor(t.data)
    assert_close(t.transpose(*w.dims).data.numpy(), w.values,
                 f"{name}/{v} tensors", rtol=rtol)
  for c in want.coords_dict():
    if c in ("dayofyear", "hour", "time"):
      np.testing.assert_array_equal(
          np.asarray(on_tensors.coords_dict()[c].data),
          np.asarray(want.coords_dict()[c].data), err_msg=c)


def test_callable_statistics_receive_the_stacked_windows(obs):
  jds, ds = obs
  q = [0.25, 0.75]

  def quantiles(mod):
    def fn(stacked, weights, dim):
      out = {}
      for v in stacked.keys():
        da = stacked[v]
        axes = tuple(da.dims.index(d) for d in dim)
        vals = da.data
        keep = [i for i in range(vals.ndim) if i not in axes]
        xp = torch if torch.is_tensor(vals) else np
        moved = (vals.permute(*keep, *axes) if xp is torch
                 else np.transpose(vals, keep + list(axes)))
        flat = moved.reshape(tuple(moved.shape[:len(keep)]) + (-1,))
        w = np.repeat(np.asarray(weights.values), da.sizes["year"])
        out[v] = mod.weighted_quantile(
            flat, q, torch.as_tensor(w) if xp is torch else w, axis=-1)
      return out
    return fn

  want = jutils.compute_daily_stat(jds, 15, CLIM_YEARS, quantiles(jutils))
  got = utils.compute_daily_stat(xds.to_device(ds, torch.device("cpu")), 15,
                                 CLIM_YEARS, quantiles(utils))
  for v in want:
    assert_close(got[v].numpy(), want[v], v)


def test_stack_years_fills_the_leap_day_from_day_365():
  """A year without day 366 takes its day 365 there; a day a year holds
  twice keeps its last time (``reindex_with_nan``)."""
  times = np.concatenate([
      np.datetime64("2003-12-29", "ns") + np.arange(3) * np.timedelta64(1, "D"),
      np.datetime64("2004-12-29", "ns") + np.arange(3) * np.timedelta64(1, "D"),
      np.datetime64("2004-12-31T12", "ns")[None]])
  vals = np.arange(len(times), dtype=np.float32)[:, None]
  ds = xds.Dataset({"x": xds.Variable(("time", "p"), vals)},
                   coords={"time": times})
  for payload in (ds, xds.to_device(ds, torch.device("cpu"))):
    stacked = utils.stack_years(payload)
    assert stacked["x"].dims == ("year", "dayofyear", "p")
    np.testing.assert_array_equal(stacked.coords_dict()["dayofyear"].data,
                                  [363, 364, 365, 366])
    got = np.asarray(_to_numpy(stacked["x"].data))[..., 0]
    # 2003: days 363-365, and day 365 for 366; 2004: no day 363 (day 365
    # fills every NaN, as in the JAX package), 364-366 (366 twice: last)
    np.testing.assert_array_equal(got, [[0, 1, 2, 2], [4, 3, 4, 6]])

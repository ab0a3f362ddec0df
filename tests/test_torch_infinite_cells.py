"""Infinite cells of a stored variable through the tensor-core core.

The card's tensor-core core splits each operand into TF32 parts, which an
infinity has not: its sums of such a (statistic, row) come out NaN in every
region.  ``nonfinite_fixup`` in ``csrc/reductions.cu`` gives each region
back what an fp32 matmul gives; ``ops.*_tf32_emulation`` repeat that
arithmetic on the CPU bit for bit (``chip_smoke.py`` holds the card to it),
so these tests hold the card's arithmetic to:

  (a) the port's plain versions and the JAX package's reference
      reductions, with one +inf and one -inf forecast cell, at R = 13 and
      R = 16 (the plans of ``--regions=all`` without and with a land-sea
      mask);
  (b) the JAX package's streaming engine, on stores with those cells, with
      the port's streaming engine running the emulations in place of the
      kernels, per region.

+inf, -inf and NaN must sit in the same places; the finite values agree
within ``rtol=1e-5`` plus ``atol=1e-5·max|reference|`` (float32 sums in
another order).
"""
import numpy as np
import pytest
import torch

from tests import test_torch_official_configs as official
from weatherbench2_tpu import config as jconfig
from weatherbench2_tpu import evaluation as jevaluation
from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.ops import reductions as jreductions
from weatherbench2_tpu.regions import SliceRegion
from weatherbench2_torch import ops
from weatherbench2_torch.ops import reductions

RTOL = 1e-5


def assert_same_nonfinite(got, want, what):
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  for test in (np.isposinf, np.isneginf, np.isnan):
    np.testing.assert_array_equal(test(got), test(want),
                                  err_msg=f"{what}: {test.__name__}")
  fin = np.isfinite(want)
  if fin.any():
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                               atol=RTOL * np.abs(want[fin]).max(),
                               err_msg=what)


def _inputs(n_regions, seed=0, rows=10, n_lon=32, n_lat=16):
  rs = np.random.RandomState(seed)
  cols = n_lon * n_lat
  truth = rs.randn(rows, cols).astype(np.float32)
  forecast = (truth + 0.3 * rs.randn(rows, cols)).astype(np.float32)
  clim = (truth + 0.5 * rs.randn(rows, cols)).astype(np.float32)
  forecast[2, 100] = np.inf       # a cell some regions hold
  forecast[5, 400] = -np.inf
  forecast[7, [40, 300]] = [np.inf, -np.inf]  # both signs in one row
  forecast[9, 60] = np.nan
  lat = np.linspace(-90, 90, n_lat)
  lat_w = np.cos(np.deg2rad(lat)) + 1e-3
  masks = [np.ones((n_lat, n_lon))]
  for _ in range(n_regions - 1):
    lo, hi = np.sort(rs.choice(n_lat, 2, replace=False))
    box = np.zeros((n_lat, n_lon))
    box[lo:hi + 1, rs.randint(0, n_lon // 2):] = 1
    masks.append(box)
  w = ops.make_region_weight_matrix(lat_w / lat_w.mean(), masks, n_lon)
  return forecast, truth, clim, w


@pytest.mark.parametrize("n_regions", [13, 16])
@pytest.mark.parametrize("with_clim", [True, False])
def test_kernel1_emulation_keeps_infinities_in_place(n_regions, with_clim):
  f, t, c, w = _inputs(n_regions)
  c = c if with_clim else None
  tens = [None if x is None else torch.as_tensor(x) for x in (f, t, c, w)]
  got = reductions.fused_deterministic_sums_tf32_emulation(*tens)
  plain = ops.fused_deterministic_sums_plain(*tens)
  jax_ref = jreductions.fused_deterministic_sums_reference(
      f, t, np.zeros_like(f) if c is None else c, w)
  for name, g, p, j in zip(("sums", "wsum_valid", "nan_w"), got, plain,
                           jax_ref):
    assert_same_nonfinite(g.numpy(), p.numpy(), f"{name} vs plain")
    assert_same_nonfinite(g.numpy(), j, f"{name} vs the JAX reference")
  sums = got[0].numpy()
  assert np.isposinf(sums[1, 0, 2]) and np.isneginf(sums[0, 0, 5])
  assert np.isnan(sums[0, 0, 7])  # +inf and -inf in one region
  # a region that weighs the cell zero is NaN, as fp32 gives 0 x inf
  zero = np.flatnonzero(w[:, 100] == 0)
  assert zero.size and np.isnan(sums[1, zero, 2]).all()
  # rows without infinities keep their finite sums
  assert np.isfinite(sums[:, :, [0, 1, 3]]).all()


@pytest.mark.parametrize("n_regions", [13, 16])
def test_kernel2_emulation_keeps_infinities_in_place(n_regions):
  f, _, _, w = _inputs(n_regions, seed=1)
  x, wt = torch.as_tensor(f), torch.as_tensor(w)
  got = reductions.fused_region_sums_tf32_emulation(x, wt)
  plain = ops.fused_region_sums_plain(x, wt)
  nan = np.isnan(f)
  x0 = np.where(nan, 0, f)
  jax_sums = x0 @ w.T
  for name, g, p in zip(("sums", "wsum_valid", "nan_w"), got, plain):
    assert_same_nonfinite(g.numpy(), p.numpy(), f"{name} vs plain")
  assert_same_nonfinite(got[0].numpy(), jax_sums.T, "sums vs fp32 matmul")


def test_the_split_alone_loses_the_infinities():
  """What the repair is for: without ``nonfinite_finish`` the core's sums
  of a row with one +inf cell are NaN in every region, where fp32 gives
  +inf in the regions holding the cell."""
  f, _, _, w = _inputs(13, seed=2)
  x, wt = torch.as_tensor(np.where(np.isnan(f), 0, f)), torch.as_tensor(w)
  plan = reductions.launch_plan(reductions.KIND_REGION, *x.shape, 13,
                                core=reductions.CORE_MMA)
  raw = reductions.tf32_split_sums_emulation(x, wt, plan.split_len)
  assert np.isnan(raw[:, 2].numpy()).all()
  fixed = reductions.nonfinite_finish(raw, x, wt)
  assert np.isposinf(fixed[w[:, 100] > 0, 2].numpy()).all()


# -- (b) the streaming engines ------------------------------------------------


def _emulated(monkeypatch):
  """The port's kernels replaced by their tensor-core emulations."""
  def det(forecast, truth, clim=None, region_w=None):
    f = torch.as_tensor(forecast, dtype=torch.float32)
    c = None if clim is None else torch.as_tensor(clim, dtype=torch.float32)
    return reductions.fused_deterministic_sums_tf32_emulation(
        f, torch.as_tensor(truth, dtype=torch.float32), c,
        torch.as_tensor(region_w, dtype=torch.float32))

  def region(x, region_w=None):
    return reductions.fused_region_sums_tf32_emulation(
        torch.as_tensor(x, dtype=torch.float32),
        torch.as_tensor(region_w, dtype=torch.float32))

  monkeypatch.setattr(ops, "fused_deterministic_sums", det)
  monkeypatch.setattr(ops, "fused_region_sums", region)


@pytest.fixture(scope="module")
def inf_stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_inf")
  paths = official.build_stores(str(tmp))
  fc = jxds.open_zarr(paths["forecast"])
  data = {k: np.asarray(v.data).copy()
          for k, v in fc.variables_dict().items()}
  t2 = data["2m_temperature"]  # (lead, time, lon, lat) at 30 degrees
  t2[1, 0, 3, 1] = np.inf      # -60: outside the tropics
  t2[2, 3, 7, 3] = -np.inf     # the equator
  z = data["geopotential"]
  z[0, 5, 2, 1, 4] = np.inf    # one level
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    paths["forecast"] = str(tmp / "forecast_inf.zarr")
    jxds.to_zarr(fc.copy(data=data), paths["forecast"])
  return tmp, paths


@pytest.mark.parametrize("n_regions", [13, 16])
def test_streaming_engines_agree_on_infinite_cells(inf_stores, monkeypatch,
                                                   n_regions):
  tmp, paths = inf_stores
  regions = official.sixteen_regions(paths)
  if n_regions == 13:
    regions = {k: v for k, v in regions.items()
               if isinstance(v, SliceRegion)}
  assert len(regions) == n_regions
  clim = jxds.open_zarr(paths["climatology"])
  cfgs = {"d": jconfig.Eval(
      metrics={"mse": jmetrics.MSE(), "bias": jmetrics.Bias(),
               "mae": jmetrics.MAE(), "acc": jmetrics.ACC(climatology=clim)},
      regions=regions)}
  variables = ["geopotential", "2m_temperature"]
  dc = {side: official.data_config(paths, tmp / f"{side}_{n_regions}",
                                   variables=variables)
        for side in ("jax", "port")}
  jevaluation.evaluate_with_mesh(dc["jax"], cfgs,
                                 input_chunks={"init_time": 4})
  _emulated(monkeypatch)
  official.run_port(dc["port"], cfgs, input_chunks={"init_time": 4})
  want = official.open_result(tmp / f"jax_{n_regions}", "d")
  got = official.open_result(tmp / f"port_{n_regions}", "d")
  for v in variables:
    w = want[v]
    g = got[v].transpose(*w.dims)
    assert_same_nonfinite(g.values, w.values, f"{v}, R={n_regions}")
  t2 = np.asarray(got["2m_temperature"].values)
  assert np.isinf(t2).any() and np.isnan(t2).any() and np.isfinite(t2).any()

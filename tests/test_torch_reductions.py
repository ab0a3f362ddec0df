"""The port's fused reductions against the JAX package's kernels.

The same seeded numpy inputs go through the JAX Pallas kernels in
interpret mode (as tests/test_ops.py runs them on the CPU), the JAX
``*_reference`` functions in float64, and the port's plain versions, which
are what the port's wrappers run on CPU tensors.

Tolerance: the port sums in float32 in another order than the reference,
so each output is held to ``rtol=1e-5`` plus an absolute bound of
``1e-5 × Σ_l |W·stat|`` (the magnitude of the summed terms, computed in
float64): a sum whose terms cancel can sit near zero where only an
absolute bound is meaningful.
"""
import numpy as np
import pytest
import torch

from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import ops as jops
from weatherbench2_tpu.regions import ExtraTropicalRegion, SliceRegion
from weatherbench2_torch import device as device_lib
from weatherbench2_torch import ops
from weatherbench2_torch.ops import reductions

RTOL = 1e-5


def _grid(n_lon, n_lat, n_regions):
  lat = np.linspace(-90, 90, n_lat)
  lon = np.linspace(0, 360, n_lon, endpoint=False)
  w = jmetrics._cell_area_from_latitude(np.deg2rad(lat))
  w = (w / w.mean()).astype(np.float32)
  masks = [np.ones((n_lat, n_lon)), ExtraTropicalRegion().mask_weights(
      lat, lon)]
  for i in range(n_regions - 2):
    lo = -80 + 12 * i
    masks.append(SliceRegion(lat_slice=slice(lo, lo + 35),
                             lon_slice=slice(30 * i, 30 * i + 200))
                 .mask_weights(lat, lon))
  return w, masks


def _inputs(b, n_lon, n_lat, n_regions, seed, nans=False):
  rs = np.random.RandomState(seed)
  l = n_lon * n_lat
  f = rs.randn(b, l).astype(np.float32)
  t = rs.randn(b, l).astype(np.float32)
  c = (0.3 * rs.randn(b, l)).astype(np.float32)
  if nans:
    f[1] = np.nan  # a whole NaN row
    t[3, ::7] = np.nan
    f[rs.rand(b, l) < 0.05] = np.nan
    c[rs.rand(b, l) < 0.02] = np.nan
  w, masks = _grid(n_lon, n_lat, n_regions)
  region_w = jops.make_region_weight_matrix(w, masks, n_lon)
  return f, t, c, region_w


def _det_scale(f, t, c, region_w):
  """Σ_l |W·stat| per output, float64 (the absolute tolerance's scale)."""
  f, t, c = (np.where(np.isnan(f) | np.isnan(t) | np.isnan(c), 0, x)
             .astype(np.float64) for x in (f, t, c))
  stats = [np.abs(s) for s in (f - t, (f - t) ** 2, f - t,
                                (f - c) * (t - c), (f - c) ** 2,
                                (t - c) ** 2)]
  aw = np.abs(region_w.astype(np.float64)).T
  sums = np.stack([s @ aw for s in stats]).transpose(0, 2, 1)
  ones = np.ones_like(f) @ aw
  return sums, ones.T, (np.ones_like(f) @ (region_w > 0).T).T


def _close(got, want, scale, what):
  """|got - want| <= rtol·|want| + rtol·scale (scale None: rtol only)."""
  got = np.asarray(got, dtype=np.float64)
  want = np.asarray(want, dtype=np.float64)
  bound = RTOL * np.abs(want)
  if scale is not None:
    bound = bound + RTOL * np.asarray(scale)
  err = np.abs(got - want)
  assert np.all(err <= bound), (
      f"{what}: max err {err.max()}, worst err/bound "
      f"{(err / np.maximum(bound, 1e-30)).max()}")


@pytest.mark.parametrize(
    "b, n_lon, n_lat, n_regions, nans, with_clim",
    [
        (8, 20, 15, 3, False, True),       # (8, 300), R = 3
        (16, 40, 25, 13, True, True),      # (16, 1000), R = 13, NaNs
        (16, 40, 25, 13, True, False),     # clim=None
        (8, 20, 15, 3, False, False),
    ],
)
def test_fused_deterministic_sums_match_reference(b, n_lon, n_lat, n_regions,
                                                  nans, with_clim):
  f, t, c, region_w = _inputs(b, n_lon, n_lat, n_regions, seed=b + n_regions,
                              nans=nans)
  clim = c if with_clim else None
  c_ref = c if with_clim else np.zeros_like(f)
  got = ops.fused_deterministic_sums(f, t, clim, region_w)
  want64 = jops.fused_deterministic_sums_reference(
      f.astype(np.float64), t.astype(np.float64), c_ref.astype(np.float64),
      region_w.astype(np.float64))
  pallas = jops.fused_deterministic_sums(f, t, clim, region_w,
                                         interpret=True)
  scale = _det_scale(f, t, c_ref, region_w)
  for i, name in enumerate(("sums", "wsum_valid", "nan_w")):
    assert tuple(got[i].shape) == want64[i].shape
    assert got[i].dtype == torch.float32
    _close(got[i], want64[i], scale[i], f"{name} vs float64 reference")
    _close(got[i], np.asarray(pallas[i]), scale[i], f"{name} vs Pallas")


@pytest.mark.parametrize("n_regions", [3, 13])
def test_fused_region_sums_per_row_nans(n_regions):
  rs = np.random.RandomState(n_regions)
  n_lon, n_lat = 24, 13
  x = rs.randn(30, n_lon * n_lat).astype(np.float32)
  x[0] = np.nan  # whole row
  x[5, :40] = np.nan  # part of a row
  x[rs.rand(*x.shape) < 0.03] = np.nan
  w, masks = _grid(n_lon, n_lat, n_regions)
  region_w = jops.make_region_weight_matrix(w, masks, n_lon)
  got = ops.fused_region_sums(x, region_w)
  want64 = jops.fused_region_sums_reference(
      x.astype(np.float64), region_w.astype(np.float64))
  pallas = jops.fused_region_sums(x, region_w, interpret=True)
  aw = np.abs(region_w.astype(np.float64))
  x0 = np.nan_to_num(np.abs(x.astype(np.float64)))
  scales = ((x0 @ aw.T).T, (np.ones_like(x0) @ aw.T).T, None)
  for i, name in enumerate(("sums", "wsum_valid", "nan_w")):
    _close(got[i], want64[i], scales[i], f"{name} vs float64 reference")
    _close(got[i], np.asarray(pallas[i]), scales[i], f"{name} vs Pallas")
  # row 0 is all NaN: no valid weight, and every region with weight saw it
  assert np.all(np.asarray(got[1])[:, 0] == 0)
  assert np.all(np.asarray(got[2])[:, 0] > 0)


def test_make_region_weight_matrix_matches_reference():
  w, masks = _grid(30, 17, 13)
  np.testing.assert_array_equal(
      ops.make_region_weight_matrix(w, masks, 30),
      jops.make_region_weight_matrix(w, masks, 30))


@pytest.mark.parametrize("skipna", [False, True])
@pytest.mark.parametrize("with_clim", [False, True])
def test_fused_deterministic_metrics_both_skipna_modes(skipna, with_clim):
  f, t, c, region_w = _inputs(12, 20, 15, 3, seed=7, nans=True)
  clim = c if with_clim else None
  got = ops.fused_deterministic_metrics(f, t, clim, region_w, skipna=skipna)
  want = jops.fused_deterministic_metrics(
      f.astype(np.float64), t.astype(np.float64),
      None if clim is None else clim.astype(np.float64),
      region_w.astype(np.float64), skipna=skipna, use_pallas=False)
  assert set(got) == set(want)
  for k in want:
    g, w = np.asarray(got[k], np.float64), np.asarray(want[k])
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
    # means of float32 sums: rtol 1e-5, atol 1e-5 of the metric's scale
    np.testing.assert_allclose(g, w, rtol=RTOL,
                               atol=RTOL * np.nanmax(np.abs(w), initial=0),
                               err_msg=k)


def test_cpu_wrappers_do_not_count_launches():
  f, t, c, region_w = _inputs(8, 20, 15, 3, seed=1)
  before = (ops.fused_deterministic_sums.launches,
            ops.fused_region_sums.launches)
  ops.fused_deterministic_sums(f, t, c, region_w)
  ops.fused_region_sums(f, region_w)
  assert before == (0, 0)
  assert (ops.fused_deterministic_sums.launches,
          ops.fused_region_sums.launches) == (0, 0)


def test_wrappers_refuse_other_devices_and_bad_shapes():
  f, t, c, region_w = _inputs(8, 20, 15, 3, seed=2)
  meta = torch.empty(f.shape, device="meta")
  with pytest.raises(ValueError, match="unsupported device"):
    ops.fused_deterministic_sums(meta, meta, None, torch.empty(
        region_w.shape, device="meta"))
  with pytest.raises(ValueError, match="shape mismatch"):
    ops.fused_deterministic_sums(f, t[:, :-1], None, region_w)
  with pytest.raises(ValueError, match="region_w is required"):
    ops.fused_region_sums(f)


def test_resolve_raises_without_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    device_lib.resolve()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    device_lib.resolve("cuda")
  assert device_lib.resolve("cpu") == torch.device("cpu")
  assert not torch.backends.cuda.matmul.allow_tf32
  assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("rows, cols", [(1008, 29040), (126, 1038240),
                                        (4032, 29040), (3, 5), (8, 300)])
def test_split_plan_covers_the_cell_axis(rows, cols):
  n_splits, split_len = reductions.split_plan(rows, cols)
  assert split_len % 128 == 0
  assert (n_splits - 1) * split_len < cols <= n_splits * split_len
  assert 1 <= n_splits <= 65535

"""The tensor-core core's arithmetic (3xTF32), emulated on the CPU.

``csrc/reductions.cu`` multiplies on the tensor cores in TF32 and recovers
float32 accuracy by splitting each operand into two TF32 numbers and
summing three products in short chains.  ``chip_smoke.py`` holds the
kernel on the card to its plain version and, bit for bit, to
``reductions.tf32_split_sums_emulation``, the same arithmetic written in
torch.  Here that emulation is held against float64 at the official
0.25-degree length with weather-like magnitudes and against the JAX
package's float64 references on seeded numpy inputs, and plain one-term
TF32 is shown to fail the same tolerance.

Tolerance: ``|got - ref| <= 1e-5 * (|ref| + sum_l |W * stat|)``, as for the
kernels: the split loses about 2**-21 of each term and the float32 sums of
chains and splits round like any float32 sum.
"""
import numpy as np
import pytest
import torch

from weatherbench2_tpu import ops as jops
from weatherbench2_torch import metrics
from weatherbench2_torch.ops import reductions
from weatherbench2_torch.regions import SliceRegion

RTOL = 1e-5
N_LON, N_LAT = 1440, 721  # 1 038 240 cells


def _thirteen_region_weights():
  lat = np.linspace(-90, 90, N_LAT)
  lon = np.linspace(0, 360, N_LON, endpoint=False)
  w = metrics._cell_area_from_latitude(np.deg2rad(lat))
  w = (w / w.mean()).astype(np.float32)
  regions = [
      SliceRegion(), SliceRegion(lat_slice=slice(-20, 20)),
      SliceRegion(lat_slice=[slice(None, -20), slice(20, None)]),
      SliceRegion(lat_slice=slice(20, None)),
      SliceRegion(lat_slice=slice(None, -20)),
      SliceRegion(lat_slice=slice(35, 75),
                  lon_slice=[slice(347.5, None), slice(0, 42.5)]),
      SliceRegion(lat_slice=slice(25, 60), lon_slice=slice(240, 285)),
      SliceRegion(lat_slice=slice(25, 65), lon_slice=slice(290, 350)),
      SliceRegion(lat_slice=slice(25, 60), lon_slice=slice(145, 230)),
      SliceRegion(lat_slice=slice(25, 60), lon_slice=slice(102.5, 150)),
      SliceRegion(lat_slice=slice(-45, -12.5), lon_slice=slice(120, 175)),
      SliceRegion(lat_slice=slice(60, 90)),
      SliceRegion(lat_slice=slice(-90, -60)),
  ]
  return torch.as_tensor(reductions.make_region_weight_matrix(
      w, [r.mask_weights(lat, lon) for r in regions], N_LON))


@pytest.fixture(scope="module")
def weather():
  """Three geopotential-like rows (~5e4, forecast errors ~1e2, so squares
  ~1e4), one of them all NaN, with scattered NaNs; thirteen regions."""
  rs = np.random.RandomState(2020)
  l = N_LON * N_LAT
  t = (5e4 + 3e3 * rs.randn(3, l)).astype(np.float32)
  f = (t + 1e2 * rs.randn(3, l)).astype(np.float32)
  c = (t + 5e2 * rs.randn(3, l)).astype(np.float32)
  f[1] = np.nan
  t[2, rs.rand(l) < 0.01] = np.nan
  c[0, rs.rand(l) < 0.005] = np.nan
  f, t, c = (torch.as_tensor(x) for x in (f, t, c))
  w = _thirteen_region_weights()
  stats, valid, nan = reductions._det_stats(f, t, c)
  w64 = w.double().T
  ref = torch.stack([(s.double() @ w64).T for s in stats + [valid]])
  scale = torch.stack([(s.double().abs() @ w64.abs()).T
                       for s in stats + [valid]])
  ref_nan = (nan.double() @ (w > 0).double().T).T
  return f, t, c, w, ref, scale, ref_nan


def _worst(got, ref, scale):
  """max of |got - ref| / (rtol * (|ref| + scale)): <= 1 passes."""
  bound = RTOL * (ref.abs() + scale)
  return float(((got.double() - ref).abs() / bound.clamp_min(1e-300)).max())


def test_three_term_split_holds_float32_tolerance_at_full_length(weather):
  f, t, c, w, ref, scale, ref_nan = weather
  sums, wsum, nanw = reductions.fused_deterministic_sums_tf32_emulation(
      f, t, c, w)
  got = torch.cat([sums, wsum[None]])
  assert got.shape == ref.shape and got.dtype == torch.float32
  assert _worst(got, ref, scale) <= 1.0
  # as close as the plain float32 version, within a factor of a few
  plain = reductions.fused_deterministic_sums_plain(f, t, c, w)
  plain = torch.cat([plain[0], plain[1][None]])
  assert _worst(got, ref, scale) <= 4 * max(_worst(plain, ref, scale), 0.02)
  # NaN accounting is exact: 0/1 masks and (W > 0) are TF32 numbers
  assert torch.equal(nanw.double(), ref_nan)
  assert bool((wsum[:, 1] == 0).all())      # the all-NaN row
  assert bool((sums[:, :, 1] == 0).all())
  assert bool((nanw[:, 1] > 0).all())


def test_one_term_tf32_fails_the_tolerance(weather):
  f, t, c, w, ref, scale, _ = weather
  sums, wsum, _ = reductions.fused_deterministic_sums_tf32_emulation(
      f, t, c, w, terms=1)
  got = torch.cat([sums, wsum[None]])
  # plain TF32 keeps three decimal digits of every product; over a million
  # cells the rounding errors partly cancel and still end outside (3x here)
  assert _worst(got, ref, scale) > 2.0


def test_no_climatology_statistics_are_the_large_ones(weather):
  # without a climatology the anomaly products are f*t, f*f, t*t (~2.5e9)
  f, t, _, w, _, _, _ = weather
  f, t = f[:1], t[:1]
  sums, wsum, _ = reductions.fused_deterministic_sums_tf32_emulation(
      f, t, None, w)
  stats, valid, _ = reductions._det_stats(f, t, None)
  w64 = w.double().T
  ref = torch.stack([(s.double() @ w64).T for s in stats + [valid]])
  scale = torch.stack([(s.double().abs() @ w64.abs()).T
                       for s in stats + [valid]])
  assert _worst(torch.cat([sums, wsum[None]]), ref, scale) <= 1.0


@pytest.mark.parametrize("chain_stages", [1, 2, 8])
@pytest.mark.parametrize("l", [2112, 2015, 40])
def test_split_emulation_small_shapes(l, chain_stages):
  rs = np.random.RandomState(l + chain_stages)
  stat = torch.as_tensor((1e3 * rs.randn(5, l)).astype(np.float32))
  w = torch.as_tensor(rs.rand(7, l).astype(np.float32))
  got = reductions.tf32_split_sums_emulation(stat, w, 128,
                                             chain_stages=chain_stages)
  ref = (stat.double() @ w.double().T).T
  scale = (stat.double().abs() @ w.double().abs().T).T
  assert _worst(got, ref, scale) <= 1.0
  with pytest.raises(ValueError, match="whole stages"):
    reductions.tf32_split_sums_emulation(stat, w, 100)
  with pytest.raises(ValueError, match="terms"):
    reductions.tf32_split_sums_emulation(stat, w, 128, terms=2)


def test_tf32_round_and_truncate_bits():
  x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-11 + 2.0**-23,
                    -(1.0 + 2.0**-11), 1.0 + 2.0**-10, 3.0e38, 0.0,
                    -7.5e-5])
  hi = reductions.tf32_round(x)
  # ties go away from zero, on either sign
  assert hi[1] == 1.0 + 2.0**-10 and hi[3] == -(1.0 + 2.0**-10)
  assert hi[0] == 1.0 and hi[2] == 1.0 + 2.0**-10 and hi[4] == x[4]
  lo = x - hi
  assert torch.equal((hi.double() + lo.double()).float(), x)  # exact split
  assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
  tr = reductions.tf32_truncate(x)
  assert bool((tr.view(torch.int32) & 0x1FFF == 0).all())
  assert bool((tr.abs() <= x.abs()).all())
  assert bool(((x - tr).abs() <= x.abs() * 2.0**-10).all())


def test_tensor_core_add_truncates_as_the_card_does():
  one = torch.ones(1)
  zeros = torch.zeros(1, 8)

  def add(acc, products):
    a, b = zeros.clone(), zeros.clone()
    for k, (x, y) in enumerate(products):
      a[0, k], b[0, k] = x, y
    return reductions.tensor_core_add(acc, a, b)

  # the sum is cut toward zero: 1 + 0.75 ulp stays 1 (nearest would step)
  assert add(one, [(0.75, 2.0**-23)]) == 1.0
  assert add(-one, [(-0.75, 2.0**-23)]) == -1.0
  assert add(one, [(1.0, 2.0**-23)]) == 1.0 + 2.0**-23
  # two guard bits: quarters of an ulp add up, eighths are cut one by one
  assert add(one, [(1.0, 2.0**-25)] * 4) == 1.0 + 2.0**-23
  assert add(one, [(1.0, 2.0**-26)] * 8) == 1.0
  # a product aligns by the sum of its factors' exponents: 1.5 * 1.5 = 2.25
  # counts as exponent 0, so the grid is 2^-25 and 1.5 * 2^-25 is cut to 2^-25
  assert add(torch.zeros(1), [(1.5, 1.5), (1.5, 2.0**-25)]) == 2.25
  assert add(torch.zeros(1), [(1.5, 1.5), (1.0, 2.0**-22)]) == (
      2.25 + 2.0**-22)
  # an MMA of zeros changes nothing, and zeros give zero
  assert add(torch.full((1,), 1.2345678), []) == torch.full((1,), 1.2345678)
  assert add(torch.zeros(1), []) == 0.0


@pytest.mark.parametrize("with_clim", [True, False])
def test_emulation_matches_the_jax_reference(with_clim):
  rs = np.random.RandomState(13)
  n_lon, n_lat, b = 48, 22, 9  # 1056 cells
  lat = np.linspace(-90, 90, n_lat)
  lon = np.linspace(0, 360, n_lon, endpoint=False)
  lw = metrics._cell_area_from_latitude(np.deg2rad(lat))
  lw = (lw / lw.mean()).astype(np.float32)
  masks = [SliceRegion().mask_weights(lat, lon)] + [
      SliceRegion(lat_slice=slice(-80 + 12 * i, -45 + 12 * i),
                  lon_slice=slice(30 * i, 30 * i + 200)).mask_weights(lat, lon)
      for i in range(12)]
  region_w = jops.make_region_weight_matrix(lw, masks, n_lon)
  l = n_lon * n_lat
  t = (5e4 + 3e3 * rs.randn(b, l)).astype(np.float32)
  f = (t + 1e2 * rs.randn(b, l)).astype(np.float32)
  c = (t + 5e2 * rs.randn(b, l)).astype(np.float32)
  f[1] = np.nan
  t[rs.rand(b, l) < 0.02] = np.nan
  c_ref = c if with_clim else np.zeros_like(f)
  want = jops.fused_deterministic_sums_reference(
      f.astype(np.float64), t.astype(np.float64), c_ref.astype(np.float64),
      region_w.astype(np.float64))
  got = reductions.fused_deterministic_sums_tf32_emulation(
      torch.as_tensor(f), torch.as_tensor(t),
      torch.as_tensor(c) if with_clim else None, torch.as_tensor(region_w))
  stats, valid, _ = reductions._det_stats(
      torch.as_tensor(f), torch.as_tensor(t), torch.as_tensor(c_ref))
  aw = torch.as_tensor(region_w).double().abs().T
  scale = torch.stack([(x.double().abs() @ aw).T for x in stats + [valid]])
  ref = torch.as_tensor(np.concatenate([want[0], want[1][None]]))
  assert _worst(torch.cat([got[0], got[1][None]]), ref, scale) <= 1.0
  assert np.array_equal(got[2].numpy(), want[2])

  x = torch.as_tensor(f)
  got2 = reductions.fused_region_sums_tf32_emulation(
      x, torch.as_tensor(region_w))
  want2 = jops.fused_region_sums_reference(f.astype(np.float64),
                                           region_w.astype(np.float64))
  x0 = torch.nan_to_num(x).double().abs()
  scale2 = torch.stack([(x0 @ aw).T, (torch.ones_like(x0) @ aw).T])
  assert _worst(torch.stack(got2[:2]), torch.as_tensor(
      np.stack(want2[:2])), scale2) <= 1.0
  assert np.array_equal(got2[2].numpy(), want2[2])


def test_statistic_split_keeps_twenty_one_bits():
  # a statistic's hi is v rounded to TF32; lo = v - hi, of which the tensor
  # core reads the truncation
  rs = np.random.RandomState(5)
  x = torch.as_tensor((rs.randn(4096) * 10.0 ** rs.randint(-8, 9, 4096))
                      .astype(np.float32))
  hi = reductions.tf32_round(x)
  lo = reductions.tf32_truncate(x - hi)
  err = (x.double() - hi.double() - lo.double()).abs()
  assert bool((err <= x.double().abs() * 2.0**-21).all())
  assert bool(((x.double() - hi.double()).abs()
               <= x.double().abs() * 2.0**-11).all())


def _one_point_five_degree(n_regions, rows, seed):
  n_lon, n_lat = 240, 121
  lat = np.linspace(-90, 90, n_lat)
  lon = np.linspace(0, 360, n_lon, endpoint=False)
  lw = metrics._cell_area_from_latitude(np.deg2rad(lat))
  lw = (lw / lw.mean()).astype(np.float32)
  masks = [SliceRegion().mask_weights(lat, lon)] + [
      SliceRegion(lat_slice=slice(-80 + 10 * i, -45 + 10 * i),
                  lon_slice=slice(20 * i, 20 * i + 150)).mask_weights(lat, lon)
      for i in range(n_regions - 1)]
  w = torch.as_tensor(reductions.make_region_weight_matrix(lw, masks, n_lon))
  rs = np.random.RandomState(seed)
  l = n_lon * n_lat
  t = (5e4 + 3e3 * rs.randn(rows, l)).astype(np.float32)
  f = (t + 1e2 * rs.randn(rows, l)).astype(np.float32)
  c = (t + 5e2 * rs.randn(rows, l)).astype(np.float32)
  f[rs.rand(rows, l) < 0.01] = np.nan
  return [torch.as_tensor(x) for x in (f, t, c)] + [w]


@pytest.mark.parametrize("with_clim", [True, False])
def test_kernel1_emulation_at_sixteen_regions_holds_the_tolerance(with_clim):
  # sixteen regions over WB2's 1.5-degree grid, as the official
  # configuration launches kernel 1 (without a climatology)
  f, t, c, w = _one_point_five_degree(16, 3, 16)
  c = c if with_clim else None
  sums, wsum, nanw = reductions.fused_deterministic_sums_tf32_emulation(
      f, t, c, w)
  stats, valid, nan = reductions._det_stats(f, t, c)
  w64 = w.double().T
  ref = torch.stack([(s.double() @ w64).T for s in stats + [valid]])
  scale = torch.stack([(s.double().abs() @ w64.abs()).T
                       for s in stats + [valid]])
  assert _worst(torch.cat([sums, wsum[None]]), ref, scale) <= 1.0
  assert torch.equal(nanw.double(), (nan.double() @ (w > 0).double().T).T)


def test_tensor_core_emulation_is_the_split_sums_of_its_plan():
  # kernel 1's emulation is the split sums at the planned core's split
  # length (one-stage splits where the rows are few)
  f, t, c, w = _one_point_five_degree(13, 2, 13)
  stats, valid, _ = reductions._det_stats(f, t, c)
  plan = reductions.launch_plan(reductions.KIND_DET_CLIM, 2, f.shape[1], 13)
  assert plan.core == reductions.CORE_MMA
  got = reductions.fused_deterministic_sums_tf32_emulation(f, t, c, w)
  for k, s in enumerate(stats):
    assert torch.equal(got[0][k], reductions.nonfinite_finish(
        reductions.tf32_split_sums_emulation(s, w, plan.split_len), s, w))
  assert torch.equal(got[1], reductions.tf32_split_sums_emulation(
      valid, w, plan.split_len))

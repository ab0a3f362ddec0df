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
import ctypes
import re

import numpy as np
import pytest
import torch

from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import ops as jops
from weatherbench2_tpu.regions import ExtraTropicalRegion, SliceRegion
from weatherbench2_torch import device as device_lib
from weatherbench2_torch import ops
from weatherbench2_torch.ops import _build as build_lib
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


@pytest.mark.parametrize("rows, cols, rows_per_block, target", [
    (1008, 29040, 8, 1056), (1008, 29040, 64, 264), (126, 1038240, 64, 264),
    (4032, 29040, 128, 264), (63, 1038240, 64, 264)])
def test_split_plan_reaches_or_stays_within_its_target(rows, cols,
                                                       rows_per_block, target):
  row_blocks = -(-rows // rows_per_block)
  # rounded up: the grid reaches the target unless the splits run out
  n_up, len_up = reductions.split_plan(rows, cols, rows_per_block, target)
  assert (n_up + 1) * row_blocks > target or n_up * len_up >= cols > (
      n_up - 1) * len_up
  # one wave: never more blocks than the target
  n_down, _ = reductions.split_plan(rows, cols, rows_per_block, target,
                                    one_wave=True)
  assert n_down * row_blocks <= max(target, row_blocks)
  assert n_down <= n_up


def test_split_plan_of_the_cuda_core_path_is_unchanged():
  # (1008, 29040): 126 row blocks, 1056 / 126 rounded up = 9 splits
  assert reductions.split_plan(1008, 29040) == (9, 3328)
  # the vec4 core plans in waves of its 396 resident blocks: three splits,
  # one wave (each block's exit pays its tail)
  plan = reductions.launch_plan(reductions.KIND_DET, 1008, 29040, 3)
  assert (plan.n_splits, plan.split_len) == (3, 9728)
  # the tensor-core plan (64 rows a block) stays within one wave of 264
  # blocks
  plan = reductions.launch_plan(reductions.KIND_DET, 1008, 29040, 13)
  assert plan.core == reductions.CORE_MMA
  assert plan.grid == (16, 16)


# -- the host-side launch plan -------------------------------------------------

_PLAN_ROWS = [1, 7, 126, 1008, 4032]
_PLAN_COLS = [2015, 2112, 29040, 1038240]
_PLAN_REGIONS = [1, 4, 5, 13, 16]
_KINDS = [reductions.KIND_DET_CLIM, reductions.KIND_DET,
          reductions.KIND_REGION]


@pytest.mark.parametrize("n_regions", _PLAN_REGIONS)
@pytest.mark.parametrize("cols", _PLAN_COLS)
@pytest.mark.parametrize("rows", _PLAN_ROWS)
def test_launch_plan_covers_rows_and_cells_once(rows, cols, n_regions):
  for kind in _KINDS:
    plan = reductions.launch_plan(kind, rows, cols, n_regions)
    # the cell axis: splits tile [0, cols) exactly once, none empty
    assert (plan.n_splits - 1) * plan.split_len < cols
    assert cols <= plan.n_splits * plan.split_len
    assert 1 <= plan.n_splits <= 65535
    # every core's step divides a split: 128 cells for the CUDA-core
    # cores, a 32-cell stage for the tensor-core one
    tensor = plan.core == reductions.CORE_MMA
    assert plan.split_len % (reductions.MMA_STAGE_CELLS if tensor
                             else 128) == 0
    assert plan.split_len % reductions.MMA_STAGE_CELLS == 0
    # the row axis: row blocks tile [0, rows) exactly once, none empty
    row_blocks, n_splits = plan.grid
    assert n_splits == plan.n_splits
    assert (row_blocks - 1) * plan.rows_per_block < rows
    assert rows <= row_blocks * plan.rows_per_block
    # which core: odd lengths cannot take 16-byte loads; up to four
    # regions the CUDA cores (kernel 2 streaming), else the tensor cores
    region = kind == reductions.KIND_REGION
    if cols % 4:
      assert plan.core == reductions.CORE_SCALAR
    elif n_regions <= 4:
      assert plan.core == (reductions.CORE_STREAM if region
                           else reductions.CORE_VEC4)
    else:
      assert plan.core == reductions.CORE_MMA
    want_rows = {reductions.CORE_MMA: reductions.MMA_ROWS_PER_BLOCK[kind],
                 reductions.CORE_STREAM: reductions.STREAM_ROWS_PER_BLOCK
                 }.get(plan.core, 8)
    assert plan.rows_per_block == want_rows
    # the tail's counters: the grid barrier's two, then a row each (the
    # tensor-core core's non-finite flags) or a row block each
    assert plan.n_counters == 2 + (rows if tensor else row_blocks)
    # scratch and output shapes, as the C entry points are told them
    n_out = 3 if kind == reductions.KIND_REGION else 8
    assert plan.partial_shape == (plan.n_splits, n_out, n_regions, rows)
    assert plan.out_shape == (n_out, n_regions, rows)


@pytest.mark.parametrize("kind", _KINDS)
def test_launch_plan_unaligned_and_forced_cores(kind):
  plan = reductions.launch_plan(kind, 126, 2112, 13, aligned=False)
  assert plan.core == reductions.CORE_SCALAR
  for core in (reductions.CORE_SCALAR, reductions.CORE_VEC4,
               reductions.CORE_MMA):
    assert reductions.launch_plan(kind, 126, 2112, 4, core=core).core == core
  for core in (reductions.CORE_SCALAR, reductions.CORE_MMA):
    assert reductions.launch_plan(kind, 126, 2112, 13, core=core).core == core
  # the CUDA-core 16-byte core is built for up to four regions
  with pytest.raises(ValueError, match="four regions"):
    reductions.launch_plan(kind, 126, 2112, 5, core=reductions.CORE_VEC4)
  with pytest.raises(ValueError, match="16-byte cores"):
    reductions.launch_plan(kind, 126, 2015, 13, core=reductions.CORE_MMA)
  with pytest.raises(ValueError, match="16-byte cores"):
    reductions.launch_plan(kind, 126, 2112, 13, aligned=False,
                           core=reductions.CORE_VEC4)
  with pytest.raises(ValueError, match="unknown core"):
    reductions.launch_plan(kind, 126, 2112, 13, core=4)
  for bad in (0, 17):
    with pytest.raises(ValueError, match="regions"):
      reductions.launch_plan(kind, 126, 2112, bad)
  with pytest.raises(ValueError, match="empty input"):
    reductions.launch_plan(kind, 0, 2112, 13)


@pytest.mark.parametrize("kind", _KINDS)
def test_launch_plan_new_cores_refuse_what_they_cannot_take(kind):
  region = kind == reductions.KIND_REGION
  # the streaming core is kernel 2's, up to four regions; the tensor-core
  # core takes either kernel at any number of regions
  if region:
    plan = reductions.launch_plan(kind, 330, 29040, 2,
                                  core=reductions.CORE_STREAM)
    assert plan.core == reductions.CORE_STREAM
    with pytest.raises(ValueError, match="four regions"):
      reductions.launch_plan(kind, 126, 2112, 5,
                             core=reductions.CORE_STREAM)
  else:
    with pytest.raises(ValueError, match="fused_region_sums"):
      reductions.launch_plan(kind, 126, 2112, 3, core=reductions.CORE_STREAM)
  plan = reductions.launch_plan(kind, 336, 29040, 3,
                                core=reductions.CORE_MMA)
  assert plan.core == reductions.CORE_MMA
  for core in (reductions.CORE_STREAM, reductions.CORE_MMA):
    with pytest.raises(ValueError, match="16-byte cores"):
      reductions.launch_plan(kind, 126, 2015, 3, core=core)
    with pytest.raises(ValueError, match="16-byte cores"):
      reductions.launch_plan(kind, 126, 2112, 3, aligned=False, core=core)
  # what cores_for lists is what a forced plan takes
  for n_regions in (1, 4, 5, 16):
    takes = reductions.cores_for(kind, n_regions)
    for core in reductions.CORE_NAMES:
      if core in takes:
        assert reductions.launch_plan(kind, 70, 2112, n_regions,
                                      core=core).core == core
      else:
        with pytest.raises(ValueError):
          reductions.launch_plan(kind, 70, 2112, n_regions, core=core)


@pytest.mark.parametrize("rows, cols, rows_per_block, slots", [
    (8580, 29040, 8, 528), (660, 29040, 8, 528), (330, 29040, 8, 528),
    (4290, 29040, 8, 528), (1, 1024, 8, 528), (70, 2112, 8, 528),
    (126, 1038240, 8, 528), (3, 5, 8, 528)])
def test_balanced_split_plan_fills_its_last_wave(rows, cols, rows_per_block,
                                                 slots):
  n_splits, split_len = reductions.balanced_split_plan(
      rows, cols, rows_per_block, slots, 1024, 1024)
  assert split_len % 128 == 0
  assert (n_splits - 1) * split_len < cols <= n_splits * split_len
  row_blocks = -(-rows // rows_per_block)
  waves = -(-row_blocks * n_splits // slots)
  # no other number of splits finishes sooner (waves x block length, a
  # block's start counted as 1024 cells)
  for n in range(1, max(1, cols // 1024) + 1):
    length = -(-(-(-cols // n)) // 128) * 128
    other = -(-row_blocks * -(-cols // length) // slots) * (length + 1024)
    assert waves * (split_len + 1024) <= other
  assert split_len >= 1024 or n_splits == 1


def test_stream_plans_at_the_averages_and_moments_rows():
  # few rows: one wave of 12 splits (504 blocks of 528); many rows: four
  # splits, nine waves
  plan = reductions.launch_plan(reductions.KIND_REGION, 330, 29040, 2)
  assert plan.core == reductions.CORE_STREAM
  assert (plan.n_splits, plan.split_len) == (12, 2432)
  plan = reductions.launch_plan(reductions.KIND_REGION, 8580, 29040, 1)
  assert (plan.n_splits, plan.split_len) == (4, 7296)
  # one split: pass 1 writes the outputs, the wrapper allocates no partial
  plan = reductions.launch_plan(reductions.KIND_REGION, 60000, 2048, 1)
  assert plan.n_splits == 1


@pytest.mark.parametrize("kind", _KINDS)
def test_tensor_core_plans_of_many_rows_take_one_split(kind):
  # more row blocks than a wave holds: one split, and the launch takes a
  # wave of blocks that walk the row blocks (the C launch's grid)
  plan = reductions.launch_plan(kind, 40000, 29040, 16)
  assert plan.core == reductions.CORE_MMA
  assert plan.n_splits == 1 and plan.split_len >= 29040
  assert plan.grid[0] > 2 * reductions.N_SMS


def test_launch_plan_follows_the_cards_sm_count():
  plan = reductions.launch_plan(reductions.KIND_DET, 1008, 29040, 16,
                                n_sms=114)
  assert plan.grid[0] * plan.grid[1] <= (
      reductions.MMA_BLOCKS_PER_SM * 114)
  plan = reductions.launch_plan(reductions.KIND_REGION, 336, 1024, 16,
                                n_sms=114)
  assert plan.grid[0] * plan.grid[1] <= 2 * 114


def test_launch_plan_fills_the_card_at_the_official_shape():
  # 126 rows are two row blocks of kernel 1 and one of kernel 2: the
  # splits bring the grid to one wave of two blocks on each of 132 SMs
  for kind in _KINDS:
    plan = reductions.launch_plan(kind, 126, 1038240, 13)
    blocks = plan.grid[0] * plan.grid[1]
    assert 132 <= blocks <= 2 * 132, (kind, plan)


def test_is_aligned_sees_a_view_off_sixteen_bytes():
  buf = torch.zeros(4 * 2112 + 4)
  base = buf.data_ptr() % 16 // 4  # elements past a 16-byte boundary
  aligned = buf[(4 - base) % 4:][:4 * 2112].view(4, 2112)
  shifted = buf[(4 - base) % 4 + 1:][:4 * 2112].view(4, 2112)
  assert reductions._is_aligned(aligned, None)
  assert not reductions._is_aligned(aligned, shifted)


# -- the C interface, read from the CUDA source --------------------------------

_CTYPES_OF = {"int": ctypes.c_int, "int64_t": ctypes.c_int64}


def _extern_c_declarations():
  """{name: [ctypes type per parameter]} of the int-returning extern "C"
  functions in the CUDA source."""
  text = build_lib.SOURCE.read_text()
  text = text[text.index('extern "C" {'):]
  text = re.sub(r"//[^\n]*", "", text)
  found = {}
  for name, params in re.findall(r"\bint\s+(wb2_\w+)\s*\(([^)]*)\)\s*\{", text):
    types = []
    for param in params.split(","):
      words = param.replace("*", " * ").split()
      if "*" in words:
        types.append(ctypes.c_void_p)
      else:
        types.append(_CTYPES_OF[[w for w in words if w != "const"][0]])
    found[name] = types
  return found


def test_ctypes_signatures_match_the_cuda_source():
  declared = _extern_c_declarations()
  assert set(declared) == set(build_lib._SIGNATURES)
  for name, types in declared.items():
    assert build_lib._SIGNATURES[name] == types, name


def test_python_constants_match_the_cuda_source():
  text = build_lib.SOURCE.read_text()

  def constant(pattern):
    return int(re.search(pattern, text).group(1))

  assert constant(r"constexpr int kStageCells = (\d+);") == (
      reductions.MMA_STAGE_CELLS)
  warps = constant(r"constexpr int kMmaWarps = (\d+);")
  tiles = constant(r"constexpr int kRegionTiles = (\d+);")
  assert reductions.MMA_ROWS_PER_BLOCK == {
      reductions.KIND_DET_CLIM: warps * 8, reductions.KIND_DET: warps * 8,
      reductions.KIND_REGION: warps * 8 * tiles}
  assert constant(r"constexpr int kWarps = (\d+);") == (
      reductions._ROWS_PER_BLOCK)
  for name, value in (("kCoreScalar", reductions.CORE_SCALAR),
                      ("kCoreVec4", reductions.CORE_VEC4),
                      ("kCoreMma", reductions.CORE_MMA),
                      ("kCoreStream", reductions.CORE_STREAM)):
    assert constant(rf"constexpr int {name} = (\d+);") == value
  assert len(re.findall(r"constexpr int kCore\w+ = \d+;", text)) == len(
      reductions.CORE_NAMES)
  # the streaming core's geometry
  assert constant(r"constexpr int kStreamRows = (\d+);") == (
      reductions.STREAM_ROWS_PER_BLOCK)
  # the streaming ring: STREAM_BLOCKS_PER_SM blocks fit an SM, as the
  # kernel's launch bounds ask
  seg = constant(r"constexpr int kStreamSeg = (\d+);")
  s_stages = constant(r"constexpr int kStreamStages = (\d+);")
  s_regions = constant(r"constexpr int kStreamRegions = (\d+);")
  s_smem = s_stages * (reductions.STREAM_ROWS_PER_BLOCK + s_regions) * seg * 4
  assert reductions.STREAM_BLOCKS_PER_SM * (s_smem + 64 + 1024) <= 233472
  assert constant(r"__launch_bounds__\(kStreamThreads, (\d+)\)") == (
      reductions.STREAM_BLOCKS_PER_SM)
  assert constant(r"__launch_bounds__\(kMmaThreads, (\d+)\)") == (
      reductions.MMA_BLOCKS_PER_SM)
  # dynamic shared memory of two resident blocks fits the SM's 227 KB
  stages = constant(r"constexpr int kStages = (\d+);")
  k_j = reductions.MMA_STAGE_CELLS // 16
  for n_arrays, n_tiles in ((3, 1), (2, 1), (1, tiles)):
    smem = 16 * (stages * n_arrays * k_j * n_tiles * warps * 32
                 + 2 * 3 * k_j * 2 * 32)
    assert 2 * (smem + 1024) <= 232448

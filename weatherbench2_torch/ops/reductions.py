"""Fused multi-region weighted reductions: CUDA kernels and plain versions.

Counterpart of ``weatherbench2_tpu/ops/reductions.py``.  The verification
hot loop is ``error statistic → × (area weight × region mask) → spatial
sum`` for every metric × region.  Each reduction here reads its rows once
and produces every statistic × region in that pass:

    sums[s, r, b] = Σ_l stat_s[b, l] · W[r, l]

with W = area weights × region masks folded on the host
(``make_region_weight_matrix``).  NaN handling supports both reference
semantics: ``skipna=False`` (a NaN inside a region poisons that region's
result, a NaN outside is ignored) and ``skipna=True`` (valid-weighted
means).

Each wrapper picks by the device of its tensors: a CPU tensor goes to the
plain PyTorch version, a CUDA tensor to the hand-written kernel in
``csrc/reductions.cu``, which launches or raises.  The plain versions are
the counterparts of the JAX package's ``*_reference`` functions in IEEE
float32 (TF32 is off, see ``device.py``); the tests and ``chip_smoke.py``
hold the kernels against them.

The CUDA source has four cores (see its header): one cell a step for any
length and alignment; CUDA cores with 16-byte loads (kernel 1 up to four
regions); a TMA streaming core (kernel 2 up to four regions); and a
tensor-core core (``mma.sync``) with an error-corrected TF32 split
(3xTF32) for more regions.  Each call is one device launch: the splits of
the cell axis are summed, and the tensor-core core's non-finite rows
repaired, in the kernel's tail.  ``launch_plan`` picks the core and the
tiling here, in Python, and the C entry points are told the result.
``tf32_split_sums_emulation`` repeats the tensor-core core's arithmetic in
torch for the tests and for ``chip_smoke.py``, which holds that core
against it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from weatherbench2_torch import device as _device  # noqa: F401  (TF32 off)
from weatherbench2_torch.ops import _build

STAT_NAMES = ("bias", "mse", "mae", "acc_num", "acc_fvar", "acc_tvar")
N_STATS = len(STAT_NAMES)
MAX_REGIONS = 16

N_SMS = 132  # H100 SXM; a launch plans for its own card's count

# The cores of csrc/reductions.cu, by the numbers its entry points take.
CORE_SCALAR = 0  # one cell a lane step: any length, any alignment
CORE_VEC4 = 1    # CUDA cores, 16-byte loads, W tiles shared by 8 rows
CORE_MMA = 2     # tensor cores (mma.sync), 3xTF32, cp.async ring
CORE_STREAM = 3  # kernel 2, CUDA cores, TMA bulk copies into an mbarrier ring
CORE_NAMES = {CORE_SCALAR: "scalar", CORE_VEC4: "vec4", CORE_MMA: "mma",
              CORE_STREAM: "stream"}
# The kernels: fused_deterministic_sums with and without a climatology,
# and fused_region_sums (KIND 0, 1, 2 of the CUDA source).
KIND_DET_CLIM, KIND_DET, KIND_REGION = 0, 1, 2
_N_OUT = {KIND_DET_CLIM: 8, KIND_DET: 8, KIND_REGION: 3}

# CUDA-core cores: a block holds eight rows (one a warp).  The scalar core
# fills the card with eight blocks an SM; the vec4 core's registers leave
# three resident (its launch bounds), planned in waves as the streaming
# core is (a block's exit costs its tail's fence and count).
_ROWS_PER_BLOCK = 8
_TARGET_BLOCKS = N_SMS * 8
VEC4_BLOCKS_PER_SM = 3
# Streaming core: eight rows a block (and a producer warp), 48 KB of ring,
# four blocks resident per SM.  It and the vec4 core plan in waves
# (balanced_split_plan): splits of at least 256 cells (a ring segment),
# a block's start counted as 1024 cells.
STREAM_ROWS_PER_BLOCK = 8
STREAM_BLOCKS_PER_SM = 4
_WAVE_MIN_SPLIT = 256
_BLOCK_START_CELLS = 1024
# Tensor-core core: a pipeline stage is 32 cells, and the grid is one
# wave, launched cooperatively (its tail meets at a grid barrier).  A block
# of eight warps holds 64 rows (128 for fused_region_sums, two 8-row tiles
# a warp), two blocks resident per SM.  Splits as short as one stage where
# the rows are few (1024-cell bands): the tail sums them on every SM.
MMA_ROWS_PER_BLOCK = {KIND_DET_CLIM: 64, KIND_DET: 64, KIND_REGION: 128}
MMA_STAGE_CELLS = 32
MMA_BLOCKS_PER_SM = 2
_TC_MIN_SPLIT = MMA_STAGE_CELLS


def make_region_weight_matrix(
    lat_weights: np.ndarray,
    region_masks: Sequence[np.ndarray],
    n_lon: int,
) -> np.ndarray:
  """(R, n_lon*n_lat) float32 matrix of area weights × region masks.

  Args:
    lat_weights: (n_lat,) normalized cell-area weights.
    region_masks: list of (n_lat, n_lon) multiplicative masks.
    n_lon: number of longitudes.
  """
  rows = []
  for mask in region_masks:
    w = lat_weights[None, :] * np.asarray(mask).T  # (n_lon, n_lat)
    if w.shape[0] != n_lon:
      raise ValueError(f"mask has {w.shape[0]} longitudes, not {n_lon}")
    rows.append(w.ravel())
  return np.asarray(rows, dtype=np.float32)


def split_plan(rows: int, cols: int, rows_per_block: int = _ROWS_PER_BLOCK,
               target_blocks: int = _TARGET_BLOCKS,
               min_split: int = 256, one_wave: bool = False,
               step: int = 128) -> tuple[int, int]:
  """(n_splits, split_len) of the cell axis for pass 1.

  Enough splits that the grid fills the card even for few rows (126 at
  0.25 degrees), but no split shorter than ``min_split`` cells: the grid
  reaches ``target_blocks`` (the splits per row block rounded up) or, with
  ``one_wave``, stays within it (rounded down), so that no block waits for
  a second wave.  ``split_len`` is a multiple of ``step``: 128 cells for
  the CUDA-core cores, whose block steps are 128 cells; 32, a pipeline
  stage, for the tensor-core cores.
  """
  row_blocks = -(-rows // rows_per_block)
  per_row_block = (target_blocks // row_blocks if one_wave
                   else -(-target_blocks // row_blocks))
  n_splits = max(1, min(per_row_block, -(-cols // min_split), 65535))
  split_len = -(-cols // n_splits)
  split_len = -(-split_len // step) * step
  return -(-cols // split_len), split_len


def balanced_split_plan(rows: int, cols: int, rows_per_block: int,
                        slots: int, min_split: int,
                        block_start: int) -> tuple[int, int]:
  """(n_splits, split_len) that finish the blocks of ``rows_per_block``
  rows x ``split_len`` cells soonest on ``slots`` resident blocks.

  Blocks of equal work run in waves, so a grid costs its number of waves
  times a block's length, counted as ``split_len + block_start`` cells (a
  block's start, its ring filling, costs about ``block_start`` cells): few
  rows take many splits (one full wave), many rows few (the last wave as
  full as it gets).  No split is shorter than ``min_split`` cells (but
  one); ``split_len`` is a multiple of 128.
  """
  row_blocks = -(-rows // rows_per_block)
  most = max(1, min(65535, cols // min_split))
  best = None
  for n in range(1, most + 1):
    split_len = -(-cols // n)
    split_len = -(-split_len // 128) * 128
    n_splits = -(-cols // split_len)
    cost = -(-row_blocks * n_splits // slots) * (split_len + block_start)
    if best is None or cost < best[0]:
      best = (cost, n_splits, split_len)
  return best[1], best[2]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
  """What a C entry point is told about one launch."""
  core: int
  rows_per_block: int
  n_splits: int
  split_len: int
  partial_shape: tuple[int, int, int, int]  # (n_splits, stats, R, rows)
  out_shape: tuple[int, int, int]           # (stats, R, rows)

  @property
  def grid(self) -> tuple[int, int]:
    """(row blocks, splits).  A tensor-core launch is one wave: where the
    row blocks outnumber the resident blocks it takes fewer blocks, each
    taking several row blocks in turn."""
    return (-(-self.out_shape[2] // self.rows_per_block), self.n_splits)

  @property
  def n_counters(self) -> int:
    """Ints of scratch the tail needs, zeroed before a stream's first
    launch: two for the tensor-core core's grid barrier, then one per row
    (its non-finite flags) or per row block (the CUDA-core cores' arrival
    counters)."""
    tensor = self.core == CORE_MMA
    return 2 + (self.out_shape[2] if tensor else self.grid[0])


def cores_for(kind: int, n_regions: int) -> tuple[int, ...]:
  """The cores that take ``kind`` at ``n_regions`` on 16-byte-aligned
  input with ``cols % 4 == 0`` (the others raise when forced)."""
  few = n_regions <= 4
  if kind == KIND_REGION:
    return (CORE_SCALAR, *((CORE_VEC4, CORE_STREAM) if few else ()),
            CORE_MMA)
  return (CORE_SCALAR, *((CORE_VEC4,) if few else ()), CORE_MMA)


@functools.lru_cache(maxsize=4096)
def launch_plan(kind: int, rows: int, cols: int, n_regions: int,
                aligned: bool = True, core: Optional[int] = None,
                n_sms: int = N_SMS) -> LaunchPlan:
  """Core, tiling and scratch shapes of one kernel launch.

  ``aligned`` says that every array starts on a 16-byte boundary.  The
  16-byte cores also need ``cols % 4 == 0`` (every row then starts
  aligned); anything else takes the one-cell-a-step core.  Up to four
  regions both kernels stay on the CUDA cores (kernel 1 on the 16-byte
  core, kernel 2 on the streaming one); more go to the tensor cores
  (``mma.sync``).  ``core`` forces one (for measurements); forcing a core
  on input it cannot take (a 16-byte core on other input, a CUDA-core
  16-byte core on more than four regions, the streaming core on kernel 1)
  raises.
  ``n_sms`` is the card's number of SMs.
  """
  if not 1 <= n_regions <= MAX_REGIONS:
    raise ValueError(f"{n_regions} regions: the kernel takes "
                     f"1..{MAX_REGIONS}")
  if rows < 1 or cols < 1:
    raise ValueError(f"empty input: {rows} rows, {cols} cells")
  wide = aligned and cols % 4 == 0
  few = n_regions <= 4
  region = kind == KIND_REGION
  if core is None:
    core = (CORE_SCALAR if not wide
            else (CORE_STREAM if region else CORE_VEC4) if few
            else CORE_MMA)
  elif core not in CORE_NAMES:
    raise ValueError(f"unknown core {core}")
  elif core != CORE_SCALAR and not wide:
    raise ValueError("the 16-byte cores need cols % 4 == 0 and 16-byte "
                     "aligned arrays")
  elif core in (CORE_VEC4, CORE_STREAM) and not few:
    raise ValueError(f"the {CORE_NAMES[core]} core takes up to four "
                     "regions")
  elif core == CORE_STREAM and not region:
    raise ValueError("the stream core is built for fused_region_sums")
  if core == CORE_MMA:
    rpb = MMA_ROWS_PER_BLOCK[kind]
    n_splits, split_len = split_plan(rows, cols, rpb,
                                     n_sms * MMA_BLOCKS_PER_SM,
                                     _TC_MIN_SPLIT, one_wave=True,
                                     step=MMA_STAGE_CELLS)
  elif core == CORE_STREAM:
    rpb = STREAM_ROWS_PER_BLOCK
    n_splits, split_len = balanced_split_plan(
        rows, cols, rpb, n_sms * STREAM_BLOCKS_PER_SM, _WAVE_MIN_SPLIT,
        _BLOCK_START_CELLS)
  elif core == CORE_VEC4:
    rpb = _ROWS_PER_BLOCK
    n_splits, split_len = balanced_split_plan(
        rows, cols, rpb, n_sms * VEC4_BLOCKS_PER_SM, _WAVE_MIN_SPLIT,
        _BLOCK_START_CELLS)
  else:
    rpb = _ROWS_PER_BLOCK
    n_splits, split_len = split_plan(rows, cols)
  n_out = _N_OUT[kind]
  return LaunchPlan(core, rpb, n_splits, split_len,
                    (n_splits, n_out, n_regions, rows),
                    (n_out, n_regions, rows))


def _is_aligned(*tensors) -> bool:
  return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _as_f32(x, like=None) -> torch.Tensor:
  dev = like.device if like is not None else None
  return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()


def _det_stats(forecast, truth, clim):
  """The six NaN-masked statistics, the valid mask and the NaN mask, each
  (B, L): the CUDA source's ``stats_of`` in torch, float32 operation for
  operation."""
  nan = torch.isnan(forecast) | torch.isnan(truth)
  if clim is not None:
    nan |= torch.isnan(clim)
  f0 = torch.where(nan, 0.0, forecast)
  t0 = torch.where(nan, 0.0, truth)
  c0 = torch.zeros_like(f0) if clim is None else torch.where(nan, 0.0, clim)
  d, a, c = f0 - t0, f0 - c0, t0 - c0
  return ([d, d * d, d.abs(), a * c, a * a, c * c],
          (~nan).to(forecast.dtype), nan.to(forecast.dtype))


def fused_deterministic_sums_plain(forecast, truth, clim, region_w):
  """Plain PyTorch version of kernel 1 (IEEE float32 matmuls).

  Args:
    forecast, truth: (B, L) float32 tensors; clim: (B, L) or None (zeros).
    region_w: (R, L) float32 weight matrix.

  Returns:
    sums (N_STATS, R, B), wsum_valid (R, B), nan_w (R, B).
  """
  stats, valid, nan = _det_stats(forecast, truth, clim)
  wt = region_w.T
  sums = torch.stack([s @ wt for s in stats]).permute(0, 2, 1)
  wsum = (valid @ wt).T
  nanw = (nan @ (region_w > 0).to(forecast.dtype).T).T
  return sums, wsum, nanw


def fused_deterministic_sums(forecast, truth, clim=None, region_w=None):
  """Fused multi-region weighted sums of the six error statistics.

  Args:
    forecast, truth: (B, L) arrays (batch rows × flattened grid).
    clim: optional (B, L) climatology; ``None`` computes the same function
      as zeros, and the kernel then reads no third array.
    region_w: (R, L) region-weight matrix, R <= 16.

  Returns:
    sums (N_STATS, R, B), wsum_valid (R, B), nan_w (R, B), float32 on the
    inputs' device.
  """
  if region_w is None:
    raise ValueError("region_w is required (build it with "
                     "make_region_weight_matrix)")
  f = _as_f32(forecast)
  t = _as_f32(truth, f)
  c = None if clim is None else _as_f32(clim, f)
  w = _as_f32(region_w, f)
  b, l = f.shape
  r = w.shape[0]
  if t.shape != f.shape or (c is not None and c.shape != f.shape) or (
      w.shape != (r, l)):
    raise ValueError(
        f"shape mismatch: forecast {tuple(f.shape)}, truth {tuple(t.shape)}, "
        f"clim {None if c is None else tuple(c.shape)}, "
        f"region_w {tuple(w.shape)}")
  if f.device.type == "cpu":
    return fused_deterministic_sums_plain(f, t, c, w)
  if f.device.type != "cuda":
    raise ValueError(f"unsupported device {f.device}")
  return launch_deterministic_sums(f, t, c, w)


def launch_deterministic_sums(f, t, c, w, core: Optional[int] = None):
  """Kernel 1 on contiguous float32 CUDA tensors of matching shapes.

  What ``fused_deterministic_sums`` calls once it has checked its
  arguments: one device launch.  ``core`` forces a core, for measurements.
  """
  b, l = f.shape
  kind = KIND_DET if c is None else KIND_DET_CLIM
  plan = launch_plan(kind, b, l, w.shape[0], _is_aligned(f, t, c, w), core,
                     _n_sms(f.device))
  stream = torch.cuda.current_stream(f.device)
  partial, counters, out = _scratch(plan, f.device, stream)
  err = _build.library().wb2_fused_deterministic_sums(
      f.data_ptr(), t.data_ptr(), None if c is None else c.data_ptr(),
      w.data_ptr(), b, l, w.shape[0], plan.core, plan.n_splits,
      plan.split_len,
      None if partial is None else partial.data_ptr(), counters.data_ptr(),
      out.data_ptr(), stream.cuda_stream)
  _build.check(err, "fused_deterministic_sums kernel")
  _count(fused_deterministic_sums, plan.core)
  return out[:N_STATS], out[N_STATS], out[N_STATS + 1]


fused_deterministic_sums.launches = 0
fused_deterministic_sums.launches_by_core = {}


def _count(wrapper, core: int) -> None:
  """One launch of ``wrapper``'s kernel on ``core``."""
  wrapper.launches += 1
  name = CORE_NAMES[core]
  wrapper.launches_by_core[name] = wrapper.launches_by_core.get(name, 0) + 1


@functools.lru_cache(maxsize=None)
def _n_sms(device: torch.device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


# int32 scratch for the kernels' tails, per (device, stream), zeroed when
# made: the kernels leave it ready for the next launch (the grid barrier's
# count of barriers passed keeps growing, in its own slot), so one buffer
# serves every launch on a stream.
_COUNTERS: dict = {}


def _scratch(plan: LaunchPlan, device, stream):
  """(partial or None, counters, out) of one launch."""
  key = (device, stream.cuda_stream)
  counters = _COUNTERS.get(key)
  if counters is None or counters.numel() < plan.n_counters:
    counters = torch.zeros(max(plan.n_counters, 1024), dtype=torch.int32,
                           device=device)
    _COUNTERS[key] = counters
  partial = (torch.empty(plan.partial_shape, dtype=torch.float32,
                         device=device) if plan.n_splits > 1 else None)
  out = torch.empty(plan.out_shape, dtype=torch.float32, device=device)
  return partial, counters, out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
  """float32 rounded to TF32 (10 mantissa bits), nearest with ties away
  from zero: the kernel's ``split_tf32`` (and ``cvt.rna.tf32.f32``)."""
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
  """float32 with the 13 low mantissa bits cleared: what the tensor core
  reads of an operand that was not rounded first (``split_tf32``'s
  ``lo``)."""
  bits = x.contiguous().view(torch.int32)
  return (bits & ~0x1FFF).view(torch.float32)


# What the card's tensor cores were found to do in one
# mma.sync.m16n8k8 (TF32 in, fp32 accumulate): see ``tensor_core_add``.
_MMA_GUARD_BITS = 2
_EMULATION_BLOCK = 4096  # chains emulated at a time (bounds the memory)


def _toward_zero_f32(x: torch.Tensor) -> torch.Tensor:
  """float64 rounded to float32 toward zero."""
  f = x.to(torch.float32)
  over = f.double().abs() > x.abs()
  return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tensor_core_add(acc: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
  """acc + sum_k a[..., k] * b[..., k] as one H100 TF32 MMA step adds it.

  ``acc`` is float32, ``a`` and ``b`` hold TF32 numbers in float32, the
  last axis being the MMA's k = 8.  The model, found by holding it against
  ``pass1_mma`` on an H100 (``chip_smoke.py`` repeats that check, bit for
  bit): the eight products are exact; they and the accumulator are aligned
  to the largest exponent among them, a product's exponent being the sum
  of its factors' exponents (its mantissa product is not normalized
  first); each is truncated toward zero two bits below the float32 unit in
  the last place of that exponent; the sum of those is exact and is then
  truncated toward zero to float32.
  """
  prods = a.double() * b.double()
  _, ea = torch.frexp(a)
  _, eb = torch.frexp(b)
  low = torch.full_like(ea, -200)
  e_prod = torch.where(prods == 0, low, ea + eb - 1).amax(-1)
  _, e_acc = torch.frexp(acc)
  e_acc = torch.where(acc == 0, low[..., 0], e_acc)
  e_max = torch.maximum(e_prod, e_acc)
  quantum = torch.ldexp(torch.ones_like(prods[..., 0]),
                        e_max - 24 - _MMA_GUARD_BITS)
  total = torch.trunc(acc.double() / quantum) + torch.trunc(
      prods / quantum[..., None]).sum(-1)
  return _toward_zero_f32(total * quantum)


def tf32_split_sums_emulation(stat, region_w, split_len: int,
                              terms: int = 3,
                              chain_stages: int = 1) -> torch.Tensor:
  """(R, B) weighted sums of one (B, L) statistic by the tensor-core
  core's arithmetic, on the CPU, bit for bit.

  As in ``pass1_mma``: W and the statistic are split into TF32 ``hi`` and
  ``lo`` (``tf32_round`` of v, ``tf32_truncate`` of v - hi); a stage of 32
  cells is four MMA steps of eight cells (lane ``t`` of four holds cells
  ``16 j + 4 t .. + 3`` and gives the first two to step ``(j, 0)``, the
  others to ``(j, 1)``), each step being the MMAs Wlo.hi, Whi.lo, Whi.hi
  in that order into one accumulator (``tensor_core_add``); a chain is
  ``chain_stages`` stages into a zeroed accumulator; the chains of a split
  are added in order in float32, and so are the splits.  ``terms=1`` is
  Whi.hi alone: plain TF32, which the kernel uses only for operands that
  are TF32 numbers already.  An MMA whose products are all zero changes
  nothing, so the kernel's two MMAs for the valid-weight sum are
  ``terms=3`` of a 0/1 statistic.
  """
  if terms not in (1, 3):
    raise ValueError("terms is 1 (plain TF32) or 3 (3xTF32)")
  if split_len % MMA_STAGE_CELLS:
    raise ValueError(f"split_len {split_len} is not whole stages")
  b, l = stat.shape
  r = region_w.shape[0]
  n_splits = -(-l // split_len)
  chain_cells = MMA_STAGE_CELLS * chain_stages
  chains_per_split = -(-split_len // chain_cells)
  n_chains = n_splits * chains_per_split

  def chunks(x):
    # each split padded on its own to whole chains: (rows, chains, cells)
    out = torch.zeros((x.shape[0], n_splits, chains_per_split * chain_cells),
                      dtype=torch.float32)
    flat = torch.zeros((x.shape[0], n_splits * split_len),
                       dtype=torch.float32)
    flat[:, :l] = x
    out[:, :, :split_len] = flat.view(x.shape[0], n_splits, split_len)
    return out.view(x.shape[0], n_chains, chain_cells)

  s, w = chunks(stat), chunks(region_w)
  steps = [torch.tensor([MMA_STAGE_CELLS * stage + 16 * j + 4 * t + 2 * ks + e
                         for t in range(4) for e in range(2)])
           for stage in range(chain_stages) for j in range(2)
           for ks in range(2)]
  chain = torch.zeros((r, b, n_chains), dtype=torch.float32)
  for c0 in range(0, n_chains, _EMULATION_BLOCK):
    sb, wb = s[:, c0:c0 + _EMULATION_BLOCK], w[:, c0:c0 + _EMULATION_BLOCK]
    s_hi, w_hi = tf32_round(sb), tf32_round(wb)
    pairs = [(w_hi, s_hi)]
    if terms == 3:
      pairs = [(tf32_truncate(wb - w_hi), s_hi),
               (w_hi, tf32_truncate(sb - s_hi)), (w_hi, s_hi)]
    acc = torch.zeros((r, b, sb.shape[1]), dtype=torch.float32)
    for cells in steps:
      for wp, sp in pairs:
        acc = tensor_core_add(acc, wp[:, None, :, cells],
                              sp[None, :, :, cells])
    chain[..., c0:c0 + _EMULATION_BLOCK] = acc
  chain = chain.view(r, b, n_splits, chains_per_split)
  partial = torch.zeros((r, b, n_splits), dtype=torch.float32)
  for i in range(chains_per_split):
    partial += chain[..., i]
  out = torch.zeros((r, b), dtype=torch.float32)
  for i in range(n_splits):
    out += partial[..., i]
  return out


def nonfinite_finish(sums: torch.Tensor, stat: torch.Tensor,
                     region_w: torch.Tensor) -> torch.Tensor:
  """(R, B) ``sums`` of one (B, L) statistic as the tensor-core core
  leaves them after ``nonfinite_fixup``: where the statistic is not finite
  in a row, each region gets what an fp32 matmul gives, NaN where a NaN
  statistic or an infinity meets a zero weight or infinities of both signs
  meet positive weights, else the infinities' sign.  (The core's split
  makes NaN of every region there; every region of such a row is one of
  these, so nothing finite is overwritten.)"""
  bad = ~torch.isfinite(stat)
  if not bool(bad.any()):
    return sums
  positive = (region_w > 0).to(torch.float32).T
  zero = (region_w == 0).to(torch.float32).T

  def meets(cells, weights):  # (R, B): any cell meets a weight
    return (cells.to(torch.float32) @ weights).T > 0

  nan = meets(torch.isnan(stat), positive + zero) | meets(bad, zero)
  pos = meets(torch.isposinf(stat), positive)
  neg = meets(torch.isneginf(stat), positive)
  nan = nan | (pos & neg)
  out = torch.where(pos, torch.inf, torch.where(neg, -torch.inf, sums))
  return torch.where(nan, torch.nan, out)


def fused_deterministic_sums_tf32_emulation(forecast, truth, clim, region_w,
                                            terms: int = 3):
  """Kernel 1 by the tensor-core core's arithmetic, on the CPU: the same
  outputs as ``fused_deterministic_sums_plain``, for the tests and the
  card's check of that core."""
  b, l = forecast.shape
  kind = KIND_DET if clim is None else KIND_DET_CLIM
  plan = launch_plan(kind, b, l, region_w.shape[0], core=CORE_MMA)
  stats, valid, nan = _det_stats(forecast, truth, clim)
  sums = torch.stack([nonfinite_finish(
      tf32_split_sums_emulation(s, region_w, plan.split_len, terms), s,
      region_w) for s in stats])
  wsum = tf32_split_sums_emulation(valid, region_w, plan.split_len, terms)
  nanw = tf32_split_sums_emulation(nan, (region_w > 0).to(torch.float32),
                                   plan.split_len, 1)
  return sums, wsum, nanw


def fused_region_sums_tf32_emulation(x, region_w):
  """Kernel 2 by the tensor-core core's arithmetic, on the CPU."""
  plan = launch_plan(KIND_REGION, x.shape[0], x.shape[1], region_w.shape[0],
                     core=CORE_MMA)
  nan = torch.isnan(x)
  x0 = torch.where(nan, 0.0, x)
  return (nonfinite_finish(tf32_split_sums_emulation(x0, region_w,
                                                     plan.split_len),
                           x0, region_w),
          tf32_split_sums_emulation((~nan).to(x.dtype), region_w,
                                    plan.split_len),
          tf32_split_sums_emulation(nan.to(x.dtype),
                                    (region_w > 0).to(x.dtype),
                                    plan.split_len, 1))


def fused_region_sums_plain(x, region_w):
  """Plain PyTorch version of kernel 2 (IEEE float32 matmuls).

  Returns sums (R, N), wsum_valid (R, N), nan_w (R, N), each row with its
  own NaN accounting.
  """
  nan_mask = torch.isnan(x)
  x0 = torch.where(nan_mask, 0.0, x)
  wt = region_w.T
  sums = (x0 @ wt).T
  wsum = ((~nan_mask).to(x.dtype) @ wt).T
  nanw = (nan_mask.to(x.dtype) @ (region_w > 0).to(x.dtype).T).T
  return sums, wsum, nanw


def fused_region_sums(x, region_w=None):
  """Generic fused multi-region weighted reduction of (N, L) rows.

  One pass over ``x`` computing every region's weighted sum, valid-weight
  sum and NaN-hit weight: the region epilogue of the pointwise tier.

  Returns:
    sums (R, N), wsum_valid (R, N), nan_w (R, N), float32.
  """
  if region_w is None:
    raise ValueError("region_w is required (build it with "
                     "make_region_weight_matrix)")
  x = _as_f32(x)
  w = _as_f32(region_w, x)
  n, l = x.shape
  r = w.shape[0]
  if w.shape != (r, l):
    raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                     f"region_w {tuple(w.shape)}")
  if x.device.type == "cpu":
    return fused_region_sums_plain(x, w)
  if x.device.type != "cuda":
    raise ValueError(f"unsupported device {x.device}")
  return launch_region_sums(x, w)


def launch_region_sums(x, w, core: Optional[int] = None):
  """Kernel 2 on contiguous float32 CUDA tensors of matching shapes.

  What ``fused_region_sums`` calls once it has checked its arguments: one
  device launch.  ``core`` forces a core, for measurements.
  """
  n, l = x.shape
  plan = launch_plan(KIND_REGION, n, l, w.shape[0], _is_aligned(x, w), core,
                     _n_sms(x.device))
  stream = torch.cuda.current_stream(x.device)
  partial, counters, out = _scratch(plan, x.device, stream)
  err = _build.library().wb2_fused_region_sums(
      x.data_ptr(), w.data_ptr(), n, l, w.shape[0], plan.core,
      plan.n_splits, plan.split_len,
      None if partial is None else partial.data_ptr(), counters.data_ptr(),
      out.data_ptr(), stream.cuda_stream)
  _build.check(err, "fused_region_sums kernel")
  _count(fused_region_sums, plan.core)
  return out[0], out[1], out[2]


fused_region_sums.launches = 0
fused_region_sums.launches_by_core = {}


def fused_deterministic_metrics(
    forecast,
    truth,
    clim=None,
    region_w: Optional[np.ndarray] = None,
    skipna: bool = False,
):
  """Latitude-weighted bias/mse/mae (+rmse, +acc with clim) per (R, B).

  Matches metrics._spatial_average semantics for masked regions under
  both skipna modes.
  """
  sums, wsum, nanw = fused_deterministic_sums(forecast, truth, clim,
                                              region_w)
  means = sums / wsum[None]
  if not skipna:
    means = torch.where(nanw[None] > 0, torch.nan, means)
  out = {
      "bias": means[0],
      "mse": means[1],
      "mae": means[2],
      "rmse": torch.sqrt(means[1]),
  }
  if clim is not None:
    out["acc"] = means[3] / torch.sqrt(means[4] * means[5])
  return out

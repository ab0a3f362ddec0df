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
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from weatherbench2_torch import device as _device  # noqa: F401  (TF32 off)
from weatherbench2_torch.ops import _build

STAT_NAMES = ("bias", "mse", "mae", "acc_num", "acc_fvar", "acc_tvar")
N_STATS = len(STAT_NAMES)
MAX_REGIONS = 16

# Pass-1 blocks hold eight rows; the card has 132 SMs and a block of
# eight warps leaves room for eight resident blocks on each.
_ROWS_PER_BLOCK = 8
_TARGET_BLOCKS = 132 * 8


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


def split_plan(rows: int, cols: int) -> tuple[int, int]:
  """(n_splits, split_len) of the cell axis for pass 1.

  Enough splits that the grid fills the card even for few rows (126 at
  0.25 degrees), but every lane keeps at least eight cells per split.
  ``split_len`` is a multiple of 128: a warp step covers 4 cells a lane.
  """
  row_blocks = -(-rows // _ROWS_PER_BLOCK)
  n_splits = max(1, min(-(-_TARGET_BLOCKS // row_blocks), -(-cols // 256),
                        65535))
  split_len = -(-cols // n_splits)
  split_len = -(-split_len // 128) * 128
  return -(-cols // split_len), split_len


def _as_f32(x, like=None) -> torch.Tensor:
  dev = like.device if like is not None else None
  return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()


def fused_deterministic_sums_plain(forecast, truth, clim, region_w):
  """Plain PyTorch version of kernel 1 (IEEE float32 matmuls).

  Args:
    forecast, truth: (B, L) float32 tensors; clim: (B, L) or None (zeros).
    region_w: (R, L) float32 weight matrix.

  Returns:
    sums (N_STATS, R, B), wsum_valid (R, B), nan_w (R, B).
  """
  nan_mask = torch.isnan(forecast) | torch.isnan(truth)
  if clim is not None:
    nan_mask |= torch.isnan(clim)
  valid = (~nan_mask).to(forecast.dtype)
  f0 = torch.where(nan_mask, 0.0, forecast)
  t0 = torch.where(nan_mask, 0.0, truth)
  c0 = torch.zeros_like(f0) if clim is None else torch.where(
      nan_mask, 0.0, clim)
  diff = f0 - t0
  a = f0 - c0
  c = t0 - c0
  wt = region_w.T
  stats = (diff, diff * diff, torch.abs(diff), a * c, a * a, c * c)
  sums = torch.stack([s @ wt for s in stats]).permute(0, 2, 1)
  wsum = (valid @ wt).T
  nanw = (nan_mask.to(forecast.dtype) @ (region_w > 0).to(
      forecast.dtype).T).T
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
  if not 1 <= r <= MAX_REGIONS:
    raise ValueError(f"{r} regions: the kernel takes 1..{MAX_REGIONS}")
  n_splits, split_len = split_plan(b, l)
  partial = torch.empty((n_splits, N_STATS + 2, r, b), dtype=torch.float32,
                        device=f.device)
  out = torch.empty((N_STATS + 2, r, b), dtype=torch.float32,
                    device=f.device)
  lib = _build.library()
  err = lib.wb2_fused_deterministic_sums(
      f.data_ptr(), t.data_ptr(), None if c is None else c.data_ptr(),
      w.data_ptr(), b, l, r, n_splits, split_len, partial.data_ptr(),
      out.data_ptr(), torch.cuda.current_stream(f.device).cuda_stream)
  _build.check(err, "fused_deterministic_sums kernel")
  fused_deterministic_sums.launches += 1
  return out[:N_STATS], out[N_STATS], out[N_STATS + 1]


fused_deterministic_sums.launches = 0


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
  if not 1 <= r <= MAX_REGIONS:
    raise ValueError(f"{r} regions: the kernel takes 1..{MAX_REGIONS}")
  n_splits, split_len = split_plan(n, l)
  partial = torch.empty((n_splits, 3, r, n), dtype=torch.float32,
                        device=x.device)
  out = torch.empty((3, r, n), dtype=torch.float32, device=x.device)
  lib = _build.library()
  err = lib.wb2_fused_region_sums(
      x.data_ptr(), w.data_ptr(), n, l, r, n_splits, split_len,
      partial.data_ptr(), out.data_ptr(),
      torch.cuda.current_stream(x.device).cuda_stream)
  _build.check(err, "fused_region_sums kernel")
  fused_region_sums.launches += 1
  return out[0], out[1], out[2]


fused_region_sums.launches = 0


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

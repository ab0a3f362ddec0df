"""Day-of-year window statistics of a climatology, as torch ops.

Counterpart of ``weatherbench2_tpu/ops/climatology.py``.  The weighted
circular window over day of year is a circulant matrix: with M[d, e] the
weight of source day e in the window of target day d,

    mean[d, p] = sum_e M[d, e] sum_y x[y, e, p] / sum_e M[d, e] sum_y valid

The years are summed first (exact in real arithmetic, and 30 times fewer
multiply-adds than M applied to each year), then one float32 matmul of
(n_days x n_days) by (n_days x pixels) gives each sum (TF32 is off, see
``device.py``).  The standard deviation is the two-moment form on data
centred on a coarse per-pixel mean, for float32 accuracy.  Quantiles
gather each day's wrapped (year, window) pool, sort it once per pencil
(``torch.sort(stable=True)``, as ``jnp.argsort`` is stable: among tied
values the order moves the cumulative weights) and interpolate the
weighted positions.  All of this was XLA's in the JAX package, not Pallas:
these are torch ops, and a hand-written kernel waits until a profile on the
card shows one of them hot.
"""
from __future__ import annotations

import numpy as np
import torch

from weatherbench2_torch import device as _device  # noqa: F401  (TF32 off)

# Bytes a day block of ``device_window_quantile`` may take (its pool and
# the sort's temporaries), by device type.
QUANTILE_BLOCK_BYTES = {"cuda": 8 << 30, "cpu": 1 << 30}


def circulant_window_matrix(window_weights, n_days: int = 366,
                            dtype=np.float32) -> np.ndarray:
  """(n_days, n_days) circulant matrix of wrapped window weights: row d
  holds weight k at column (d + k - half) mod n_days."""
  w = np.asarray(window_weights, dtype=dtype)
  window = len(w)
  half = window // 2
  m = np.zeros((n_days, n_days), dtype=dtype)
  for k in range(window):
    offset = k - half
    idx = (np.arange(n_days) + offset) % n_days
    m[np.arange(n_days), idx] += w[k]
  return m


def _as_f32(values, device=None) -> torch.Tensor:
  return torch.as_tensor(values, dtype=torch.float32, device=device)


def _as_float(values) -> torch.Tensor:
  """float64 values stay float64 (daily means, as the JAX host path
  forms them), anything else becomes float32."""
  x = torch.as_tensor(values)
  return x if x.dtype == torch.float64 else x.to(torch.float32)


def device_rolling_clim(values, window_weights, stat: str = "mean"):
  """Weighted circular-window climatology.

  Args:
    values: (years, n_days, *pixels) tensor (NaN = missing; those cells
      drop out of every sum).
    window_weights: (window,) weights.
    stat: 'mean' or 'std'.

  Returns:
    (n_days, *pixels) tensor on the values' device, float64 for float64
    values, else float32.
  """
  x = _as_float(values)
  n_years, n_days = x.shape[0], x.shape[1]
  pixel_shape = x.shape[2:]
  m = torch.as_tensor(circulant_window_matrix(
      window_weights, n_days,
      np.float64 if x.dtype == torch.float64 else np.float32),
                      device=x.device)
  flat = x.reshape(n_years, n_days, -1)
  nan = torch.isnan(flat)
  valid = (~nan).to(x.dtype)
  x0 = torch.where(nan, 0.0, flat)
  # coarse centre for the float32 accuracy of the variance
  center = x0.sum(dim=(0, 1)) / valid.sum(dim=(0, 1)).clamp(min=1.0)
  xc = torch.where(nan, 0.0, flat - center)
  den = m @ valid.sum(0)
  mean_c = (m @ xc.sum(0)) / den
  if stat == "mean":
    out = mean_c + center
  elif stat == "std":
    var = (m @ (xc * xc).sum(0)) / den - mean_c * mean_c
    out = torch.sqrt(var.clamp(min=0.0))
  else:
    raise NotImplementedError(stat)
  return out.reshape((n_days,) + tuple(pixel_shape))


def sorted_weighted_quantile(values: torch.Tensor, weights: torch.Tensor,
                             quantiles) -> torch.Tensor:
  """(N, Q) weighted, interpolated quantiles of (N, pool) pencils.

  The weighted-percentile estimator of ``utils.weighted_quantile``: sort
  each pencil (zero-weight and NaN entries keyed to +inf, so they go last
  and anchor nothing), take positions p_k = (cumw_k - w_k / 2) / W, and
  interpolate q linearly between the neighbouring positions, clamped to
  the first and last valid entries.  A pencil without weight is NaN.
  Sorted in the values' dtype: the estimator is not continuous in the
  order of nearly equal values of unequal weights, so values the
  reference forms in float64 are sorted in float64.  The cumulative
  weights, the positions and the interpolation weights are float64 (as
  the reference's), whatever the values' dtype, so that a parallel
  cumulative sum on the card places the positions as a serial one does.
  """
  q = torch.as_tensor(np.atleast_1d(quantiles), dtype=torch.float64,
                      device=values.device)
  nan = torch.isnan(values)
  w = torch.where(nan, 0.0, weights)
  key = torch.where(w > 0, values, torch.inf)
  _, order = torch.sort(key, dim=-1, stable=True)
  v_sorted = torch.gather(values, -1, order)
  w_sorted = torch.gather(w, -1, order).to(torch.float64)
  del order, key
  cumw = torch.cumsum(w_sorted, dim=-1)
  positions = (cumw - 0.5 * w_sorted) / cumw[..., -1:]
  n_valid = (w_sorted > 0).sum(-1, keepdim=True)
  n_pool = values.shape[-1]
  qq = q.expand(values.shape[0], -1).contiguous()
  # first position >= q (where none is, the last entry), within the valid
  idx_hi = torch.searchsorted(positions.contiguous(), qq).clamp(max=n_pool - 1)
  idx_hi = torch.minimum(idx_hi, (n_valid - 1).clamp(min=0))
  idx_lo = (idx_hi - 1).clamp(min=0)
  p_hi = torch.gather(positions, -1, idx_hi)
  p_lo = torch.gather(positions, -1, idx_lo)
  v_hi = torch.gather(v_sorted, -1, idx_hi)
  v_lo = torch.gather(v_sorted, -1, idx_lo)
  span = torch.where(p_hi > p_lo, p_hi - p_lo, 1.0)
  frac = ((qq - p_lo) / span).clamp(0.0, 1.0).to(values.dtype)
  out = v_lo + frac * (v_hi - v_lo)
  return torch.where(qq <= positions[..., :1], v_lo, out)


def window_pool_index(n_days: int, window_size: int) -> np.ndarray:
  """(n_days, window) source day of each window position of each day."""
  half = window_size // 2
  return (np.arange(n_days)[:, None]
          + np.arange(-half, window_size - half)) % n_days


def quantile_day_block(n_pixels: int, n_pool: int, element_size: int,
                       device_type: str) -> int:
  """Days of ``device_window_quantile``'s pools that fit one block of
  ``QUANTILE_BLOCK_BYTES[device_type]``: a pool entry takes about eight
  elements (the pool, its sort's keys and values, the sorted weights and
  temporaries) and 16 bytes more (the sort's int64 indices, then the
  float64 cumulative weights and positions)."""
  entry_bytes = 8 * element_size + 16
  return max(1, QUANTILE_BLOCK_BYTES[device_type]
             // max(1, n_pixels * n_pool * entry_bytes))


def device_window_quantile(values, window_size: int, quantiles,
                           window_weights=None):
  """Weighted interpolated quantiles over each day's wrapped (year,
  window) pool.

  The pool is laid out window position by window position in the order of
  their weights, smaller first, each position's years together: one
  stable sort then puts equal values in the order of the JAX package's
  host path, which sorts (value, weight) pairs (among tied values the
  order moves the cumulative weights).  Day blocks take at most
  ``QUANTILE_BLOCK_BYTES`` of the values' device type.

  Args:
    values: (years, n_days, *pixels) tensor.
    window_size: circular window width in days.
    quantiles: sequence of quantiles in [0, 1].
    window_weights: (window,) weights (default: triangular).

  Returns:
    (len(quantiles), n_days, *pixels) tensor, float64 for float64 values,
    else float32.
  """
  x = _as_float(values)
  n_years, n_days = x.shape[0], x.shape[1]
  pixel_shape = tuple(x.shape[2:])
  if window_weights is None:
    from weatherbench2_torch.utils import create_window_weights

    window_weights = create_window_weights(window_size).values
  by_weight = np.argsort(np.asarray(window_weights), kind="stable")
  w_win = torch.as_tensor(np.asarray(window_weights)[by_weight],
                          dtype=x.dtype, device=x.device)
  idx = torch.as_tensor(window_pool_index(n_days, window_size)[:, by_weight],
                        device=x.device)
  flat = x.reshape(n_years, n_days, -1)
  npix = flat.shape[-1]
  n_pool = n_years * window_size
  weights = w_win.repeat_interleave(n_years)
  day_block = min(n_days, quantile_day_block(npix, n_pool, x.element_size(),
                                             x.device.type))
  n_q = len(np.atleast_1d(quantiles))
  out = torch.empty((n_q, n_days, npix), dtype=x.dtype, device=x.device)
  for d0 in range(0, n_days, day_block):
    days = idx[d0:d0 + day_block]  # (B, window)
    b = days.shape[0]
    # (years, B, window, pixels) -> (B, pixels, window x years)
    pool = flat[:, days.reshape(-1)].reshape(n_years, b, window_size, npix)
    pool = pool.permute(1, 3, 2, 0).reshape(b * npix, n_pool)
    res = sorted_weighted_quantile(pool, weights.expand(b * npix, n_pool),
                                   quantiles)
    out[:, d0:d0 + b] = res.reshape(b, npix, n_q).permute(2, 0, 1)
  return out.reshape((n_q, n_days) + pixel_shape)


def window_dry_fraction(is_dry, window_size: int):
  """(n_days, *pixels) share of dry entries over each day's wrapped
  (year, window) pool, every window position counted alike (the zero-weight
  edges too), from a (years, n_days, *pixels) 0/1 tensor."""
  x = _as_f32(is_dry)
  n_years, n_days = x.shape[0], x.shape[1]
  ones = circulant_window_matrix(np.ones(window_size), n_days)
  m = _as_f32(ones, x.device)
  flat = x.reshape(n_years, n_days, -1).sum(0)
  return ((m @ flat) / (n_years * window_size)).reshape(x.shape[1:])


def rolling_window_sums(values, window_weights):
  """(weighted sum, count) over each day's circular window of an
  (n_days, *pixels) tensor, NaN dropped, as ``np.roll`` shifts give them
  (shift i carries weight ``window_weights[i + half]``): the count is of
  valid entries, unweighted, over every window position.  float64 for
  float64 values, else float32."""
  x = _as_float(values)
  n_days = x.shape[0]
  w = np.asarray(window_weights, dtype=np.float64)
  half = len(w) // 2
  m_w = np.zeros((n_days, n_days))
  m_1 = np.zeros((n_days, n_days))
  rows = np.arange(n_days)
  for i in range(-half, len(w) - half):
    # np.roll by i: rolled[d] = values[d - i]
    m_w[rows, (rows - i) % n_days] += w[i + half]
    m_1[rows, (rows - i) % n_days] += 1.0
  flat = x.reshape(n_days, -1)
  nan = torch.isnan(flat)
  acc = torch.as_tensor(m_w, dtype=x.dtype, device=x.device) @ torch.where(
      nan, 0.0, flat)
  count = torch.as_tensor(m_1, dtype=x.dtype, device=x.device) @ (
      ~nan).to(x.dtype)
  return acc.reshape(x.shape), count.reshape(x.shape)

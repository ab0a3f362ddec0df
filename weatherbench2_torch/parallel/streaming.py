"""Streaming evaluation engine, on one device or a mesh of ranks.

Counterpart of ``weatherbench2_tpu/parallel/streaming.py``:

  * the (init_)time axis is processed in chunks; a pool of prefetch
    threads reads, aligns and prepares the next chunks on the host and
    copies them to the card through pinned memory on a side stream while
    the current chunk computes;
  * per chunk, every metric × region of a config runs in the fused tiers
    where it can: MSE/RMSE/MAE/Bias without wind vectors through one
    ``ops.fused_deterministic_sums`` launch per variable; the CRPS family
    and the ensemble mean/variance metrics through the probabilistic plan
    (one member pass of torch ops, then one ``ops.fused_region_sums``
    launch per variable); ACC, SEEPS, MSE/RMSE with wind vectors, the
    Gaussian, threshold and energy scores (any pointwise-fused metric)
    through ``ops.fused_region_sums`` over row groups of their per-cell
    fields; whatever is left (``Spatial*`` metrics, rank histograms,
    configs without regions, a metric that declines) through the
    per-metric × region loop; metrics with ``supports_jit = False`` run on
    the host on numpy chunks;
  * running (sum, count) accumulators stay on the device; at the end the
    temporal means are divided there and, where a config's metrics share
    their variables and coordinates, stacked by metric, so only the means
    cross to the host;
  * by-init truth is deduplicated to the chunk's unique valid times on the
    host and expanded on the device with one gather;
  * ``lead_time`` input chunks stream the lead axis slice by slice, each
    slice with accumulators of its own, and the results are concatenated;
  * derived variables are computed on the device, after the base variables
    crossed; the probabilistic climatology's members cross once per
    distinct (day of year, hour) of a chunk and are expanded on the device;
  * ``StreamingState`` snapshots the accumulators every ``checkpoint_every``
    chunks (one background thread, a side stream, ``os.replace``), and an
    existing state resumes the run;
  * with a ``parallel.mesh.Mesh`` every rank runs this engine on its share
    (``_RankShare``): its rows of every chunk on the ``batch`` axis, its
    latitude band on the ``spatial`` axis; the region kernels' band sums
    are all-reduced over the spatial axis before any division, and each
    chunk's (sum, count) leaves over the batch axis (one packed
    ``all_reduce``) before they join the accumulators;
  * ``WB2_TRANSFER_DTYPE=bfloat16`` moves large float payloads as bfloat16
    and widens them to float32 on the device (``xds.to_device``); the base
    fields of derived variables cross at full precision and are rounded on
    the device after the derivation (``xds.round_to_bfloat16``).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import os
import pickle
import time
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import evaluation
from weatherbench2_torch import metrics as metrics_lib
from weatherbench2_torch import ops
from weatherbench2_torch import tracing
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.parallel.mesh import BATCH, SPATIAL
from weatherbench2_torch.xds import _xp
from weatherbench2_torch.xds import io_zarr

# Chunks prepared ahead of the one computing (each aligned by its own host
# thread, its large payloads read, pinned and copied by whichever threads
# of the pool are free; the engine is host-bound, and 4 threads beat 2 on
# the 8-core host of an H100 machine), and chunks whose device work may be
# queued before the host waits.  Device memory holds about PREFETCH_DEPTH +
# DEVICE_INFLIGHT chunks.
PREFETCH_DEPTH = 4
DEVICE_INFLIGHT = 2
# Unique valid times per chunk are padded up to a multiple of this.
UTIME_BUCKET = 16
# Forecast bytes per chunk when the caller names no chunk size.
DEFAULT_CHUNK_BYTES = 1.5e9
# Leaves up to this size cross device-to-host packed into one buffer per
# dtype; larger ones (the per-cell accumulators of Spatial* metrics) are
# copied one by one, so that no second copy of them is made on the device.
PACKED_LEAF_BYTES = 1 << 20
# A large leaf on a CUDA device crosses in blocks of this size through two
# pinned buffers (``_to_host``).
D2H_BLOCK_BYTES = 64 << 20

_UTIME = "__utime"


def _map_labeled(tree, fn):
  """``tree`` (dicts, lists and tuples of anything) with each Dataset and
  DataArray in it replaced by ``fn`` of it."""
  if isinstance(tree, (xds.Dataset, xds.DataArray)):
    return fn(tree)
  if isinstance(tree, dict):
    return {k: _map_labeled(v, fn) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map_labeled(v, fn) for v in tree)
  return tree


def _normalize_chunk_coords(ds, chunk_dim: str):
  """A Dataset or DataArray with its chunk-dim coords replaced by
  placeholders (the real labels come back from the forecast when per-time
  results are assembled)."""
  if isinstance(ds, xds.DataArray):
    name = ds.name or "__da__"
    return _normalize_chunk_coords(ds.to_dataset(name=name), chunk_dim)[name]
  coords = {}
  n = ds.sizes.get(chunk_dim)
  for name, cv in ds.coords_dict().items():
    if chunk_dim in cv.dims:
      if name == chunk_dim and cv.ndim == 1:
        coords[name] = xds.Variable((chunk_dim,), np.arange(n))
    else:
      coords[name] = cv
  return xds.Dataset(dict(ds.variables_dict()), coords=coords,
                     attrs=ds.attrs)


def _reorder_like(ref, obj):
  """Rebuild ``obj`` with ``ref``'s Dataset variable ordering.

  Aligns a resumed state's accumulators to this run's chunk program, so
  that the results keep this run's variable order whatever order the
  state was saved in.  Dicts, tuples and lists recurse; a key of ``obj``
  that ``ref`` lacks, and anything else, passes through untouched.
  """
  if isinstance(ref, dict) and isinstance(obj, dict):
    return {k: _reorder_like(ref[k], obj[k]) if k in ref else obj[k]
            for k in obj}
  if isinstance(ref, (list, tuple)) and isinstance(obj, (list, tuple)):
    if len(ref) == len(obj):
      return type(obj)(_reorder_like(r, o) for r, o in zip(ref, obj))
    return obj
  if isinstance(ref, xds.Dataset) and isinstance(obj, xds.Dataset):
    ref_names = list(ref.variables_dict())
    obj_vars = obj.variables_dict()
    if set(ref_names) == set(obj_vars) and ref_names != list(obj_vars):
      return xds.Dataset({n: obj_vars[n] for n in ref_names},
                         coords=dict(obj.coords_dict()), attrs=obj.attrs)
  return obj


def _leaves(tree, out):
  """Tensor payloads of a tree of xds objects, dicts and sequences."""
  if isinstance(tree, dict):
    for v in tree.values():
      _leaves(v, out)
  elif isinstance(tree, (list, tuple)):
    for v in tree:
      _leaves(v, out)
  elif isinstance(tree, xds.Dataset):
    for v in tree.variables_dict().values():
      _leaves(v.data, out)
  elif isinstance(tree, (xds.DataArray, xds.Variable)):
    _leaves(tree.data, out)
  elif isinstance(tree, torch.Tensor):
    out.append(tree)
  return out


def _replace_leaves(tree, fn):
  """The tree with ``fn`` applied to every array payload."""
  if isinstance(tree, dict):
    return {k: _replace_leaves(v, fn) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_replace_leaves(v, fn) for v in tree)
  if isinstance(tree, xds.Dataset):
    return tree.copy(data={k: fn(v.data)
                           for k, v in tree.variables_dict().items()})
  if isinstance(tree, xds.DataArray):
    return tree.copy(data=fn(tree.data))
  if isinstance(tree, torch.Tensor):
    return fn(tree)
  return tree


def _to_host(t: torch.Tensor) -> np.ndarray:
  """A tensor as a new host array.  From a CUDA device it crosses in
  blocks through two pinned buffers: while a block crosses, the CPU's
  threads copy the one before into the array, faulting its fresh pages in
  together (a pageable ``.cpu()`` faults them on one thread, at about half
  the rate on an H100's host)."""
  if t.device.type != "cuda":
    return t.cpu().numpy()
  src = t.contiguous().view(-1)
  # numpy allocates the array (with huge pages where the host offers them)
  host = np.empty(tuple(t.shape), torch.empty(0, dtype=t.dtype).numpy().dtype)
  out = torch.from_numpy(host).view(-1)
  step = max(1, D2H_BLOCK_BYTES // t.element_size())
  starts = range(0, src.numel(), step)
  with torch.cuda.device(t.device):
    bufs = [torch.empty(min(step, src.numel()), dtype=t.dtype,
                        pin_memory=True) for _ in range(2)]
    crossed = [torch.cuda.Event(), torch.cuda.Event()]
    for i in range(len(starts) + 1):
      if i < len(starts):
        # block i crosses; its buffer's last block was copied out before
        lo = starts[i]
        n = min(step, src.numel() - lo)
        bufs[i % 2][:n].copy_(src[lo:lo + n], non_blocking=True)
        crossed[i % 2].record()
      if i:
        # while it crosses, block i - 1 is copied out
        lo = starts[i - 1]
        n = min(step, src.numel() - lo)
        crossed[(i - 1) % 2].synchronize()
        out[lo:lo + n].copy_(bufs[(i - 1) % 2][:n])
  return host


def batched_device_get(tree):
  """The tree with every tensor payload as numpy: the small leaves in ONE
  device-to-host copy per dtype (the accumulators hold hundreds of tiny
  leaves), the large ones each in a copy of its own (``_to_host``)."""
  host = {}
  by_dtype: dict = {}
  for t in _leaves(tree, []):
    if t.numel() * t.element_size() > PACKED_LEAF_BYTES:
      host[id(t)] = _to_host(t)
    else:
      by_dtype.setdefault(t.dtype, []).append(t)
  for group in by_dtype.values():
    flat = torch.cat([t.reshape(-1) for t in group]).cpu().numpy()
    off = 0
    for t in group:
      host[id(t)] = flat[off:off + t.numel()].reshape(tuple(t.shape))
      off += t.numel()
  return _replace_leaves(tree, lambda t: host.get(id(t), t))


def _tree_to_device(tree, dev):
  """A state's numpy accumulators as tensors on the device."""
  return _replace_leaves(
      tree, lambda x: torch.as_tensor(
          x if isinstance(x, torch.Tensor) else np.asarray(x), device=dev))


def _tree_add(a, b):
  """Elementwise a + b over matching trees of Datasets (None passes).
  The sums are new arrays: a snapshot may still be reading the old ones."""
  if a is None:
    return None
  if isinstance(a, dict):
    return {k: _tree_add(a[k], b[k]) for k in a}
  return a.copy(data={k: _xp.binop(lambda x, y: x + y, v.data,
                                   b.variables_dict()[k].data)
                      for k, v in a.variables_dict().items()})


@dataclasses.dataclass
class StreamingState:
  """Checkpointable accumulator state of a streaming evaluation.

  ``chunk_size``/``total`` fingerprint the chunking the state was taken
  under: ``chunk_index`` counts CHUNKS, so resuming with another chunk
  size would skip the wrong time range.  ``configs`` maps eval-config name
  to (sums, counts), so that a grouped stream snapshots every config's
  accumulators together.  ``lead_index``/``n_lead_slices``/
  ``completed_leads`` cover lead_time-chunked runs: the finalized results
  of completed lead slices ride whole (host datasets), the slice in
  flight resumes from its accumulators.  ``sums``/``counts`` are the
  single-config fields of version-1 files, which still load and resume.

  The file is a pickle of the port's labeled objects with numpy payloads.
  """

  sums: Any = None
  counts: Any = None
  chunk_index: int = 0
  chunk_size: Optional[int] = None
  total: Optional[int] = None
  configs: Any = None  # {cname: (sums, counts)}
  lead_index: int = 0
  n_lead_slices: Optional[int] = None
  completed_leads: Any = None  # [{cname: results Dataset}, ...]

  def save(self, path: str) -> None:
    host = batched_device_get((self.sums, self.counts, self.configs))
    fields = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self)}
    fields.update(sums=host[0], counts=host[1], configs=host[2])
    with open(path, "wb") as f:
      pickle.dump({"version": 2, **fields}, f)

  @classmethod
  def load(cls, path: str) -> "StreamingState":
    """The state of a file; a field the file lacks (one of an older
    version) keeps its default."""
    with open(path, "rb") as f:
      d = pickle.load(f)
    return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                  if f.name in d})


def _region_weight_setup(regions, forecast):
  """(region_names, region_w) for the fused kernels, or None when the
  regions or grid do not map to static (latitude, longitude) masks."""
  if None in regions:
    return None
  coords = forecast.coords_dict()
  if "latitude" not in coords or "longitude" not in coords:
    return None
  for v in forecast.variables_dict().values():
    if "latitude" not in v.dims or "longitude" not in v.dims:
      return None
  lat = np.asarray(coords["latitude"].data)
  lon = np.asarray(coords["longitude"].data)
  w = metrics_lib._cell_area_from_latitude(np.deg2rad(lat))
  w = (w / w.mean()).astype(np.float32)
  try:
    masks = [r.mask_weights(lat, lon) for r in regions.values()]
  except (NotImplementedError, KeyError, ValueError):
    return None
  region_w = ops.make_region_weight_matrix(w, masks, len(lon))
  return np.asarray(list(regions.keys()), dtype=object), region_w


def _det_stat_of(metric):
  """Stat name in the fused deterministic kernel, or None.

  MSE and RMSE with wind vectors are NOT kernel-1 metrics: their
  wind-vector fields are sums of two variables' squared errors, which
  ride the pointwise tier.  ACC is deliberately not routed here either:
  the kernel shares one NaN mask (isnan(f)|isnan(t)|isnan(clim)) across
  all stats, which would let climatology NaNs poison MSE/Bias/MAE and
  allows one climatology per plan; in the pointwise tier each of its three
  anomaly products carries its own per-cell NaN accounting.
  """
  if type(metric) is metrics_lib.MSE and not metric.wind_vector_mse:
    return "mse"
  if type(metric) is metrics_lib.Bias:
    return "bias"
  if type(metric) is metrics_lib.MAE:
    return "mae"
  if type(metric) is metrics_lib.RMSESqrtBeforeTimeAvg and (
      not metric.wind_vector_rmse):
    return "rmse"
  return None


# the per-cell fields of the member pass that each probabilistic statistic
# needs: spread (single-sort PWM), skill, squared ensemble-mean error,
# ddof=1 ensemble variance and the debiased per-cell field
_PROB_FIELD_DEPS = {
    "crps": ("skill", "spread"),
    "spread": ("spread",),
    "skill": ("skill",),
    "meansq": ("meansq",),
    "debiased": ("meansq", "var", "debiased"),
    "var": ("var",),
    "rmse_mean": ("meansq",),
    "stddev": ("var",),
}


def _prob_stat_of(metric):
  """Stat name in the probabilistic plan, or None.  The type is matched
  exactly, as in the JAX package: a subclass may compute something else."""
  return {
      metrics_lib.CRPS: "crps",
      metrics_lib.CRPSSpread: "spread",
      metrics_lib.CRPSSkill: "skill",
      metrics_lib.EnsembleMeanMSE: "meansq",
      metrics_lib.DebiasedEnsembleMeanMSE: "debiased",
      metrics_lib.EnsembleVariance: "var",
      metrics_lib.EnsembleMeanRMSESqrtBeforeTimeAvg: "rmse_mean",
      metrics_lib.EnsembleStddevSqrtBeforeTimeAvg: "stddev",
  }.get(type(metric))


def _partition_fused(metrics, regions, forecast):
  """(det_plan, prob_plan, pointwise_plan, remaining) covering a config's
  metrics, in the JAX package's order of tiers.

  The deterministic kernel takes MSE/RMSE/MAE/Bias without wind vectors;
  the probabilistic plan the CRPS family and the ensemble mean/variance
  metrics, when they share one member dim of two members or more (one
  member gives each metric its own degenerate answer); metrics implementing
  the pointwise-fused protocol go to the generic region kernel;
  ``remaining`` ({name: metric}) runs the per-metric × region loop.
  Without static region masks (no regions, a variable off the grid) every
  plan is None and every metric remains.
  """
  remaining = dict(metrics)
  setup = _region_weight_setup(regions, forecast)
  if setup is None:
    return None, None, None, remaining
  region_names, region_w = setup
  base = {"region_names": region_names, "region_w": region_w}
  det = {n: _det_stat_of(m) for n, m in metrics.items() if _det_stat_of(m)}
  prob = {n: _prob_stat_of(m) for n, m in metrics.items()
          if n not in det and _prob_stat_of(m)}
  ens_dims = {metrics[n].ensemble_dim for n in prob}
  if len(ens_dims) != 1 or forecast.sizes.get(next(iter(ens_dims)), 0) < 2:
    prob = {}
  pointwise = [n for n, m in metrics.items()
               if n not in det and n not in prob and m.supports_pointwise_fused]
  for n in list(det) + list(prob) + pointwise:
    remaining.pop(n)
  det_plan = {**base, "stat_of": det} if det else None
  prob_plan = None
  if prob:
    prob_plan = {**base, "stat_of": prob, "ensemble_dim": ens_dims.pop(),
                 "fields": sorted({f for stat in prob.values()
                                   for f in _PROB_FIELD_DEPS[stat]})}
  pw_plan = {**base, "names": pointwise} if pointwise else None
  return det_plan, prob_plan, pw_plan, remaining


def _region_rows(f_c, t_c, v, ens=None):
  """Variable ``v`` of a forecast and a truth chunk broadcast together as
  rows of cells, the spatial dims last in (longitude, latitude) order to
  match the weight matrix: (the forecast's (rows, cells), under its member
  dim ``ens`` where given; the truth's (rows, cells); the dims of the
  rows; their shape; the forecast's coordinates along them)."""
  fvar, tvar = f_c.variables_dict()[v], t_c.variables_dict()[v]
  other = tuple(d for d in xds.broadcast_dims_order(
      tuple(d for d in fvar.dims if d != ens), tvar.dims)
                if d not in ("longitude", "latitude"))
  all_dims = other + ("longitude", "latitude")
  members = (ens,) if ens is not None else ()
  sizes = {**tvar.sizes, **fvar.sizes}
  f_b = fvar.broadcast_to_dims(members + all_dims, sizes).data
  t_b = tvar.broadcast_to_dims(all_dims, sizes).data
  shape = tuple(t_b.shape[:-2])
  b = int(np.prod(shape)) if shape else 1
  l = t_b.shape[-2] * t_b.shape[-1]
  coords = {k: cv for k, cv in f_c.coords_dict().items()
            if set(cv.dims) <= set(other)}
  return (f_b.reshape(f_b.shape[:len(members)] + (b, l)), t_b.reshape(b, l),
          other, shape, coords)


def _fused_chunk_results(plan, f_c, t_c, skipna):
  """Per-time MSE/RMSE/MAE/Bias values of every region, dims (region, ...).

  The plan carries no climatology (ACC is in the pointwise tier), so the
  kernel computes the climatology statistics against zeros and reads only
  forecast and truth.
  """
  stat_idx = {"bias": 0, "mse": 1, "mae": 2}
  region_w = plan["region_w_dev"]
  band_sum = plan.get("band_sum", _as_is)
  n_regions = region_w.shape[0]
  region_coord = xds.Variable(("region",), plan["region_names"])
  results = {name: xds.Dataset({}, coords={"region": region_coord})
             for name in plan["stat_of"]}
  # score the variables common to forecast and truth (xds binop rule)
  for v in f_c.keys():
    if v not in t_c.keys():
      continue
    f_rows, t_rows, other, other_shape, coords = _region_rows(f_c, t_c, v)
    b = f_rows.shape[0]
    if v in plan.get("infinite", ()):
      # the error's rows through kernel 2, which keeps each inf cell to the
      # regions that hold it
      d = (f_rows - t_rows).to(torch.float32)
      sums, wsum, nanw = _inf_safe_region_sums(
          torch.cat([d, d * d, d.abs()]), region_w, band_sum)
      sums = sums.reshape(n_regions, 3, b).permute(1, 0, 2)
      wsum, nanw = wsum[:, :b], nanw[:, :b]
    else:
      sums, wsum, nanw = band_sum(ops.fused_deterministic_sums(
          f_rows, t_rows, None, region_w))
    means = sums / wsum[None]
    if not skipna:
      means = torch.where(nanw[None] > 0, torch.nan, means)
    coords["region"] = region_coord
    for name, stat in plan["stat_of"].items():
      arr = (torch.sqrt(means[stat_idx["mse"]]) if stat == "rmse"
             else means[stat_idx[stat]])
      results[name][v] = xds.DataArray(
          xds.Variable(("region",) + other,
                       arr.reshape((n_regions,) + other_shape)),
          coords=coords, name=v)
  return results


def member_fields(f3, t2, fields, skipna):
  """The probabilistic plan's member pass: {field: (B, L)} of ``fields``.

  ``f3`` holds the members (M, B, L), ``t2`` the truth (B, L).  Under
  ``skipna`` the means run over each cell's valid members (xarray's
  NaN-skipping member means) while the PWM coefficients and the debiased
  correction keep the global M, as in ``metrics``; without it member NaNs
  propagate as the generic path's means do.
  """
  m = f3.shape[0]
  out = {}
  if skipna:
    valid = ~torch.isnan(f3)
    count = valid.sum(dim=0).to(f3.dtype)
  if "spread" in fields:
    out["spread"] = metrics_lib.pwm_spread(f3, 0, skipna)
  if "skill" in fields:
    ad = torch.abs(f3 - t2)
    out["skill"] = (torch.where(valid, ad, 0.0).sum(dim=0) / count if skipna
                    else ad.mean(dim=0))
  if "meansq" in fields or "var" in fields:
    xbar = (torch.where(valid, f3, 0.0).sum(dim=0) / count if skipna
            else f3.mean(dim=0))
    if "meansq" in fields:
      out["meansq"] = (xbar - t2) ** 2
    if "var" in fields:
      sq = (f3 - xbar) ** 2
      out["var"] = (torch.where(valid, sq, 0.0).sum(dim=0) / (count - 1)
                    if skipna else sq.sum(dim=0) / (m - 1))
    if "debiased" in fields:
      # per CELL: the regional means of meansq and var would average the
      # two terms over different NaN cells under skipna
      out["debiased"] = out["meansq"] - out["var"] / m
  return out


_PROB_RESULT = {
    "crps": lambda f: f["skill"] - 0.5 * f["spread"],
    "rmse_mean": lambda f: torch.sqrt(f["meansq"]),
    "stddev": lambda f: torch.sqrt(f["var"]),
}


def _fused_prob_chunk_results(plan, f_c, t_c, skipna):
  """Per-time probabilistic metric values, dims (region, ...): for each
  variable one member pass, its K fields stacked into one (K·B, L) matrix
  and one ``ops.fused_region_sums`` launch."""
  ens = plan["ensemble_dim"]
  field_names = plan["fields"]
  region_w = plan["region_w_dev"]
  n_regions = region_w.shape[0]
  region_coord = xds.Variable(("region",), plan["region_names"])
  results = {name: xds.Dataset({}, coords={"region": region_coord})
             for name in plan["stat_of"]}
  for v in t_c.keys():
    if v not in f_c.keys():
      continue  # score the common variables only (xds binop rule)
    f_rows, t_rows, other, other_shape, coords = _region_rows(f_c, t_c, v,
                                                              ens)
    fields = member_fields(f_rows, t_rows, field_names, skipna)
    stack = torch.stack([fields[k] for k in field_names])
    sums, wsum, nanw = _region_reducer(plan, [v])(
        stack.reshape(len(field_names) * t_rows.shape[0], -1), region_w)
    means = sums / wsum
    if not skipna:
      means = torch.where(nanw > 0, torch.nan, means)
    means = means.reshape(n_regions, len(field_names), t_rows.shape[0])
    mean_of = {name: means[:, i].reshape((n_regions,) + other_shape)
               for i, name in enumerate(field_names)}
    coords["region"] = region_coord
    for name, stat in plan["stat_of"].items():
      arr = _PROB_RESULT.get(stat, lambda f, s=stat: f[s])(mean_of)
      results[name][v] = xds.DataArray(
          xds.Variable(("region",) + other, arr), coords=coords, name=v)
  return results


def _as_is(outs):
  """A kernel's outputs on a rank that holds the whole grid."""
  return outs


def _inf_safe_region_sums(x, region_w, band_sum=_as_is):
  """Kernel 2's (sums, wsum_valid, nan_w) of rows that may hold ±inf.

  The tensor-core core takes finite numbers only, and a zero region weight
  times inf would be NaN in any weighted sum, poisoning the regions
  without the cell.  The inf cells go in as 0 with two indicator rows
  (+inf, -inf) riding the same launch; a region whose positive weights
  meet +inf cells sums to +inf, -inf cells to -inf, both to NaN, as a
  reduction over the region's own cells gives (the generic per-region
  loop, the JAX package's in-memory engine).  ``band_sum`` adds a latitude
  band's outputs over the spatial axis before the indicators are read.
  """
  x = x.to(torch.float32)
  n = x.shape[0]
  pos, neg = torch.isposinf(x), torch.isneginf(x)
  sums, wsum, nanw = band_sum(ops.fused_region_sums(
      torch.cat([torch.where(pos | neg, 0.0, x), pos.to(x.dtype),
                 neg.to(x.dtype)]), region_w))
  s, p, q = sums[:, :n], sums[:, n:2 * n] > 0, sums[:, 2 * n:] > 0
  s = torch.where(p & q, torch.nan,
                  torch.where(p, torch.inf, torch.where(q, -torch.inf, s)))
  return s, wsum[:, :n], nanw[:, :n]


def _region_reducer(plan, variables):
  """Kernel 2, or its inf-safe form for the rows of a variable that may be
  ±inf by design (the geostrophic winds on the equator); on a latitude
  band, its outputs added over the spatial axis."""
  band_sum = plan.get("band_sum", _as_is)
  if set(variables) & set(plan.get("infinite", ())):
    return lambda x, w: _inf_safe_region_sums(x, w, band_sum)
  return lambda x, w: band_sum(ops.fused_region_sums(x, w))


def fused_group_bytes() -> int:
  """Row bytes per ``fused_region_sums`` launch of the pointwise tier.

  ``WB2_FUSED_GROUP_BYTES`` overrides the 1 GiB default, as in the JAX
  package: the rows of one launch are one concatenated device matrix.
  """
  return int(os.environ.get("WB2_FUSED_GROUP_BYTES", 1 << 30))


def _pointwise_chunk_results(plan, metrics, f_c, t_c, prepared, skipna):
  """Every pointwise-fused metric of a config through the region kernel.

  Each metric's per-cell fields become rows of one (rows, cells) matrix,
  packed greedily into groups of at most ``fused_group_bytes()``; each
  group is one kernel launch, and the per-group outputs re-join along the
  row axis.  The regional mean is ``sums / wsum_valid``; where the
  metric's ``fused_nan_mode`` is "global" and ``skipna`` is off, a row
  that met a NaN under a positive weight is NaN.

  Returns (results by metric, leftover names): a metric whose
  ``pointwise_chunk`` declines (a variable is missing, a field is off the
  grid) goes to the caller's per-region loop.
  """
  region_w = plan["region_w_dev"]
  n_regions = region_w.shape[0]
  region_coord = xds.Variable(("region",), plan["region_names"])
  group_cap = fused_group_bytes()
  results, leftover = {}, []
  for mname in plan["names"]:
    metric = metrics[mname]
    fields = metric.pointwise_chunk(f_c, t_c, prepared[mname], skipna)
    if fields is None or not len(fields) or any(
        "latitude" not in v.dims or "longitude" not in v.dims
        for v in fields.variables_dict().values()):
      leftover.append(mname)
      continue
    rows, entries = [], []
    reduce = _region_reducer(plan, fields.keys())
    for vname, v in fields.variables_dict().items():
      other = tuple(d for d in v.dims if d not in ("longitude", "latitude"))
      vv = v.transpose(*(other + ("longitude", "latitude")))
      other_shape = tuple(vv.shape[:-2])
      b = int(np.prod(other_shape)) if other_shape else 1
      rows.append(vv.data.to(torch.float32).reshape(
          b, vv.shape[-2] * vv.shape[-1]))
      coords = {k: cv for k, cv in fields.coords_dict().items()
                if cv.dims and set(cv.dims) <= set(other)}
      entries.append((vname, other, other_shape, coords, b))
    groups, cur, cur_bytes = [], [], 0
    for r in rows:
      rb = 4 * r.shape[0] * r.shape[1]
      if cur and cur_bytes + rb > group_cap:
        groups.append(cur)
        cur, cur_bytes = [], 0
      cur.append(r)
      cur_bytes += rb
    groups.append(cur)
    parts = [reduce(
        g[0] if len(g) == 1 else _xp.namespace(*g).concatenate(g, axis=0),
        region_w) for g in groups]
    sums, wsum, nanw = (torch.cat([p[i] for p in parts], dim=-1)
                        for i in range(3))
    means_all = sums / wsum
    if metric.fused_nan_mode == "global" and not skipna:
      means_all = torch.where(nanw > 0, torch.nan, means_all)
    ds = xds.Dataset({}, coords={"region": region_coord})
    col = 0
    for vname, other, other_shape, coords, b in entries:
      arr = means_all[:, col:col + b].reshape((n_regions,) + other_shape)
      col += b
      ds[vname] = xds.DataArray(
          xds.Variable(("region",) + other, arr),
          coords={"region": region_coord, **coords}, name=vname)
    result = metric.finalize_fused(ds, skipna=skipna)
    if fields.attrs:
      result = result.assign_attrs(**fields.attrs)
    results[mname] = result
  return results, leftover


class _LoopTimer:
  """Seconds of the timed blocks (the per-metric loop of each chunk and
  config), each added to the ``generic_s`` of the record it was timed for:
  on a CUDA device the compute stream's time between two events recorded
  around the block's launches, read once the stream has run them; on the
  host the block's wall."""

  def __init__(self, dev):
    self._stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                    else None)
    # per block: (record, start event or None, end event or seconds)
    self.marks: list = []

  @contextlib.contextmanager
  def time(self, rec: dict):
    if self._stream is None:
      t0 = time.perf_counter()
      yield
      self.marks.append((rec, None, time.perf_counter() - t0))
      return
    start = torch.cuda.Event(enable_timing=True)
    start.record(self._stream)
    yield
    end = torch.cuda.Event(enable_timing=True)
    end.record(self._stream)
    self.marks.append((rec, start, end))

  def settle(self) -> float:
    """Add each block's seconds to its record, waiting for the device where
    it has not run them yet; the seconds of them all."""
    total = 0
    for rec, start, end in self.marks:
      if start is not None:
        end.synchronize()
        end = start.elapsed_time(end) / 1e3
      rec["generic_s"] += end
      total += end
    return total


def _masked_sum_count(result, dim, mask, skipna):
  """(sum, count) of a per-time result over the chunk dim, padded entries
  masked out; sums accumulate in float64."""
  sum_ds = xds.Dataset({}, coords={
      k: v for k, v in result.coords_dict().items() if dim not in v.dims})
  cnt_ds = xds.Dataset({}, coords=dict(sum_ds.coords_dict()))
  for vname in result.keys():
    da = result[vname]
    if dim not in da.dims:
      # no time dependence: one sample
      vals = _xp.TORCH.asarray(da.data, mask).to(torch.float64)
      sum_ds[vname] = xds.Variable(da.dims, vals)
      cnt_ds[vname] = xds.Variable(da.dims, torch.ones_like(vals))
      continue
    ax = da.dims.index(dim)
    m_shape = [1] * da.ndim
    m_shape[ax] = da.shape[ax]
    m = mask.reshape(m_shape)
    vals = da.data.to(torch.float64)
    if skipna:
      valid = (m > 0) & ~torch.isnan(vals)
      s = torch.where(valid, vals, 0.0).sum(dim=ax)
      c = valid.to(torch.float64).sum(dim=ax)
    else:
      s = torch.where(m > 0, vals, 0.0).sum(dim=ax)
      c = m.expand(vals.shape).sum(dim=ax)
    dims = tuple(d for d in da.dims if d != dim)
    sum_ds[vname] = xds.Variable(dims, s)
    cnt_ds[vname] = xds.Variable(dims, c)
  return sum_ds, cnt_ds


def _finalize_mean(sum_ds: xds.Dataset, count_ds: xds.Dataset) -> xds.Dataset:
  """A metric's temporal means, ``where(count > 0, sum / max(count, 1),
  NaN)`` in float64, as tensors where the sums are (host sums on the CPU):
  IEEE division is correctly rounded on the card as on the host."""
  out = xds.Dataset({}, coords=dict(sum_ds.coords_dict()))
  counts = count_ds.variables_dict()
  for k, v in sum_ds.variables_dict().items():
    s = torch.as_tensor(v.data, dtype=torch.float64)
    c = torch.as_tensor(counts[k].data, dtype=torch.float64, device=s.device)
    out[k] = xds.Variable(v.dims,
                          torch.where(c > 0, s / c.clamp(min=1), torch.nan))
  return out


def _same_layout(a: xds.Dataset, b: xds.Dataset) -> bool:
  """Whether ``a`` and ``b`` hold the same variables (dims and shapes)
  and the same coordinates (dims, dtype and values)."""
  av, bv = a.variables_dict(), b.variables_dict()
  ac, bc = a.coords_dict(), b.coords_dict()
  if av.keys() != bv.keys() or ac.keys() != bc.keys():
    return False
  if any(v.dims != bv[k].dims or v.shape != bv[k].shape
         for k, v in av.items()):
    return False
  for k, v in ac.items():
    x, y = _xp.to_numpy(v.data), _xp.to_numpy(bc[k].data)
    if v.dims != bc[k].dims or x.dtype != y.dtype or not np.array_equal(x, y):
      return False
  return True


def _device_means(names, sums: dict, counts: dict, dev):
  """A temporal-mean config's means on ``dev``.  Each metric's sums and
  counts are divided (``_finalize_mean``) and dropped from ``sums`` and
  ``counts`` at once.  Where every metric has the same variables, dims and
  coordinates, the means are stacked into one Dataset of (metric, ...)
  tensors, which ``merge_metric_results`` takes as it is;
  otherwise the per-metric means ({name: Dataset}) are returned, for its
  outer join on the host."""
  means = {name: _finalize_mean(sums.pop(name), counts.pop(name))
           for name in names}
  first, *rest = means.values()
  if not all(_same_layout(first, m) for m in rest):
    return means
  dims = {k: v.dims for k, v in first.variables_dict().items()}
  stacked = xds.Dataset({}, coords={
      **first.coords_dict(), "metric": np.asarray(list(means), dtype=object)})
  payloads = [{k: v.data for k, v in m.variables_dict().items()}
              for m in means.values()]
  del means, first, rest
  for k, d in dims.items():
    # each metric's means of k are freed as they join the stack
    stacked[k] = xds.Variable(("metric",) + d, torch.stack(
        [torch.as_tensor(p.pop(k)).to(dev) for p in payloads]))
  return stacked


def _metric_results(means) -> list:
  """``_device_means``' output, on the host, as the datasets that
  ``evaluation.merge_metric_results`` joins: the stacked means whole, or
  each metric's means with its ``metric`` dim."""
  if isinstance(means, xds.Dataset):
    return [means]
  return [m.expand_dims(metric=np.asarray([name], dtype=object))
          for name, m in means.items()]


def _host_dataset(ds: xds.Dataset) -> xds.Dataset:
  """The dataset with every payload a numpy array on the host."""
  return ds.copy(data={k: _xp.to_numpy(v.data)
                       for k, v in ds.variables_dict().items()})


def _eval_host_metric(metric, f_chunk, t_chunk, regions, skipna, n_real,
                      chunk_dim, temporal_mean):
  """A ``supports_jit = False`` metric on the host's numpy chunk; its
  (sum, count) over the chunk's real entries, or the per-time result."""
  result = evaluation.loop_over_regions(
      lambda region: metric.compute_chunk(f_chunk, t_chunk, region=region,
                                          skipna=skipna), regions)
  if not temporal_mean:
    return result, None
  sum_ds = xds.Dataset({}, coords={
      k: v for k, v in result.coords_dict().items()
      if chunk_dim not in v.dims})
  cnt_ds = xds.Dataset({}, coords=dict(sum_ds.coords_dict()))
  for vname in result.keys():
    da = result[vname]
    ax = da.dims.index(chunk_dim)
    vals = np.take(np.asarray(da.values, dtype=np.float64),
                   np.arange(n_real), axis=ax)
    if skipna:
      valid = ~np.isnan(vals)
      s = np.where(valid, vals, 0.0).sum(axis=ax)
      c = valid.sum(axis=ax).astype(np.float64)
    else:
      s = vals.sum(axis=ax)
      c = np.full(s.shape, float(vals.shape[ax]))
    dims = tuple(d for d in da.dims if d != chunk_dim)
    sum_ds[vname] = xds.Variable(dims, s)
    cnt_ds[vname] = xds.Variable(dims, c)
  return sum_ds, cnt_ds


def _chunk_slices(total: int, size: int):
  for start in range(0, total, size):
    yield slice(start, min(start + size, total))


def _auto_chunk_size(forecast, chunk_dim: str, batch: int = 1,
                     companions: float = 2) -> int:
  """A chunk size targeting DEFAULT_CHUNK_BYTES of forecast per chunk,
  scaled down when a per-chunk climatology rides along (companions > 2),
  in whole multiples of the batch axis where it can."""
  budget = DEFAULT_CHUNK_BYTES * 2.0 / max(companions, 2)
  total = forecast.sizes[chunk_dim]
  per_entry = 0
  for v in forecast.variables_dict().values():
    if chunk_dim in v.dims:
      per_entry += v.size // v.sizes[chunk_dim] * np.dtype(v.dtype).itemsize
  if per_entry <= 0:
    return total
  size = max(1, int(budget // per_entry))
  if batch > 1:
    size = max(batch, size // batch * batch)
  return min(total, size)


def _pad_chunk(ds: xds.Dataset, chunk_dim: str, target: int) -> xds.Dataset:
  """Pad the chunk dim to `target` by repeating the last entry."""
  n = ds.sizes[chunk_dim]
  if n == target:
    return ds
  idx = np.concatenate([np.arange(n), np.full(target - n, n - 1)])
  return ds.isel({chunk_dim: idx})


def _rename_utime_var(v):
  if "time" not in v.dims:
    return v
  return xds.Variable(tuple(_UTIME if d == "time" else d for d in v.dims),
                      v.data, v.attrs)


def _rename_utime(obj):
  """Rename the deduplicated truth-time dim 'time' -> '__utime'.

  Applied after prepare_chunk (which sees a normal truth chunk); coords on
  the time dim are dropped, their labels differ per chunk.
  """
  return _map_labeled(obj, _rename_utime_labeled)


def _rename_utime_labeled(obj):
  if "time" not in obj.sizes:
    return obj
  coords = {k: v for k, v in obj.coords_dict().items()
            if "time" not in v.dims and k != "time"}
  if isinstance(obj, xds.Dataset):
    return xds.Dataset(
        {k: _rename_utime_var(v) for k, v in obj.variables_dict().items()},
        coords=coords, attrs=obj.attrs)
  return xds.DataArray(_rename_utime_var(obj.variable), coords=coords,
                       name=obj.name)


def _expand_utime(obj, uinv):
  """Expand unique-time tensors to the chunk's (init, lead) layout with
  one gather on the device: the device half of the truth dedup."""
  return _map_labeled(obj, lambda labeled: labeled.isel({_UTIME: uinv})
                      if _UTIME in labeled.sizes else labeled)


def _make_truth_chunk(f_chunk, truth, climatology, eval_config, data_config,
                      unique_times=None, prob_clim=None):
  """(forecast chunk, truth chunk, member index): truth aligned to the
  forecast chunk (its compact unique-time selection under the dedup, else
  valid-time or time aligned), and the forecast replaced by a baseline
  where the config asks for one.  The probabilistic climatology's members
  come at each distinct (day of year, hour) of the chunk's valid times; the
  member index (else None) expands them to the chunk."""
  by_init = data_config.by_init
  index = None
  if unique_times is not None:
    t_chunk = truth.sel(time=unique_times)
  elif by_init:
    t_chunk = truth.sel(time=f_chunk["valid_time"])
  else:
    t_chunk = truth.sel(time=f_chunk.coords_dict()["time"].data)
  if eval_config.evaluate_climatology and climatology is not None:
    f_chunk = evaluation.substitute_climatology_forecast(
        f_chunk, climatology, by_init)
  elif eval_config.evaluate_probabilistic_climatology:
    members, index = prob_clim.compact_members(
        f_chunk["valid_time" if by_init else "time"], list(f_chunk.keys()))
    f_chunk = evaluation.with_forecast_coords(members, f_chunk)
  elif eval_config.evaluate_persistence:
    if not by_init:
      # as in the JAX package: the by-valid persistence forecast needs the
      # whole time axis at once
      raise ValueError(
          "Persistence in streaming mode requires by-init format; "
          "evaluate_in_memory builds the by-valid persistence forecast.")
    f_chunk = evaluation.create_persistence_forecast_by_init(f_chunk, truth)
  return f_chunk, t_chunk, index


def input_key(cfg):
  """What decides how a config's inputs are built (the baseline
  substitution, the derived variables by definition and not just by name,
  against_analysis): configs with equal keys share one chunk stream.  The
  probabilistic climatology's years and hours count only where it is on
  (the CLI gives them to five configs; the JAX package's key splits a
  stream on them even where they are unused)."""
  return (
      cfg.against_analysis,
      cfg.evaluate_climatology,
      cfg.evaluate_persistence,
      (cfg.probabilistic_climatology_start_year,
       cfg.probabilistic_climatology_end_year,
       cfg.probabilistic_climatology_hour_interval)
      if cfg.evaluate_probabilistic_climatology else None,
      tuple(sorted((n, type(dv).__qualname__, repr(dv))
                   for n, dv in cfg.derived_variables.items())),
  )


def _check_resume(state, eval_configs, chunk_size, total, n_lead_slices):
  """Raise unless ``state`` can resume this run: the same config group,
  accumulators for the progress it records, the same chunk grid and the
  same lead slices.  Normalizes a version-1 state to the ``configs`` form,
  and its progress (``lead_index``, ``chunk_index``) to ints.
  """
  if state.configs is None and state.sums is not None:
    if len(eval_configs) > 1:
      raise ValueError(
          "legacy single-config checkpoint cannot resume a grouped "
          "multi-config run; delete the checkpoint or stream the config "
          "alone")
    state.configs = {next(iter(eval_configs)): (state.sums, state.counts)}
  resume_lead = state.lead_index = int(state.lead_index or 0)
  resume_chunk = state.chunk_index = int(state.chunk_index or 0)
  if state.configs is not None and set(state.configs) != set(eval_configs):
    raise ValueError(
        f"checkpoint covers configs {sorted(state.configs)} but this run "
        f"streams {sorted(eval_configs)}; pass the same config group to "
        "resume")
  if (resume_chunk or resume_lead) and state.configs is None:
    raise ValueError(
        "checkpoint records chunk progress but carries no accumulators; "
        "resuming would silently drop the covered chunks")
  if resume_chunk:
    # another TOTAL is fine (a partial run resumed over the full range) as
    # long as the chunk grid lines up from the start
    if state.chunk_size is not None and state.chunk_size != chunk_size:
      raise ValueError(
          f"checkpoint was taken with chunk_size={state.chunk_size} but "
          f"this run uses chunk_size={chunk_size}; pass the same "
          "--input_chunks to resume")
    # in CHUNKS, not entries: the last chunk may be ragged
    n_chunks = -(-total // chunk_size)
    if resume_chunk > n_chunks:
      raise ValueError(
          f"checkpoint covers {resume_chunk} chunks of {chunk_size} but "
          f"this run has only {total} entries ({n_chunks} chunks)")
  if state.configs is not None or resume_chunk or resume_lead:
    if (state.n_lead_slices is not None
        and state.n_lead_slices != n_lead_slices):
      raise ValueError(
          f"checkpoint was taken with {state.n_lead_slices} lead slices "
          f"but this run has {n_lead_slices}; pass the same "
          "--input_chunks lead_time to resume")
    completed = len(state.completed_leads or [])
    if resume_lead >= n_lead_slices or completed < resume_lead:
      raise ValueError(
          f"checkpoint lead_index={resume_lead} with {completed} completed "
          f"slices does not fit a run of {n_lead_slices} lead slices")


class _Snapshots:
  """Periodic state files, written by one background thread.

  The accumulators are replaced, never updated in place, so a snapshot
  keeps the tensors of its moment alive and copies them to the host on a
  side stream, behind an event recorded on the compute stream: the copy
  waits for the chunk that produced them and stalls neither the compute
  stream nor the prefetch threads.  One worker and ``os.replace`` keep the
  saves ordered and the file whole at every moment.
  """

  def __init__(self, path, dev):
    self.path = path
    self.dev = dev
    self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    self.pending: list = []

  def wait(self):
    while self.pending:
      self.pending.pop(0).result()

  def submit(self, snap: StreamingState):
    ready = None
    if self.stream is not None:
      ready = torch.cuda.Event()
      ready.record(torch.cuda.current_stream(self.dev))
    self.wait()  # at most one save in flight
    self.pending.append(self.pool.submit(self._write, snap, ready))

  def _write(self, snap: StreamingState, ready) -> None:
    with (torch.cuda.stream(self.stream) if self.stream is not None
          else contextlib.nullcontext()):
      if ready is not None:
        self.stream.wait_event(ready)
      snap.sums, snap.counts, snap.configs = batched_device_get(
          (snap.sums, snap.counts, snap.configs))
    tmp = self.path + ".tmp"
    snap.save(tmp)
    os.replace(tmp, self.path)

  def close(self):
    try:
      self.wait()
    finally:
      self.pool.shutdown(wait=True)


class _RankShare:
  """What this rank of a mesh evaluates, and the collectives it calls.

  On the ``batch`` axis a rank takes rows ``[b·c/W, (b+1)·c/W)`` of every
  padded chunk of c entries; on the ``spatial`` axis it holds latitude band
  s of S.  ``owner`` (spatial coordinate 0) adds results to the
  accumulators: the kernels' sums are whole after ``band_sum``, and what
  needs whole fields runs on one spatial rank only.  Each chunk's (sum,
  count) leaves are added over the batch axis before they join the
  accumulators, which every owner then holds alike (as the JAX package's
  mesh sums each chunk's results over its devices): the accumulators are
  formed in the same order under any world size, so a state saved by rank
  0 resumes a world of any size, and a world of the same size bit for bit.
  Rank 0 finalizes and writes.  ``mesh=None`` is the one-device engine:
  every share is the whole and no collective runs.

  Bands are gathered by an ``all_reduce(SUM)`` of zero-filled tensors of the
  whole latitude axis, not through the host: gloo takes CUDA tensors for
  ``all_reduce`` and ``broadcast`` only, NCCL for every collective, so one
  collective serves both backends and the card; adding zeros is exact, so
  the gathered field equals the field bit for bit.
  """

  def __init__(self, mesh, latitude: Optional[xds.Variable]):
    self.mesh = mesh
    if mesh is not None and (
        mesh.axis_names[:1] != (BATCH,)
        or not set(mesh.axis_names) <= {BATCH, SPATIAL}):
      raise ValueError(
          f"mesh axes {mesh.axis_names}: the engine shards over ('batch',) "
          "or ('batch', 'spatial')")
    size = mesh.size if mesh is not None else (lambda axis: 1)
    coordinate = mesh.coordinate if mesh is not None else (lambda axis: 0)
    self.batch, self.b = size(BATCH), coordinate(BATCH)
    spatial = size(SPATIAL)
    self.owner = coordinate(SPATIAL) == 0
    self.lead = mesh is None or mesh.rank == 0
    self.latitude = latitude
    self.band = None
    if spatial > 1:
      if latitude is None:
        raise ValueError("a mesh with a 'spatial' axis shards latitude; the "
                         "forecast has none")
      n_lat = latitude.shape[0]
      if n_lat % spatial:
        # the JAX package's refusal: a silent replication would waste the
        # spatial axis (721 = 7 x 103 latitudes at 0.25 degrees, 121 at 1.5)
        divisors = [d for d in range(2, n_lat + 1) if n_lat % d == 0]
        raise ValueError(
            f"mesh axis 'spatial'={spatial} does not divide the "
            f"latitude size {n_lat}; valid spatial shard counts are "
            f"{divisors[:8]}{'...' if len(divisors) > 8 else ''} — or "
            "use a batch-only mesh (recommended at official geometries, "
            "docs/scaling.md)")
      h = n_lat // spatial
      s = coordinate(SPATIAL)
      self.band = slice(s * h, (s + 1) * h)
    self.gathered_bytes = 0

  def rows(self, n: int) -> slice:
    """This rank's rows of a padded chunk of ``n`` (a multiple of batch)."""
    per = n // self.batch
    return slice(self.b * per, (self.b + 1) * per)

  def to_band(self, obj):
    """``obj`` with every Dataset and DataArray that spans the whole
    latitude axis cut to this rank's band (lazily where it is lazy)."""
    if self.band is None:
      return obj
    n_lat = self.latitude.shape[0]
    return _map_labeled(obj, lambda labeled: labeled.isel(latitude=self.band)
                        if labeled.sizes.get("latitude") == n_lat
                        else labeled)

  def band_sum(self, outs):
    """A region kernel's band outputs added over the spatial axis."""
    if self.band is None:
      return outs
    group = self.mesh.group(SPATIAL)
    for t in outs:
      dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return outs

  def _gather_payload(self, var: xds.Variable):
    if "latitude" not in var.dims or not torch.is_tensor(var.data):
      return var.data
    ax = var.dims.index("latitude")
    shape = list(var.shape)
    shape[ax] = self.latitude.shape[0]
    whole = var.data.new_zeros(shape)
    whole.narrow(ax, self.band.start, self.band.stop - self.band.start).copy_(
        var.data)
    dist.all_reduce(whole, op=dist.ReduceOp.SUM,
                    group=self.mesh.group(SPATIAL))
    self.gathered_bytes += whole.numel() * whole.element_size()
    return whole

  def _whole_coords(self, coords):
    out = {k: v for k, v in coords.items() if "latitude" not in v.dims}
    if "latitude" in coords:
      out["latitude"] = self.latitude
    return out

  def gather_bands(self, tree):
    """``tree`` with every tensor on a latitude band gathered to the whole
    latitude axis over the spatial axis (every spatial rank calls this)."""
    if self.band is None:
      return tree
    return _map_labeled(tree, self._gather_labeled)

  def _gather_labeled(self, obj):
    if isinstance(obj, xds.Dataset):
      return xds.Dataset(
          {k: xds.Variable(v.dims, self._gather_payload(v), v.attrs)
           for k, v in obj.variables_dict().items()},
          coords=self._whole_coords(obj.coords_dict()), attrs=obj.attrs)
    v = obj.variable
    return xds.DataArray(
        xds.Variable(v.dims, self._gather_payload(v), v.attrs),
        coords=self._whole_coords(obj.coords), name=obj.name)

  def sum_over_batch(self, tree, dev):
    """``tree`` (float64 sums and counts, tensors or host arrays) added over
    the batch axis: one ``all_reduce`` of all its payloads packed in one
    float64 tensor on ``dev``.  A world of one rank reduces too."""
    if self.mesh is None:
      return tree
    tree = _replace_leaves(tree, lambda x: torch.as_tensor(
        _xp.to_numpy(x) if not torch.is_tensor(x) else x).to(
            dev, torch.float64))
    leaves = _leaves(tree, [])
    if not leaves:
      return tree
    flat = torch.cat([t.reshape(-1) for t in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                    group=self.mesh.group(BATCH))
    parts = iter(flat.split([t.numel() for t in leaves]))
    return _replace_leaves(tree, lambda t: next(parts).view(t.shape))

  def gather_rows(self, items: list) -> Optional[list]:
    """Every batch rank's ``items`` on rank 0 (None elsewhere), through the
    host: per-time results are host datasets by then."""
    if self.mesh is None:
      return items
    out = [None] * self.batch if self.lead else None
    dist.gather_object(items, out, dst=0, group=self.mesh.group(BATCH))
    return [item for part in out for item in part] if self.lead else None

  def agree(self, value, what: str) -> None:
    """Raise unless every rank of the world holds rank 0's ``value``."""
    if self.mesh is None:
      return
    box = [value]
    dist.broadcast_object_list(box, src=0)
    if box[0] != value:
      raise ValueError(f"rank {self.mesh.rank} has {what} {value!r}, rank 0 "
                       f"{box[0]!r}")

  def all_stats(self, mine: dict) -> list:
    """Every rank's counts, in rank order."""
    if self.mesh is None:
      return [mine]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def _launch_counts() -> dict:
  """The region kernels' launch counters of this process (0 for a wrapper
  that a caller replaced with one that counts nothing)."""
  return {f"{name}_launches": getattr(getattr(ops, name), "launches", 0)
          for name in ("fused_deterministic_sums", "fused_region_sums")}


def _transfer_dtype():
  """``WB2_TRANSFER_DTYPE``: unset or empty moves payloads in their own
  type; ``bfloat16`` moves large float payloads as bfloat16."""
  name = os.environ.get("WB2_TRANSFER_DTYPE", "")
  if name not in ("", "bfloat16"):
    raise ValueError(
        f"WB2_TRANSFER_DTYPE={name!r}: the transfer type is 'bfloat16' or "
        "unset")
  return torch.bfloat16 if name else None


def check_config(name: str, cfg, resumable) -> None:
  """Raise unless config ``name`` is valid and holds port metrics and,
  where its stream is ``resumable`` (a state resumes it or is written),
  takes temporal means: per-time results live in a host-side list, not in
  the state, so a resumed run would drop the rows of every chunk already
  done."""
  cfg.validate()
  for metric in cfg.metrics.values():
    if not isinstance(metric, metrics_lib.Metric):
      raise TypeError(
          f"{type(metric).__module__}.{type(metric).__name__} is not a "
          "port metric; convert reference configs with "
          "convert.eval_configs_from_reference")
  if resumable and not cfg.temporal_mean:
    raise ValueError(
        f"checkpoint/resume requires temporal_mean=True (config {name!r} "
        "emits per-time results, which the accumulator state does not "
        "capture)")


def _chunk_size(forecast, climatology, input_chunks, chunk_dim,
                batch: int) -> int:
  """``input_chunks``' size of the chunk dim, else ``_auto_chunk_size``'s,
  rounded up to a multiple of the batch axis: every rank takes an equal
  share of each chunk (the padded last one too)."""
  if chunk_dim in input_chunks:
    size = int(input_chunks[chunk_dim])
  else:
    companions = 2
    if climatology is not None and sum(
        4 * v.size for v in climatology.variables_dict().values()
    ) > metrics_lib.clim_device_budget():
      companions = 2.5  # the climatology gathers per chunk on the host
    size = _auto_chunk_size(forecast, chunk_dim, batch, companions)
  if size < 1:
    raise ValueError(f"chunk size must be positive, got {size}")
  return -(-size // batch) * batch


class _Plan:
  """What a stream decides once from its inputs, and never changes: read
  by the prefetch threads (``_prepare_chunk``) and the main thread
  (``_stream_lead_slice``, ``_finalize``) alike.

  It holds the chunk grid (``chunk_dim``, ``chunk_size``, ``total``) and
  the ``lead_slices``; this rank's ``share`` of the mesh; its
  ``forecast``, ``truth`` and ``climatology``, cut to its latitude band
  unless a derived variable reads across latitude (``band_after_derive``:
  the band is cut after the derivation); the truth dedup decision; each
  config's metrics split into device and host ones and its fused plans
  (``plans_by``: the det, prob and pointwise plans and the per-metric
  loop's metrics, ``_partition_fused``); the transfer type and the copy
  stream; and ``state``, checked and agreed on by every rank, which the
  stream resumes from.
  """

  def __init__(self, forecast, truth, climatology, eval_configs, data_config,
               input_chunks, skipna, dev, mesh, spans, state, checkpoint_path,
               checkpoint_every):
    cfg0 = self.cfg0 = next(iter(eval_configs.values()))
    self.eval_configs, self.data_config = eval_configs, data_config
    self.skipna, self.dev, self.spans = skipna, dev, spans
    self.transfer_dtype = _transfer_dtype()
    share = self.share = _RankShare(mesh, forecast.coords_dict().get(
        "latitude"))
    self.chunk_dim = "init_time" if data_config.by_init else "time"
    self.total = forecast.sizes[self.chunk_dim]
    self.chunk_size = _chunk_size(forecast, climatology, input_chunks,
                                  self.chunk_dim, share.batch)
    lead_chunk = int(input_chunks.get("lead_time", 0)) or None
    self.lead_slices = (
        list(_chunk_slices(forecast.sizes["lead_time"], lead_chunk))
        if lead_chunk and "lead_time" in forecast.sizes else [slice(None)])
    # derived variables whose core dims hold the lead axis (precipitation
    # accumulations) need the whole axis in every chunk, and a truth with it
    lead_core = [name for name, dv in cfg0.derived_variables.items()
                 if {"lead_time", "prediction_timedelta"}
                 & dv.all_input_core_dims]
    if lead_core and len(self.lead_slices) > 1:
      raise ValueError(
          f"derived variable {lead_core[0]!r} requires the full lead_time "
          "axis per chunk; remove lead_time from input_chunks or drop the "
          "derived variable")
    self.derived_bases = {base for dv in cfg0.derived_variables.values()
                          for base in dv.base_variables}
    self.device_metrics_by = {
        c: {k: m for k, m in cfg.metrics.items() if m.supports_jit}
        for c, cfg in eval_configs.items()}
    self.host_metrics_by = {
        c: {k: m for k, m in cfg.metrics.items() if not m.supports_jit}
        for c, cfg in eval_configs.items()}
    self.any_host = any(self.host_metrics_by.values())
    self.regions_by = {c: (cfg.regions or {None: None})
                       for c, cfg in eval_configs.items()}
    # every chunk is padded to chunk_size where a config takes temporal means
    self.pad_to_size = any(cfg.temporal_mean for cfg in eval_configs.values())
    # host metrics need a chunk-shaped truth on the host, and the lead-core
    # derived variables a truth with the lead axis: no dedup then
    self.truth_dedup = (data_config.by_init and not self.any_host
                        and not lead_core and "time" in truth.sizes
                        and _UTIME not in truth.sizes)
    # a rank reads its latitude band, unless a derived variable differences
    # or integrates over latitude: then it reads the whole axis and keeps
    # its band of the derived fields
    self.band_after_derive = share.band is not None and any(
        "latitude" in dv.all_input_core_dims
        for dv in cfg0.derived_variables.values())
    self.forecast, self.truth, self.climatology = (
        (forecast, truth, climatology) if self.band_after_derive
        else share.to_band((forecast, truth, climatology)))
    self.prob_clim = (evaluation.probabilistic_climatology(self.truth, cfg0)
                      if cfg0.evaluate_probabilistic_climatology else None)
    # the members of the probabilistic climatology are the forecast's
    self.plans_by = _fused_plans(
        self, forecast.assign_coords(number=np.arange(self.prob_clim.size))
        if self.prob_clim is not None and "number" not in forecast.sizes
        else forecast)
    self.copy_stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                        else None)
    self.generic_timer = _LoopTimer(dev)
    self.state = state if state is not None else StreamingState()
    _check_resume(self.state, eval_configs, self.chunk_size, self.total,
                  len(self.lead_slices))
    share.agree((self.state.lead_index, self.state.chunk_index,
                 self.state.configs is not None),
                "a state at (lead slice, chunk, accumulators)")
    self.checkpoint_every = checkpoint_every
    self.snapshot_path = (checkpoint_path if checkpoint_path
                          and checkpoint_every and share.lead else None)

  def chunk_list(self, lead_i) -> list:
    """(index, slice) of each chunk of lead slice ``lead_i`` left to
    stream: in the slice a state stopped in, those past the chunks it
    covers."""
    chunks = list(enumerate(_chunk_slices(self.total, self.chunk_size)))
    return chunks[self.state.chunk_index
                  if lead_i == self.state.lead_index else 0:]


def _fused_plans(plan: _Plan, members_like: xds.Dataset) -> dict:
  """Each config's (det, prob, pointwise plans, per-metric loop's
  metrics), planned on the whole grid (``members_like``), each plan's
  region weights on the device: the whole grid's, cut to the band, so
  that the latitude weights stay normalized over the whole grid."""
  share = plan.share
  infinite = {name for name, dv in plan.cfg0.derived_variables.items()
              if dv.may_be_infinite}
  plans_by = {}
  for cname, metrics in plan.device_metrics_by.items():
    *plans, generic = _partition_fused(metrics, plan.regions_by[cname],
                                       members_like)
    for fused in plans:
      if fused is not None:
        region_w = fused["region_w"]
        if share.band is not None:
          n_lat = share.latitude.shape[0]
          region_w = np.ascontiguousarray(region_w.reshape(
              region_w.shape[0], -1, n_lat)[:, :, share.band].reshape(
                  region_w.shape[0], -1))
        fused.update(region_w_dev=torch.as_tensor(region_w, device=plan.dev),
                     infinite=infinite, band_sum=share.band_sum)
    plans_by[cname] = (*plans, generic)
  return plans_by


def _prepare_chunk(plan: _Plan, ci, sl, lead_sl, queue):
  """A chunk's host work on a prefetch thread (``_stage_chunk``), its large
  payloads staged as tasks of ``queue`` at the chunk's rank, under a
  ``wb2.prepare`` span: (what it staged, the chunk's counts).  The counts
  are filled where they are measured: bytes moved (``h2d_bytes``) and
  seconds pinning (``pin_s``) by ``xds.to_device``; the reads and decodes
  wherever the chunk's tasks ran (``read_bytes``, ``read_s``,
  ``decode_bytes``, ``decode_s``) by ``io_zarr.tally``; seconds in the
  metrics' ``prepare_chunk`` (``metric_prep_s``); payload tasks
  (``stage_tasks``) and seconds of them on other threads (``offload_s``) by
  the ``xds.Staging``; the chunk's thread-seconds (``prepare_s``: this
  thread's wall less the seconds it waited on its tasks, ``blocked_s``,
  plus ``offload_s``).  The span carries them, with ``blocked_s`` and
  ``prepare_s`` as ``busy_s``."""
  t0 = time.perf_counter()
  counts = tracing.Counts(h2d_bytes=0, pin_s=0.0, read_bytes=0, read_s=0.0,
                          decode_bytes=0, decode_s=0.0)
  staging = xds.Staging(queue, ci)
  with plan.spans.span("wb2.prepare", chunk=ci) as rec, io_zarr.tally(counts):
    staged = _stage_chunk(plan, ci, sl, lead_sl, counts, staging)
    counts.add(stage_tasks=staging.tasks, offload_s=staging.offload_s)
    rec.update(counts, blocked_s=staging.blocked_s)
  # after the span closed: the thread-seconds of its whole wall
  counts["prepare_s"] = rec["busy_s"] = (
      time.perf_counter() - t0 - staging.blocked_s + staging.offload_s)
  return staged, counts


def _stage_chunk(plan: _Plan, ci, sl, lead_sl, counts, staging):
  """Host work for this rank's share of one chunk (slice, align, prepare,
  pad) and its transfer; the share is read and moved once for all
  configs.  Derived variables and the probabilistic climatology's members
  are made on the device after the copy, before the metrics prepare the
  chunk."""
  share, dev, cfg0, chunk_dim = plan.share, plan.dev, plan.cfg0, plan.chunk_dim
  any_host, copy_stream = plan.any_host, plan.copy_stream
  f_chunk = plan.forecast.isel({chunk_dim: sl})
  if lead_sl != slice(None):
    f_chunk = f_chunk.isel(lead_time=lead_sl)
  n_real = f_chunk.sizes[chunk_dim]
  padded = (plan.chunk_size if plan.pad_to_size
            else -(-n_real // share.batch) * share.batch)
  f_chunk = _pad_chunk(f_chunk, chunk_dim, padded)
  rows = share.rows(padded)
  if rows != slice(0, padded):
    f_chunk = f_chunk.isel({chunk_dim: rows})
  time_mask = (np.arange(rows.start, rows.stop) < n_real).astype(np.float64)
  uinv = uniq = None
  if plan.truth_dedup:
    # the valid-time-aligned truth repeats each time in ~every lead
    # slot: ship each unique time once, expand on the device
    vt = np.asarray(f_chunk["valid_time"].data)
    uniq, inv = np.unique(vt.ravel(), return_inverse=True)
    n_pad = -(-len(uniq) // UTIME_BUCKET) * UTIME_BUCKET
    uniq = np.concatenate([uniq, np.repeat(uniq[-1:], n_pad - len(uniq))])
    uinv = xds.DataArray(inv.reshape(vt.shape).astype(np.int64),
                         dims=f_chunk["valid_time"].dims)
  with (torch.cuda.stream(copy_stream) if copy_stream is not None
        else contextlib.nullcontext()):
    f_chunk, t_chunk, members = _make_truth_chunk(
        f_chunk, plan.truth, plan.climatology, cfg0, plan.data_config, uniq,
        plan.prob_clim)
    if members is not None or cfg0.derived_variables:
      # derived variables come from their base fields at full precision,
      # as the JAX package derives on the host before its bfloat16 cast;
      # those fields and the derived ones are rounded after the derivation
      # (host metrics read every field at full precision, and the fields
      # cross again below)
      f_chunk, t_chunk = xds.to_device(
          (f_chunk, t_chunk), dev, copy_stream, counts,
          None if any_host else plan.transfer_dtype,
          full_precision=plan.derived_bases, staging=staging)
      if members is not None:
        f_chunk = f_chunk.isel({utils.MEMBER_PAIR: members})
      f_chunk, t_chunk = evaluation.add_derived_variables(f_chunk, t_chunk,
                                                          cfg0)
      if plan.band_after_derive:
        f_chunk, t_chunk = share.to_band((f_chunk, t_chunk))
      if plan.transfer_dtype is not None and not any_host:
        f_chunk, t_chunk = xds.round_to_bfloat16((f_chunk, t_chunk))
    if any_host:
      f_chunk, t_chunk = _host_dataset(f_chunk), _host_dataset(t_chunk)
    host_chunks = (f_chunk, t_chunk) if any_host else None
    with counts.timing("metric_prep_s"):
      prepared = {
          c: {name: m.prepare_chunk(f_chunk, t_chunk, device=dev)
              for name, m in metrics.items()}
          for c, metrics in plan.device_metrics_by.items()
      }
    # climatology gathers span the whole grid: cut them to the band
    prepared = share.to_band(prepared)
    if plan.truth_dedup:
      t_chunk = _rename_utime(t_chunk)
      prepared = _rename_utime(prepared)
    moved = xds.to_device(
        _map_labeled((f_chunk, t_chunk, prepared, uinv),
                     lambda obj: _normalize_chunk_coords(obj, chunk_dim)),
        dev, copy_stream, counts, plan.transfer_dtype, staging=staging)
    mask_dev = torch.as_tensor(time_mask).to(dev, non_blocking=True)
    event = None
    if copy_stream is not None:
      event = torch.cuda.Event()
      event.record(copy_stream)
  return ci, n_real, sl, rows, moved, mask_dev, event, host_chunks


def _chunk_program(plan: _Plan, cname, f_c, t_c, prepared, time_mask, uinv,
                   rec):
  """Every device metric × region of one config on one chunk, reduced
  over the chunk dim (or per time with temporal_mean=False); the per-metric
  loop's seconds go to ``rec``'s ``generic_s``."""
  det_plan, prob_plan, pw_plan, generic = plan.plans_by[cname]
  metrics, skipna = plan.device_metrics_by[cname], plan.skipna
  if plan.truth_dedup:
    t_c = _expand_utime(t_c, uinv)
    prepared = _expand_utime(prepared, uinv)
  results = {}
  generic_names = list(generic)
  if det_plan is not None:
    results.update(_fused_chunk_results(det_plan, f_c, t_c, skipna))
  if prob_plan is not None:
    results.update(_fused_prob_chunk_results(prob_plan, f_c, t_c, skipna))
  if pw_plan is not None:
    pw_results, leftover = _pointwise_chunk_results(
        pw_plan, metrics, f_c, t_c, prepared, skipna)
    results.update(pw_results)
    generic_names.extend(leftover)
  if generic_names:
    # whole fields, on one spatial rank
    f_c, t_c, prepared = plan.share.gather_bands((f_c, t_c, prepared))
  if generic_names and plan.share.owner:
    with plan.generic_timer.time(rec):
      for name in generic_names:
        results[name] = evaluation.loop_over_regions(
            lambda region, name=name: metrics[name].compute_chunk_prepared(
                f_c, t_c, prepared[name], region=region, skipna=skipna),
            plan.regions_by[cname])
  metrics_lib.clear_caches()  # the CRPS spread of this chunk
  if not plan.eval_configs[cname].temporal_mean:
    return results, dict.fromkeys(results)
  sums, counts = {}, {}
  for name, result in results.items():
    sums[name], counts[name] = _masked_sum_count(result, plan.chunk_dim,
                                                 time_mask, skipna)
  return sums, counts


def _chunk_step(plan: _Plan, staged, per_time: dict, rec) -> dict:
  """A prepared chunk through every config's program on the main thread:
  its per-time rows appended to ``per_time``, and its (sums, counts) by
  temporal-mean config, added over the batch axis, returned."""
  ci, n_real, sl, rows, moved, mask_dev, event, host_chunks = staged
  share, chunk_dim = plan.share, plan.chunk_dim
  if event is not None:
    compute_stream = torch.cuda.current_stream(plan.dev)
    compute_stream.wait_event(event)
    # the copies were allocated on the side stream: keep their memory from
    # being reused while this stream still reads it
    for t in _leaves((moved, mask_dev), []):
      t.record_stream(compute_stream)
  f_dev, t_dev, p_dev, u_dev = moved
  if plan.any_host and share.band is not None:
    host_chunks = tuple(_host_dataset(ds) for ds in
                        share.gather_bands((f_dev, t_dev)))
  # this rank's real rows, for per-time results
  real = np.arange(max(0, min(rows.stop, n_real) - rows.start))
  chunk_sums = {}
  for cname, cfg in plan.eval_configs.items():
    sums, counts = _chunk_program(plan, cname, f_dev, t_dev, p_dev[cname],
                                  mask_dev, u_dev, rec)
    if not share.owner:
      continue  # the owner of this band's results adds them
    for name, metric in plan.host_metrics_by[cname].items():
      sums[name], counts[name] = _eval_host_metric(
          metric, *host_chunks, plan.regions_by[cname], plan.skipna,
          len(real), chunk_dim, cfg.temporal_mean)
    if cfg.temporal_mean:
      chunk_sums[cname] = (sums, counts)
      continue
    coord = np.asarray(plan.forecast.coords_dict()[chunk_dim].data)[sl]
    if len(real):
      for name, res in sums.items():
        res = res.isel({chunk_dim: real})
        per_time[cname].append((name, ci, share.b, res.assign_coords(
            {chunk_dim: coord[rows.start:rows.start + len(real)]})))
  return share.sum_over_batch(chunk_sums, plan.dev)


def _accumulate(acc: dict, align: set, chunk_sums: dict) -> None:
  """Each config's chunk (sums, counts) added to its [sums, counts] in
  ``acc``, as new arrays, the sums first; a config in ``align`` (resumed
  from a state saved in another variable order) has its accumulators put
  in this run's order at its first merge."""
  for cname, chunk in chunk_sums.items():
    if acc[cname] is None:
      acc[cname] = list(chunk)
      continue
    for i, part in enumerate(chunk):
      if cname in align:
        acc[cname][i] = _reorder_like(part, acc[cname][i])
      acc[cname][i] = _tree_add(acc[cname][i], part)
    align.discard(cname)


def _snapshot(plan: _Plan, acc, chunk_index, lead_i,
              lead_results) -> StreamingState:
  """The state after ``chunk_index`` chunks of lead slice ``lead_i``."""
  # the version-1 fields, kept for single-config readers
  sums, counts = acc[next(iter(acc))] if len(acc) == 1 else (None, None)
  return StreamingState(
      sums, counts, chunk_index, chunk_size=plan.chunk_size, total=plan.total,
      configs={c: tuple(acc[c]) for c in plan.eval_configs},
      lead_index=lead_i, n_lead_slices=len(plan.lead_slices),
      completed_leads=list(lead_results))


def _stream_lead_slice(plan: _Plan, lead_i, lead_sl, chunk_list,
                       lead_results, run, own):
  """One lead slice's chunks (``chunk_list``) through every config's
  program on the main thread, ``PREFETCH_DEPTH`` of them prepared ahead on
  the prefetch threads and at most ``DEVICE_INFLIGHT`` queued on the
  device, the accumulators snapshotted every ``checkpoint_every`` chunks:
  (accumulators, per-time rows) by config.  The slice a state stopped in
  starts from its accumulators.  The wait for the first chunk of every
  slice after the first this run streams is also ``lead_refill_s``: the
  pipeline fills again there."""
  share, dev, state = plan.share, plan.dev, plan.state
  first = lead_i == state.lead_index
  resuming = first and state.configs is not None
  acc = dict.fromkeys(plan.eval_configs)
  if resuming and share.owner:
    acc = {c: list(_tree_to_device(state.configs[c], dev))
           for c in plan.eval_configs}
  align = set(plan.eval_configs) if resuming else set()
  per_time = {c: [] for c in plan.eval_configs}
  own.add(chunks=len(chunk_list))
  run.add(lead_slices=1)
  refill = () if first else ("lead_refill_s",)
  inflight: list = []
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=PREFETCH_DEPTH)
  queue = xds.StageQueue(pool)
  snapshots = (_Snapshots(plan.snapshot_path, dev) if plan.snapshot_path
               else None)
  try:
    pending = [pool.submit(_prepare_chunk, plan, ci, sl, lead_sl, queue)
               for ci, sl in chunk_list[:PREFETCH_DEPTH]]
    for idx, (ci, _) in enumerate(chunk_list):
      # idx 0 fills the pipeline: nothing was prepared ahead of it (in
      # every slice after the first, again: lead_refill_s)
      with run.timing("wait_host_s", *(refill if idx == 0 else ())), \
          plan.spans.span("wb2.wait_host", chunk=ci, ordinal=idx,
                          lead=lead_i):
        staged, counts = pending.pop(0).result()
      run.add(counts)
      if idx + PREFETCH_DEPTH < len(chunk_list):
        pending.append(pool.submit(
            _prepare_chunk, plan, *chunk_list[idx + PREFETCH_DEPTH], lead_sl,
            queue))
      with plan.spans.span("wb2.chunk_program", chunk=ci,
                           generic_s=0) as rec:
        _accumulate(acc, align, _chunk_step(plan, staged, per_time, rec))
        if dev.type == "cuda":
          done = torch.cuda.Event()
          done.record(torch.cuda.current_stream(dev))
          inflight.append((ci, done))
      # bound the queue: before moving past chunk n, wait for chunk
      # n-DEVICE_INFLIGHT to finish so its buffers free
      if len(inflight) > DEVICE_INFLIGHT:
        waited, done = inflight.pop(0)
        with own.timing("wait_device_s"), plan.spans.span(
            "wb2.wait_device", chunk=waited):
          done.synchronize()
      if snapshots is not None and (ci + 1) % plan.checkpoint_every == 0:
        snapshots.submit(_snapshot(plan, acc, ci + 1, lead_i, lead_results))
  finally:
    pool.shutdown(wait=True, cancel_futures=True)
    if snapshots is not None:
      snapshots.close()
  return acc, per_time


def _config_results(cfg, means, rows, chunk_dim) -> xds.Dataset:
  """A config's results: its temporal means on the host (``means``), or
  its per-time ``rows`` ((metric, chunk, batch rank, Dataset)) joined
  along the chunk dim in chunk and rank order."""
  if cfg.temporal_mean:
    return evaluation.merge_metric_results(_metric_results(means))
  rows = sorted(rows, key=lambda row: row[1:3])
  return evaluation.merge_metric_results([
      xds.concat([res for metric, _, _, res in rows if metric == name],
                 chunk_dim).expand_dims(metric=np.asarray([name],
                                                          dtype=object))
      for name in cfg.metrics])


def _finalize(plan: _Plan, acc, per_time, own):
  """A lead slice's results by config on rank 0 (None elsewhere): its
  temporal means divided on the device and each config's accumulators
  released as they are (``_device_means``), copied back with the per-time
  rows of every batch rank (``wb2.d2h``, ``d2h_s``), then joined on the
  host (``wb2.finalize``, ``finalize_s``)."""
  share, spans = plan.share, plan.spans
  if not share.owner:
    return None
  with own.timing("wait_device_s"), own.timing("d2h_s"), spans.span(
      "wb2.d2h") as rec:
    means = {c: _device_means(cfg.metrics, *acc.pop(c), plan.dev)
             for c, cfg in plan.eval_configs.items()
             if cfg.temporal_mean and share.lead}
    rec["bytes"] = sum(t.numel() * t.element_size()
                       for t in _leaves((means, per_time), []))
    means, per_time = batched_device_get((means, per_time))
    per_time = {c: share.gather_rows(per_time[c]) for c in plan.eval_configs}
  if not share.lead:
    return None
  with own.timing("finalize_s"):
    stacked = [m for m in means.values() if isinstance(m, xds.Dataset)]
    counts = tracing.Counts(
        finalize_device_bytes=sum(v.data.nbytes for m in stacked
                                  for v in m.variables_dict().values()),
        finalize_host_merges=len(means) - len(stacked))
    own.add(counts)
    with spans.span("wb2.finalize", **counts):
      return {c: _config_results(cfg, means.get(c), per_time[c],
                                 plan.chunk_dim)
              for c, cfg in plan.eval_configs.items()}


def _merge_ranks(stats: dict, share: _RankShare, run, own) -> None:
  """Add a stream's counts to ``stats``, by one rule: each of ``run``'s
  counts is summed over the ranks, but ``wait_host_s``, its part
  ``lead_refill_s`` and ``lead_slices`` (alike on every rank) are the
  largest, and ``gathered_bytes`` and the launches are in ``stats["ranks"]``
  only (with a mesh: every rank's ``run``, in rank order); ``own`` are this
  rank's alone.  The bytes decoded are the chunks' spans' only."""
  run.pop("decode_bytes", None)
  ranks = share.all_stats(run)
  total = tracing.Counts(own)
  for key in run:
    if key in ("wait_host_s", "lead_refill_s", "lead_slices"):
      total[key] = max(r[key] for r in ranks)
    elif key != "gathered_bytes" and not key.endswith("_launches"):
      total[key] = sum(r[key] for r in ranks)
  for key, value in total.items():
    stats[key] = stats.get(key, 0) + value
  if share.mesh is not None:
    before = stats.get("ranks") or [{}] * len(ranks)
    stats["ranks"] = [{k: a.get(k, 0) + v for k, v in r.items()}
                      for a, r in zip(before, ranks)]


def evaluate_streaming_multi(
    forecast: xds.Dataset,
    truth: xds.Dataset,
    climatology: Optional[xds.Dataset],
    eval_configs: Mapping[str, Any],
    data_config,
    input_chunks: Mapping[str, int],
    skipna: bool = False,
    device=None,
    stats: Optional[dict] = None,
    state: Optional[StreamingState] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    mesh=None,
    spans=None,
) -> Optional[dict]:
  """Stream chunks ONCE through the metric programs of several configs.

  All configs must build their inputs identically (``evaluate_with_mesh``
  groups them).  Returns {config_name: results dataset}: the stream is
  planned once (``_Plan``), each lead slice's chunks run through
  the configs' programs (``_stream_lead_slice``), and each slice's results
  are finalized (``_finalize``).  ``stats``, when given, receives the
  run's counts: ``chunks``; the prefetch threads' counts of each chunk
  (``_prepare_chunk``: ``h2d_bytes``, ``read_bytes``, ``read_s``,
  ``decode_s``, ``pin_s``, ``prepare_s``, ``stage_tasks``, ``offload_s``,
  ``metric_prep_s``), summed over the threads, and with ``wait_host_s``
  absent where no chunk is left to stream (a resume from a state taken
  after the last chunk); ``generic_s``, the seconds
  of the per-metric loop (the metrics no fused tier takes; on a CUDA
  device the compute stream's time around its launches, read once the
  stream has run them, on the host its wall; each chunk's is an attribute
  of its ``wb2.chunk_program`` span); the seconds the main thread waited
  for host preparation (``wait_host_s``) and for the device
  (``wait_device_s``; its part ``d2h_s`` is the final division of the
  temporal means on the device and their copy, with the per-time results,
  to the host); and seconds spent on the host turning those into results
  (``finalize_s``); ``finalize_device_bytes`` are the bytes of temporal
  means stacked by metric on the device, and ``finalize_host_merges`` the
  configs whose metrics differ in variables, dims or coordinates, joined
  on the host instead (both also attributes of the ``wb2.finalize`` span);
  ``lead_slices``, the lead slices streamed, and ``lead_refill_s``, the
  part of ``wait_host_s`` spent waiting for the first chunk of each slice
  after the first (0 with one slice).
  ``spans`` (a ``tracing.Spans``) records the chunk pipeline's spans, and
  False records none (with more than one lead slice, a ``wb2.lead_slice``
  span covers each slice's stream and finalize: ``lead``, its index,
  ``leads``, its length, and ``chunks``); None, the default, records them
  while ``torch.profiler`` records the calling thread, into
  ``stats["spans"]``.
  ``state`` resumes a run; with ``checkpoint_path`` and
  ``checkpoint_every`` the accumulators of every config are snapshotted
  together every so many chunks, completed lead slices' results riding in
  the state.

  With ``mesh`` (a ``parallel.mesh.Mesh``; every rank of its world calls
  this with the same arguments) each rank reads, moves and scores its share
  of every chunk on its own device (see ``_RankShare``); the chunk size is
  rounded up to a multiple of the batch axis, as in the JAX package, so a
  state's chunk grid is the same under any world size.  Rank 0 returns the
  results (the other ranks None) and writes the snapshots; a state seeds
  the accumulators of every rank that holds them (they are alike on every
  rank of the batch axis).  ``stats`` then also holds ``ranks``, every
  rank's counts that are summed over the ranks, its ``wait_host_s``,
  ``gathered_bytes`` and the region kernels' launches
  (``fused_deterministic_sums_launches``, ``fused_region_sums_launches``;
  ``_merge_ranks``).
  """
  dev = mesh.device if mesh is not None else device_lib.resolve(device)
  cfg0 = next(iter(eval_configs.values()))
  for name, cfg in eval_configs.items():
    check_config(name, cfg, state is not None or checkpoint_path)
    if input_key(cfg) != input_key(cfg0):
      raise ValueError(
          "evaluate_streaming_multi requires configs with identical input "
          "construction (baselines/derived/against_analysis)")
  own_spans = spans is None
  if not isinstance(spans, tracing.Spans):
    spans = tracing.Spans(keep=own_spans and tracing.profiling())
  # this rank's counts summed over the ranks (each chunk's added as the
  # main thread takes it), and those it keeps alone
  run = tracing.Counts(lead_slices=0, lead_refill_s=0.0)
  own = tracing.Counts(chunks=0, wait_device_s=0.0, d2h_s=0.0,
                       finalize_s=0.0, finalize_device_bytes=0,
                       finalize_host_merges=0)
  launches0 = _launch_counts()
  with io_zarr.tally(run):
    plan = _Plan(forecast, truth, climatology, eval_configs, data_config,
                 input_chunks, skipna, dev, mesh, spans, state,
                 checkpoint_path, checkpoint_every)
    lead_results = []
    sliced = len(plan.lead_slices) > 1
    for lead_i, lead_sl in enumerate(plan.lead_slices):
      if lead_i < plan.state.lead_index:
        # finalized in an earlier run; carried whole inside the state
        lead_results.append(plan.state.completed_leads[lead_i])
        continue
      chunk_list = plan.chunk_list(lead_i)
      # a run of one slice keeps the span set it had
      with (plan.spans.span("wb2.lead_slice", lead=lead_i,
                            leads=lead_sl.stop - lead_sl.start,
                            chunks=len(chunk_list))
            if sliced else contextlib.nullcontext()):
        acc, per_time = _stream_lead_slice(plan, lead_i, lead_sl, chunk_list,
                                           lead_results, run, own)
        lead_results.append(_finalize(plan, acc, per_time, own))
  run.add({k: v - launches0[k] for k, v in _launch_counts().items()},
          generic_s=plan.generic_timer.settle(),
          gathered_bytes=plan.share.gathered_bytes)
  if stats is not None:
    _merge_ranks(stats, plan.share, run, own)
    if own_spans and spans.keep:
      stats.setdefault("spans", []).extend(spans.records)
  if not plan.share.lead:
    return None
  if len(lead_results) == 1:
    return lead_results[0]
  return {c: xds.concat([lr[c] for lr in lead_results], "lead_time")
          for c in eval_configs}

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
  * running (sum, count) accumulators stay on the device, and the temporal
    mean is ``sum / count`` at the end;
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
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.parallel.mesh import BATCH, SPATIAL
from weatherbench2_torch.xds import _xp
from weatherbench2_torch.xds import io_zarr

# Chunks prepared ahead of the one computing (each read, aligned and
# copied to the device by its own host thread; the engine is host-bound,
# and 4 threads beat 2 on the 8-core host of an H100 machine), and chunks
# whose device work may be queued before the host waits.  Device memory
# holds about PREFETCH_DEPTH + DEVICE_INFLIGHT chunks.
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

_UTIME = "__utime"


def _normalize_chunk_coords(ds: xds.Dataset, chunk_dim: str) -> xds.Dataset:
  """Replace chunk-dim coords by placeholders (the real labels come back
  from the forecast when per-time results are assembled)."""
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


def _normalize_any(obj, chunk_dim):
  if isinstance(obj, xds.Dataset):
    return _normalize_chunk_coords(obj, chunk_dim)
  if isinstance(obj, xds.DataArray):
    name = obj.name or "__da__"
    return _normalize_chunk_coords(obj.to_dataset(name=name),
                                   chunk_dim)[name]
  if isinstance(obj, dict):
    return {k: _normalize_any(v, chunk_dim) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(_normalize_any(v, chunk_dim) for v in obj)
  return obj


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


def batched_device_get(tree):
  """The tree with every tensor payload as numpy: the small leaves in ONE
  device-to-host copy per dtype (the accumulators hold hundreds of tiny
  leaves), the large ones each in a copy of its own."""
  host = {}
  by_dtype: dict = {}
  for t in _leaves(tree, []):
    if t.numel() * t.element_size() > PACKED_LEAF_BYTES:
      host[id(t)] = t.cpu().numpy()
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
    with open(path, "wb") as f:
      pickle.dump(
          {"version": 2, "sums": host[0], "counts": host[1],
           "chunk_index": self.chunk_index, "chunk_size": self.chunk_size,
           "total": self.total, "configs": host[2],
           "lead_index": self.lead_index,
           "n_lead_slices": self.n_lead_slices,
           "completed_leads": self.completed_leads}, f)

  @classmethod
  def load(cls, path: str) -> "StreamingState":
    with open(path, "rb") as f:
      d = pickle.load(f)
    return cls(sums=d["sums"], counts=d["counts"],
               chunk_index=d["chunk_index"],
               chunk_size=d.get("chunk_size"), total=d.get("total"),
               configs=d.get("configs"),
               lead_index=d.get("lead_index", 0),
               n_lead_slices=d.get("n_lead_slices"),
               completed_leads=d.get("completed_leads"))


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
    fvar = f_c.variables_dict()[v]
    tvar = t_c.variables_dict()[v]
    all_dims = xds.broadcast_dims_order(fvar.dims, tvar.dims)
    # spatial dims last, (lon, lat) order to match the weight matrix
    other = [d for d in all_dims if d not in ("longitude", "latitude")]
    all_dims = tuple(other) + ("longitude", "latitude")
    sizes = {**tvar.sizes, **fvar.sizes}
    f_b = fvar.broadcast_to_dims(all_dims, sizes).data
    t_b = tvar.broadcast_to_dims(all_dims, sizes).data
    other_shape = tuple(f_b.shape[:-2])
    b = int(np.prod(other_shape)) if other_shape else 1
    l = f_b.shape[-2] * f_b.shape[-1]
    if v in plan.get("infinite", ()):
      # the error's rows through kernel 2, which keeps each inf cell to the
      # regions that hold it
      d = (f_b.reshape(b, l) - t_b.reshape(b, l)).to(torch.float32)
      sums, wsum, nanw = _inf_safe_region_sums(
          torch.cat([d, d * d, d.abs()]), region_w, band_sum)
      sums = sums.reshape(n_regions, 3, b).permute(1, 0, 2)
      wsum, nanw = wsum[:, :b], nanw[:, :b]
    else:
      sums, wsum, nanw = band_sum(ops.fused_deterministic_sums(
          f_b.reshape(b, l), t_b.reshape(b, l), None, region_w))
    means = sums / wsum[None]
    if not skipna:
      means = torch.where(nanw[None] > 0, torch.nan, means)
    coords = {k: cv for k, cv in f_c.coords_dict().items()
              if set(cv.dims) <= set(other)}
    coords["region"] = region_coord
    for name, stat in plan["stat_of"].items():
      arr = (torch.sqrt(means[stat_idx["mse"]]) if stat == "rmse"
             else means[stat_idx[stat]])
      results[name][v] = xds.DataArray(
          xds.Variable(("region",) + tuple(other),
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
    fvar = f_c.variables_dict()[v]
    tvar = t_c.variables_dict()[v]
    all_dims = xds.broadcast_dims_order(
        tuple(d for d in fvar.dims if d != ens), tvar.dims)
    other = [d for d in all_dims if d not in ("longitude", "latitude")]
    all_dims = tuple(other) + ("longitude", "latitude")
    sizes = {**tvar.sizes, **fvar.sizes}
    f_b = fvar.broadcast_to_dims((ens,) + all_dims, sizes).data
    t_b = tvar.broadcast_to_dims(all_dims, sizes).data
    other_shape = tuple(f_b.shape[1:-2])
    b = int(np.prod(other_shape)) if other_shape else 1
    l = f_b.shape[-2] * f_b.shape[-1]
    fields = member_fields(f_b.reshape(f_b.shape[0], b, l),
                           t_b.reshape(b, l), field_names, skipna)
    stack = torch.stack([fields[k] for k in field_names])
    sums, wsum, nanw = _region_reducer(plan, [v])(
        stack.reshape(len(field_names) * b, l), region_w)
    means = sums / wsum
    if not skipna:
      means = torch.where(nanw > 0, torch.nan, means)
    means = means.reshape(n_regions, len(field_names), b)
    mean_of = {name: means[:, i].reshape((n_regions,) + other_shape)
               for i, name in enumerate(field_names)}
    coords = {k: cv for k, cv in f_c.coords_dict().items()
              if set(cv.dims) <= set(other)}
    coords["region"] = region_coord
    for name, stat in plan["stat_of"].items():
      arr = _PROB_RESULT.get(stat, lambda f, s=stat: f[s])(mean_of)
      results[name][v] = xds.DataArray(
          xds.Variable(("region",) + tuple(other), arr), coords=coords,
          name=v)
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


def _loop_over_regions(compute, regions):
  """One result per region, concatenated along ``region``; with
  ``{None: None}`` (a config without regions) the one result as it is."""
  region_results = []
  for region_name, region in regions.items():
    res = compute(region)
    if region_name is not None:
      res = res.expand_dims(region=np.asarray([region_name], dtype=object))
    region_results.append(res)
  if len(region_results) > 1 or None not in regions:
    return xds.concat(region_results, "region")
  return region_results[0]


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
  out = xds.Dataset({}, coords=dict(sum_ds.coords_dict()))
  for k in sum_ds.keys():
    s = np.asarray(sum_ds[k].values, dtype=np.float64)
    c = np.asarray(count_ds[k].values, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
      out[k] = xds.Variable(sum_ds[k].dims,
                            np.where(c > 0, s / np.maximum(c, 1), np.nan))
  return out


def _host_dataset(ds: xds.Dataset) -> xds.Dataset:
  """The dataset with every payload a numpy array on the host."""
  return ds.copy(data={k: _xp.to_numpy(v.data)
                       for k, v in ds.variables_dict().items()})


def _eval_host_metric(metric, f_chunk, t_chunk, regions, skipna, n_real,
                      chunk_dim, temporal_mean):
  """A ``supports_jit = False`` metric on the host's numpy chunk; its
  (sum, count) over the chunk's real entries, or the per-time result."""
  result = _loop_over_regions(
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
  if isinstance(obj, xds.Dataset):
    if "time" not in obj.sizes:
      return obj
    return xds.Dataset(
        {k: _rename_utime_var(v) for k, v in obj.variables_dict().items()},
        coords={k: v for k, v in obj.coords_dict().items()
                if "time" not in v.dims and k != "time"},
        attrs=obj.attrs)
  if isinstance(obj, xds.DataArray):
    if "time" not in obj.dims:
      return obj
    return xds.DataArray(
        _rename_utime_var(obj.variable),
        coords={k: v for k, v in obj.coords.items()
                if "time" not in v.dims and k != "time"},
        name=obj.name)
  if isinstance(obj, dict):
    return {k: _rename_utime(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(_rename_utime(v) for v in obj)
  return obj


def _expand_utime(obj, uinv):
  """Expand unique-time tensors to the chunk's (init, lead) layout with
  one gather on the device: the device half of the truth dedup."""
  if isinstance(obj, (xds.Dataset, xds.DataArray)):
    dims = obj.sizes if isinstance(obj, xds.Dataset) else obj.dims
    return obj.isel({_UTIME: uinv}) if _UTIME in dims else obj
  if isinstance(obj, dict):
    return {k: _expand_utime(v, uinv) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(_expand_utime(v, uinv) for v in obj)
  return obj


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
  same lead slices.  Normalizes a version-1 state to the ``configs`` form.
  """
  if state.configs is None and state.sums is not None:
    if len(eval_configs) > 1:
      raise ValueError(
          "legacy single-config checkpoint cannot resume a grouped "
          "multi-config run; delete the checkpoint or stream the config "
          "alone")
    state.configs = {next(iter(eval_configs)): (state.sums, state.counts)}
  resume_lead = int(state.lead_index or 0)
  resume_chunk = int(state.chunk_index or 0)
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

    def write():
      ctx = (torch.cuda.stream(self.stream) if self.stream is not None
             else contextlib.nullcontext())
      with ctx:
        if ready is not None:
          self.stream.wait_event(ready)
        snap.sums, snap.counts, snap.configs = batched_device_get(
            (snap.sums, snap.counts, snap.configs))
      tmp = self.path + ".tmp"
      snap.save(tmp)
      os.replace(tmp, self.path)

    self.wait()  # at most one save in flight
    self.pending.append(self.pool.submit(write))

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
    if isinstance(obj, (xds.Dataset, xds.DataArray)):
      if obj.sizes.get("latitude") == n_lat:
        return obj.isel(latitude=self.band)
      return obj
    if isinstance(obj, dict):
      return {k: self.to_band(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
      return type(obj)(self.to_band(v) for v in obj)
    return obj

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
    if isinstance(tree, xds.Dataset):
      return xds.Dataset(
          {k: xds.Variable(v.dims, self._gather_payload(v), v.attrs)
           for k, v in tree.variables_dict().items()},
          coords=self._whole_coords(tree.coords_dict()), attrs=tree.attrs)
    if isinstance(tree, xds.DataArray):
      v = tree.variable
      return xds.DataArray(
          xds.Variable(v.dims, self._gather_payload(v), v.attrs),
          coords=self._whole_coords(tree.coords), name=tree.name)
    if isinstance(tree, dict):
      return {k: self.gather_bands(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
      return type(tree)(self.gather_bands(v) for v in tree)
    return tree

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
) -> Optional[dict]:
  """Stream chunks ONCE through the metric programs of several configs.

  All configs must build their inputs identically (``evaluate_with_mesh``
  groups them).  Returns {config_name: results dataset}.  ``stats``, when
  given, receives the run's counts: chunks, h2d bytes, bytes read, and
  seconds the main thread waited for host preparation and for the device
  (the final copy of the accumulators to the host included), and seconds
  spent on the host turning the accumulators into results
  (``finalize_s``).  ``state`` resumes a run; with ``checkpoint_path`` and
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
  rank of the batch axis).
  ``stats`` then also holds ``ranks``, every rank's ``h2d_bytes``,
  ``read_bytes``, ``wait_host_s``, ``gathered_bytes`` and the region
  kernels' launches (``fused_deterministic_sums_launches``,
  ``fused_region_sums_launches``); its ``h2d_bytes`` and ``read_bytes``
  are their sums, ``wait_host_s`` the largest.
  """
  dev = mesh.device if mesh is not None else device_lib.resolve(device)
  cfg0 = next(iter(eval_configs.values()))
  for cfg in eval_configs.values():
    cfg.validate()
    if input_key(cfg) != input_key(cfg0):
      raise ValueError(
          "evaluate_streaming_multi requires configs with identical input "
          "construction (baselines/derived/against_analysis)")
    for metric in cfg.metrics.values():
      if not isinstance(metric, metrics_lib.Metric):
        raise TypeError(
            f"{type(metric).__module__}.{type(metric).__name__} is not a "
            "port metric; convert reference configs with "
            "convert.eval_configs_from_reference")
  if state is not None or checkpoint_path:
    # per-time results live in a host-side list, not in the state: a
    # resumed run would drop the rows of every chunk already done
    for cname, cfg in eval_configs.items():
      if not cfg.temporal_mean:
        raise ValueError(
            "checkpoint/resume requires temporal_mean=True (config "
            f"{cname!r} emits per-time results, which the accumulator "
            "state does not capture)")
  transfer_dtype = _transfer_dtype()
  reads0, launches0 = io_zarr.READS.bytes, _launch_counts()
  share = _RankShare(mesh, forecast.coords_dict().get("latitude"))

  by_init = data_config.by_init
  chunk_dim = "init_time" if by_init else "time"
  total = forecast.sizes[chunk_dim]
  if chunk_dim in input_chunks:
    chunk_size = int(input_chunks[chunk_dim])
  else:
    companions = 2
    if climatology is not None and sum(
        4 * v.size for v in climatology.variables_dict().values()
    ) > metrics_lib.clim_device_budget():
      companions = 2.5  # the climatology gathers per chunk on the host
    chunk_size = _auto_chunk_size(forecast, chunk_dim, share.batch,
                                  companions)
  if chunk_size < 1:
    raise ValueError(f"chunk size must be positive, got {chunk_size}")
  # every rank takes an equal share of each chunk (the padded last one too)
  chunk_size = -(-chunk_size // share.batch) * share.batch
  lead_chunk = int(input_chunks.get("lead_time", 0)) or None
  lead_slices = (list(_chunk_slices(forecast.sizes["lead_time"], lead_chunk))
                 if lead_chunk and "lead_time" in forecast.sizes
                 else [slice(None)])
  # derived variables whose core dims hold the lead axis (precipitation
  # accumulations) need the whole axis in every chunk, and a truth with it
  lead_core = [name for name, dv in cfg0.derived_variables.items()
               if {"lead_time", "prediction_timedelta"}
               & dv.all_input_core_dims]
  if lead_core and len(lead_slices) > 1:
    raise ValueError(
        f"derived variable {lead_core[0]!r} requires the full lead_time "
        "axis per chunk; remove lead_time from input_chunks or drop the "
        "derived variable")
  infinite = {name for name, dv in cfg0.derived_variables.items()
              if dv.may_be_infinite}
  derived_bases = {base for dv in cfg0.derived_variables.values()
                   for base in dv.base_variables}

  device_metrics_by = {
      c: {k: m for k, m in cfg.metrics.items() if m.supports_jit}
      for c, cfg in eval_configs.items()}
  host_metrics_by = {
      c: {k: m for k, m in cfg.metrics.items() if not m.supports_jit}
      for c, cfg in eval_configs.items()}
  any_host = any(host_metrics_by.values())
  regions_by = {c: (cfg.regions or {None: None})
                for c, cfg in eval_configs.items()}
  any_temporal = any(cfg.temporal_mean for cfg in eval_configs.values())
  # host metrics need a chunk-shaped truth on the host, and the lead-core
  # derived variables a truth with the lead axis: no dedup then
  truth_dedup = (by_init and not any_host and not lead_core
                 and "time" in truth.sizes and _UTIME not in truth.sizes)
  # a rank reads its latitude band, unless a derived variable differences
  # or integrates over latitude: then it reads the whole axis and keeps its
  # band of the derived fields
  whole_forecast = forecast
  band_after_derive = share.band is not None and any(
      "latitude" in dv.all_input_core_dims
      for dv in cfg0.derived_variables.values())
  if not band_after_derive:
    forecast, truth, climatology = share.to_band(
        (forecast, truth, climatology))
  prob_clim = (evaluation.probabilistic_climatology(truth, cfg0)
               if cfg0.evaluate_probabilistic_climatology else None)
  # the members of the probabilistic climatology are the forecast's
  members_like = (
      whole_forecast.assign_coords(number=np.arange(prob_clim.size))
      if prob_clim is not None and "number" not in whole_forecast.sizes
      else whole_forecast)
  plans_by = {}
  for cname in eval_configs:
    # the region weights of the whole grid, cut to the band: the latitude
    # weights stay normalized over the whole grid
    *plans, generic = _partition_fused(device_metrics_by[cname],
                                       regions_by[cname], members_like)
    for plan in plans:
      if plan is not None:
        region_w = plan["region_w"]
        if share.band is not None:
          n_lat = share.latitude.shape[0]
          region_w = np.ascontiguousarray(region_w.reshape(
              region_w.shape[0], -1, n_lat)[:, :, share.band].reshape(
                  region_w.shape[0], -1))
        plan["region_w_dev"] = torch.as_tensor(region_w, device=dev)
        plan["infinite"] = infinite
        plan["band_sum"] = share.band_sum
    plans_by[cname] = (*plans, generic)

  def chunk_program(cname, f_c, t_c, prepared, time_mask, uinv):
    """Every device metric × region of one config on one chunk, reduced
    over the chunk dim (or per time with temporal_mean=False)."""
    det_plan, prob_plan, pw_plan, generic = plans_by[cname]
    metrics = device_metrics_by[cname]
    if truth_dedup:
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
      f_c, t_c, prepared = share.gather_bands((f_c, t_c, prepared))
      if not share.owner:
        generic_names = []
    for name in generic_names:
      results[name] = _loop_over_regions(
          lambda region, name=name: metrics[name].compute_chunk_prepared(
              f_c, t_c, prepared[name], region=region, skipna=skipna),
          regions_by[cname])
    metrics_lib.clear_caches()  # the CRPS spread of this chunk
    if not eval_configs[cname].temporal_mean:
      return results, dict.fromkeys(results)
    sums, counts = {}, {}
    for name, result in results.items():
      sums[name], counts[name] = _masked_sum_count(result, chunk_dim,
                                                   time_mask, skipna)
    return sums, counts

  copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

  def prepare_one(ci, sl, lead_sl):
    """Host work for this rank's share of one chunk (slice, align, prepare,
    pad) and its transfer; the share is read and moved once for all
    configs.  Derived variables and the probabilistic climatology's members
    are made on the device after the copy, before the metrics prepare the
    chunk."""
    f_chunk = forecast.isel({chunk_dim: sl})
    if lead_sl != slice(None):
      f_chunk = f_chunk.isel(lead_time=lead_sl)
    n_real = f_chunk.sizes[chunk_dim]
    padded = (chunk_size if any_temporal
              else -(-n_real // share.batch) * share.batch)
    f_chunk = _pad_chunk(f_chunk, chunk_dim, padded)
    rows = share.rows(padded)
    if rows != slice(0, padded):
      f_chunk = f_chunk.isel({chunk_dim: rows})
    time_mask = (np.arange(rows.start, rows.stop) < n_real).astype(np.float64)
    uinv = None
    uniq = None
    if truth_dedup:
      # the valid-time-aligned truth repeats each time in ~every lead
      # slot: ship each unique time once, expand on the device
      vt = np.asarray(f_chunk["valid_time"].data)
      uniq, inv = np.unique(vt.ravel(), return_inverse=True)
      n_pad = -(-len(uniq) // UTIME_BUCKET) * UTIME_BUCKET
      uniq = np.concatenate([uniq, np.repeat(uniq[-1:], n_pad - len(uniq))])
      uinv = xds.DataArray(inv.reshape(vt.shape).astype(np.int64),
                           dims=f_chunk["valid_time"].dims)
    counter = {"h2d_bytes": 0}
    ctx = (torch.cuda.stream(copy_stream) if copy_stream is not None
           else contextlib.nullcontext())
    with ctx:
      f_chunk, t_chunk, members = _make_truth_chunk(
          f_chunk, truth, climatology, cfg0, data_config, uniq, prob_clim)
      if members is not None or cfg0.derived_variables:
        # derived variables come from their base fields at full precision,
        # as the JAX package derives on the host before its bfloat16 cast;
        # those fields and the derived ones are rounded after the derivation
        # (host metrics read every field at full precision, and the fields
        # cross again below)
        f_chunk, t_chunk = xds.to_device(
            (f_chunk, t_chunk), dev, copy_stream, counter,
            None if any_host else transfer_dtype,
            full_precision=derived_bases)
        if members is not None:
          f_chunk = f_chunk.isel({utils.MEMBER_PAIR: members})
        f_chunk, t_chunk = evaluation.add_derived_variables(f_chunk, t_chunk,
                                                            cfg0)
        if band_after_derive:
          f_chunk, t_chunk = share.to_band((f_chunk, t_chunk))
        if transfer_dtype is not None and not any_host:
          f_chunk, t_chunk = xds.round_to_bfloat16((f_chunk, t_chunk))
      host_chunks = None
      if any_host:
        f_chunk, t_chunk = _host_dataset(f_chunk), _host_dataset(t_chunk)
        host_chunks = (f_chunk, t_chunk)
      prepared = {
          c: {name: m.prepare_chunk(f_chunk, t_chunk, device=dev)
              for name, m in device_metrics_by[c].items()}
          for c in eval_configs
      }
      # climatology gathers span the whole grid: cut them to the band
      prepared = share.to_band(prepared)
      if truth_dedup:
        t_chunk = _rename_utime(t_chunk)
        prepared = _rename_utime(prepared)
      moved = xds.to_device(
          _normalize_any((f_chunk, t_chunk, prepared, uinv), chunk_dim),
          dev, copy_stream, counter, transfer_dtype)
      mask_dev = torch.as_tensor(time_mask).to(dev, non_blocking=True)
      event = None
      if copy_stream is not None:
        event = torch.cuda.Event()
        event.record(copy_stream)
    return (ci, n_real, sl, rows, moved, mask_dev, event,
            counter["h2d_bytes"], host_chunks)

  if state is None:
    state = StreamingState()
  _check_resume(state, eval_configs, chunk_size, total, len(lead_slices))
  resume_lead = int(state.lead_index or 0)
  resume_chunk = int(state.chunk_index or 0)
  resume_configs = state.configs
  share.agree((resume_lead, resume_chunk, resume_configs is not None),
              "a state at (lead slice, chunk, accumulators)")
  lead_results = []
  wait_host = wait_device = finalize = 0.0
  h2d_bytes = n_chunks_run = 0
  from weatherbench2_torch.evaluation import merge_metric_results

  for lead_i, lead_sl in enumerate(lead_slices):
    if lead_i < resume_lead:
      # finalized in an earlier run; carried whole inside the state
      lead_results.append(state.completed_leads[lead_i])
      continue
    resuming = lead_i == resume_lead and resume_configs is not None
    sums_acc = {c: None for c in eval_configs}
    counts_acc = {c: None for c in eval_configs}
    if resuming and share.owner:
      sums_acc = {c: _tree_to_device(resume_configs[c][0], dev)
                  for c in eval_configs}
      counts_acc = {c: _tree_to_device(resume_configs[c][1], dev)
                    for c in eval_configs}
    # a state saved in another variable order is aligned to this run's
    # chunk program at the first merge
    needs_align = {c: resuming for c in eval_configs}
    per_time = {c: [] for c in eval_configs}
    chunk_list = [(ci, sl)
                  for ci, sl in enumerate(_chunk_slices(total, chunk_size))
                  if not (lead_i == resume_lead and ci < resume_chunk)]
    n_chunks_run += len(chunk_list)
    inflight: list = []
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=PREFETCH_DEPTH)
    snapshots = (_Snapshots(checkpoint_path, dev)
                 if checkpoint_path and checkpoint_every and share.lead
                 else None)
    try:
      pending = [pool.submit(prepare_one, ci, sl, lead_sl)
                 for ci, sl in chunk_list[:PREFETCH_DEPTH]]
      for idx in range(len(chunk_list)):
        t0 = time.perf_counter()
        (ci, n_real, sl, rows, moved, mask_dev, event, nbytes,
         host_chunks) = pending.pop(0).result()
        wait_host += time.perf_counter() - t0
        h2d_bytes += nbytes
        if idx + PREFETCH_DEPTH < len(chunk_list):
          pending.append(pool.submit(
              prepare_one, *chunk_list[idx + PREFETCH_DEPTH], lead_sl))
        if event is not None:
          compute_stream = torch.cuda.current_stream(dev)
          compute_stream.wait_event(event)
          # the copies were allocated on the side stream: keep their memory
          # from being reused while this stream still reads it
          for t in _leaves((moved, mask_dev), []):
            t.record_stream(compute_stream)
        f_dev, t_dev, p_dev, u_dev = moved
        if any_host and share.band is not None:
          host_chunks = tuple(_host_dataset(ds) for ds in
                              share.gather_bands((f_dev, t_dev)))
        # this rank's real rows, for per-time results
        real = np.arange(max(0, min(rows.stop, n_real) - rows.start))
        chunk_sums = {}
        for cname, cfg in eval_configs.items():
          sums, counts = chunk_program(cname, f_dev, t_dev, p_dev[cname],
                                       mask_dev, u_dev)
          if not share.owner:
            continue  # the owner of this band's results adds them
          for name, metric in host_metrics_by[cname].items():
            sums[name], counts[name] = _eval_host_metric(
                metric, *host_chunks, regions_by[cname], skipna, len(real),
                chunk_dim, cfg.temporal_mean)
          if cfg.temporal_mean:
            chunk_sums[cname] = (sums, counts)
            continue
          coord = np.asarray(forecast.coords_dict()[chunk_dim].data)[sl]
          if len(real):
            for name, res in sums.items():
              res = res.isel({chunk_dim: real})
              per_time[cname].append((name, ci, share.b, res.assign_coords(
                  {chunk_dim: coord[rows.start:rows.start + len(real)]})))
        for cname, (sums, counts) in share.sum_over_batch(
            chunk_sums, dev).items():
          if sums_acc[cname] is None:
            sums_acc[cname], counts_acc[cname] = sums, counts
          else:
            if needs_align[cname]:
              sums_acc[cname] = _reorder_like(sums, sums_acc[cname])
              counts_acc[cname] = _reorder_like(counts, counts_acc[cname])
              needs_align[cname] = False
            sums_acc[cname] = _tree_add(sums_acc[cname], sums)
            counts_acc[cname] = _tree_add(counts_acc[cname], counts)
        if dev.type == "cuda":
          # bound the queue: before moving past chunk n, wait for chunk
          # n-DEVICE_INFLIGHT to finish so its buffers free
          done = torch.cuda.Event()
          done.record(torch.cuda.current_stream(dev))
          inflight.append(done)
          if len(inflight) > DEVICE_INFLIGHT:
            t0 = time.perf_counter()
            inflight.pop(0).synchronize()
            wait_device += time.perf_counter() - t0
        if snapshots is not None and (ci + 1) % checkpoint_every == 0:
          only = next(iter(eval_configs))
          single = len(eval_configs) == 1
          snapshots.submit(StreamingState(
              # version-1 fields kept for single-config readers
              sums_acc[only] if single else None,
              counts_acc[only] if single else None,
              ci + 1, chunk_size=chunk_size, total=total,
              configs={c: (sums_acc[c], counts_acc[c]) for c in eval_configs},
              lead_index=lead_i, n_lead_slices=len(lead_slices),
              completed_leads=list(lead_results)))
    finally:
      pool.shutdown(wait=True, cancel_futures=True)
      if snapshots is not None:
        snapshots.close()

    if not share.owner:
      lead_results.append(None)
      continue
    t0 = time.perf_counter()
    sums_acc, counts_acc, per_time = batched_device_get(
        (sums_acc, counts_acc, per_time))
    per_time = {c: share.gather_rows(per_time[c]) for c in eval_configs}
    t1 = time.perf_counter()
    wait_device += t1 - t0
    if not share.lead:
      lead_results.append(None)
      continue
    per_config = {}
    for cname, cfg in eval_configs.items():
      per_metric = []
      if cfg.temporal_mean:
        for name in cfg.metrics:
          mean_ds = _finalize_mean(sums_acc[cname][name],
                                   counts_acc[cname][name])
          per_metric.append(mean_ds.expand_dims(
              metric=np.asarray([name], dtype=object)))
      else:
        by_metric: dict = {}
        for name, ci, b, res in per_time[cname]:
          by_metric.setdefault(name, []).append(((ci, b), res))
        for name in cfg.metrics:
          items = sorted(by_metric[name], key=lambda item: item[0])
          cat = xds.concat([r for _, r in items], chunk_dim)
          per_metric.append(cat.expand_dims(
              metric=np.asarray([name], dtype=object)))
      per_config[cname] = merge_metric_results(per_metric)
    lead_results.append(per_config)
    finalize += time.perf_counter() - t1

  if stats is not None:
    mine = {"h2d_bytes": h2d_bytes,
            "read_bytes": io_zarr.READS.bytes - reads0,
            "wait_host_s": wait_host, "gathered_bytes": share.gathered_bytes,
            **{k: v - launches0[k] for k, v in _launch_counts().items()}}
    ranks = share.all_stats(mine)
    stats["chunks"] = stats.get("chunks", 0) + n_chunks_run
    stats["wait_device_s"] = stats.get("wait_device_s", 0.0) + wait_device
    stats["finalize_s"] = stats.get("finalize_s", 0.0) + finalize
    for key in ("h2d_bytes", "read_bytes"):
      stats[key] = stats.get(key, 0) + sum(r[key] for r in ranks)
    stats["wait_host_s"] = stats.get("wait_host_s", 0.0) + max(
        r["wait_host_s"] for r in ranks)
    if mesh is not None:
      before = stats.get("ranks") or [dict.fromkeys(mine, 0)] * len(ranks)
      stats["ranks"] = [{k: a[k] + r[k] for k in mine}
                        for a, r in zip(before, ranks)]
  if not share.lead:
    return None
  if len(lead_results) == 1:
    return lead_results[0]
  return {c: xds.concat([lr[c] for lr in lead_results], "lead_time")
          for c in eval_configs}

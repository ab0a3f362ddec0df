"""Streaming evaluation engine on one device.

Counterpart of ``weatherbench2_tpu/parallel/streaming.py``:

  * the (init_)time axis is processed in chunks; a pool of prefetch
    threads reads, aligns and prepares the next chunks on the host and
    copies them to the card through pinned memory on a side stream while
    the current chunk computes;
  * per chunk, every metric × region of a config runs in two fused tiers:
    MSE/RMSE/MAE/Bias through one ``ops.fused_deterministic_sums`` launch
    per variable, and ACC (and any other pointwise-fused metric) through
    ``ops.fused_region_sums`` over row groups of its per-cell fields;
  * running (sum, count) accumulators stay on the device, and the temporal
    mean is ``sum / count`` at the end;
  * by-init truth is deduplicated to the chunk's unique valid times on the
    host and expanded on the device with one gather.

Not ported yet, and refused with an error that names the ROADMAP item:
the probabilistic plan, checkpoint/resume, lead_time input chunks,
meshes, host (unfused) metrics and the bfloat16 transfer mode.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import os
import time
from typing import Any, Mapping, Optional

import numpy as np
import torch

from weatherbench2_torch import device as device_lib
from weatherbench2_torch import metrics as metrics_lib
from weatherbench2_torch import ops
from weatherbench2_torch import xds
from weatherbench2_torch.xds import _xp

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
  """The tree with every tensor payload as numpy, in ONE device-to-host
  copy per dtype (the accumulators hold hundreds of tiny leaves)."""
  leaves = _leaves(tree, [])
  host = {}
  by_dtype: dict = {}
  for t in leaves:
    by_dtype.setdefault(t.dtype, []).append(t)
  for group in by_dtype.values():
    flat = torch.cat([t.reshape(-1) for t in group]).cpu().numpy()
    off = 0
    for t in group:
      host[id(t)] = flat[off:off + t.numel()].reshape(tuple(t.shape))
      off += t.numel()
  return _replace_leaves(tree, lambda t: host[id(t)])


def _tree_add(a, b):
  """Elementwise a + b over matching trees of Datasets (None passes)."""
  if a is None:
    return None
  if isinstance(a, dict):
    return {k: _tree_add(a[k], b[k]) for k in a}
  return a.copy(data={k: v.data + b.variables_dict()[k].data
                      for k, v in a.variables_dict().items()})


def _region_weight_setup(regions, forecast):
  """(region_names, region_w) for the fused kernels, or None when the
  regions or grid do not map to static (latitude, longitude) masks."""
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
  masks = [r.mask_weights(lat, lon) for r in regions.values()]
  region_w = ops.make_region_weight_matrix(w, masks, len(lon))
  return np.asarray(list(regions.keys()), dtype=object), region_w


def _det_stat_of(metric):
  """Stat name in the fused deterministic kernel, or None.

  ACC is deliberately NOT routed here: the kernel shares one NaN mask
  (isnan(f)|isnan(t)|isnan(clim)) across all stats, which would let
  climatology NaNs poison MSE/Bias/MAE and allows one climatology per
  plan. ACC rides the pointwise tier, where each of its three anomaly
  products carries its own per-cell NaN accounting.
  """
  return {
      metrics_lib.MSE: "mse",
      metrics_lib.Bias: "bias",
      metrics_lib.MAE: "mae",
      metrics_lib.RMSESqrtBeforeTimeAvg: "rmse",
  }.get(type(metric))


def _partition_fused(metrics, regions, forecast):
  """(det_plan, pointwise_plan) covering every metric of a config.

  The deterministic kernel takes MSE/RMSE/MAE/Bias; metrics implementing
  the pointwise-fused protocol (ACC) go to the generic region kernel.
  Anything else needs the unfused per-region loop, not ported yet.
  """
  if regions is None:
    raise NotImplementedError(
        "configs without regions need the unfused per-region metric loop, "
        "not ported yet (ROADMAP A.5)")
  setup = _region_weight_setup(regions, forecast)
  if setup is None:
    raise NotImplementedError(
        "the fused tiers need every variable on a (latitude, longitude) "
        "grid; the unfused per-region loop is not ported yet (ROADMAP A.5)")
  region_names, region_w = setup
  det = {n: _det_stat_of(m) for n, m in metrics.items() if _det_stat_of(m)}
  pointwise = [n for n, m in metrics.items()
               if n not in det and m.supports_pointwise_fused]
  rest = [n for n in metrics if n not in det and n not in pointwise]
  if rest:
    raise NotImplementedError(
        f"metrics {rest} ({[type(metrics[n]).__name__ for n in rest]}) have "
        "no fused tier in the port yet (ROADMAP A.5/A.8)")
  base = {"region_names": region_names, "region_w": region_w}
  det_plan = {**base, "stat_of": det} if det else None
  pw_plan = {**base, "names": pointwise} if pointwise else None
  return det_plan, pw_plan


def _fused_chunk_results(plan, f_c, t_c, skipna):
  """Per-time MSE/RMSE/MAE/Bias values of every region, dims (region, ...).

  The plan carries no climatology (ACC is in the pointwise tier), so the
  kernel computes the climatology statistics against zeros and reads only
  forecast and truth.
  """
  stat_idx = {"bias": 0, "mse": 1, "mae": 2}
  region_w = plan["region_w_dev"]
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
    sums, wsum, nanw = ops.fused_deterministic_sums(
        f_b.reshape(b, l), t_b.reshape(b, l), None, region_w)
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
  row axis.
  """
  region_w = plan["region_w_dev"]
  n_regions = region_w.shape[0]
  region_coord = xds.Variable(("region",), plan["region_names"])
  group_cap = fused_group_bytes()
  results = {}
  for mname in plan["names"]:
    metric = metrics[mname]
    fields = metric.pointwise_chunk(f_c, t_c, prepared[mname], skipna)
    if fields is None or not len(fields) or any(
        "latitude" not in v.dims or "longitude" not in v.dims
        for v in fields.variables_dict().values()):
      raise NotImplementedError(
          f"metric {mname!r} declined the pointwise tier; the unfused "
          "per-region loop is not ported yet (ROADMAP A.5)")
    rows, entries = [], []
    for vname, v in fields.variables_dict().items():
      other = tuple(d for d in v.dims if d not in ("longitude", "latitude"))
      vv = v.transpose(*(other + ("longitude", "latitude")))
      other_shape = tuple(vv.shape[:-2])
      b = int(np.prod(other_shape)) if other_shape else 1
      rows.append(vv.data.reshape(b, vv.shape[-2] * vv.shape[-1]))
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
    parts = [ops.fused_region_sums(
        g[0] if len(g) == 1 else _xp.namespace(*g).concatenate(g, axis=0),
        region_w) for g in groups]
    sums, wsum, nanw = (torch.cat([p[i] for p in parts], dim=-1)
                        for i in range(3))
    means_all = sums / wsum
    if not skipna:
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
  return results


def _masked_sum_count(result, dim, mask, skipna):
  """(sum, count) of a per-time result over the chunk dim, padded entries
  masked out; sums accumulate in float64."""
  sum_ds = xds.Dataset({}, coords={
      k: v for k, v in result.coords_dict().items() if dim not in v.dims})
  cnt_ds = xds.Dataset({}, coords=dict(sum_ds.coords_dict()))
  for vname in result.keys():
    da = result[vname]
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


def _chunk_slices(total: int, size: int):
  for start in range(0, total, size):
    yield slice(start, min(start + size, total))


def _auto_chunk_size(forecast, chunk_dim: str, companions: float = 2) -> int:
  """A chunk size targeting DEFAULT_CHUNK_BYTES of forecast per chunk,
  scaled down when a per-chunk climatology rides along (companions > 2)."""
  budget = DEFAULT_CHUNK_BYTES * 2.0 / max(companions, 2)
  total = forecast.sizes[chunk_dim]
  per_entry = 0
  for v in forecast.variables_dict().values():
    if chunk_dim in v.dims:
      per_entry += v.size // v.sizes[chunk_dim] * np.dtype(v.dtype).itemsize
  if per_entry <= 0:
    return total
  return min(total, max(1, int(budget // per_entry)))


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


def _make_truth_chunk(f_chunk, truth, by_init, unique_times=None):
  """Truth aligned to the forecast chunk: its compact unique-time
  selection under the dedup, else valid-time (or time) aligned."""
  if unique_times is not None:
    return truth.sel(time=unique_times)
  if by_init:
    return truth.sel(time=f_chunk["valid_time"])
  return truth.sel(time=f_chunk.coords_dict()["time"].data)


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
) -> dict:
  """Stream chunks ONCE through the fused tiers of several eval configs.

  All configs must build their inputs identically (``evaluate_with_mesh``
  groups them).  Returns {config_name: results dataset}.  ``stats``, when
  given, receives the run's counts: chunks, h2d bytes, and seconds the
  main thread waited for host preparation and for the device.
  """
  dev = device_lib.resolve(device)
  cfg0 = next(iter(eval_configs.values()))
  for cfg in eval_configs.values():
    cfg.validate()
    if cfg.against_analysis != cfg0.against_analysis:
      raise ValueError("evaluate_streaming_multi requires configs with "
                       "identical input construction")
    for metric in cfg.metrics.values():
      if not isinstance(metric, metrics_lib.Metric):
        raise TypeError(
            f"{type(metric).__module__}.{type(metric).__name__} is not a "
            "port metric; convert reference configs with "
            "convert.eval_configs_from_reference")
  if "lead_time" in input_chunks:
    raise NotImplementedError(
        "lead_time input chunks are not ported yet (ROADMAP A.6)")
  if os.environ.get("WB2_TRANSFER_DTYPE", "") == "bfloat16":
    raise NotImplementedError(
        "the bfloat16 transfer mode (WB2_TRANSFER_DTYPE) is not ported yet "
        "(ROADMAP A.6)")

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
    chunk_size = _auto_chunk_size(forecast, chunk_dim, companions)
  if chunk_size < 1:
    raise ValueError(f"chunk size must be positive, got {chunk_size}")

  any_temporal = any(cfg.temporal_mean for cfg in eval_configs.values())
  truth_dedup = by_init and "time" in truth.sizes and (
      _UTIME not in truth.sizes)
  plans_by = {}
  for cname, cfg in eval_configs.items():
    det_plan, pw_plan = _partition_fused(cfg.metrics, cfg.regions, forecast)
    for plan in (det_plan, pw_plan):
      if plan is not None:
        plan["region_w_dev"] = torch.as_tensor(plan["region_w"], device=dev)
    plans_by[cname] = (det_plan, pw_plan)

  def chunk_program(cname, f_c, t_c, prepared, time_mask, uinv):
    """Every metric × region of one config on one chunk, reduced over
    the chunk dim (or per time with temporal_mean=False)."""
    det_plan, pw_plan = plans_by[cname]
    if truth_dedup:
      t_c = _expand_utime(t_c, uinv)
      prepared = _expand_utime(prepared, uinv)
    results = {}
    if det_plan is not None:
      results.update(_fused_chunk_results(det_plan, f_c, t_c, skipna))
    if pw_plan is not None:
      results.update(_pointwise_chunk_results(
          pw_plan, eval_configs[cname].metrics, f_c, t_c, prepared, skipna))
    if not eval_configs[cname].temporal_mean:
      return results, None
    sums, counts = {}, {}
    for name, result in results.items():
      sums[name], counts[name] = _masked_sum_count(result, chunk_dim,
                                                   time_mask, skipna)
    return sums, counts

  copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

  def prepare_one(ci, sl):
    """Host work for one chunk (slice, align, prepare, pad) and its
    transfer; the chunk is read and moved once for all configs."""
    f_chunk = forecast.isel({chunk_dim: sl})
    n_real = f_chunk.sizes[chunk_dim]
    f_chunk = _pad_chunk(f_chunk, chunk_dim,
                         chunk_size if any_temporal else n_real)
    time_mask = np.zeros(f_chunk.sizes[chunk_dim], dtype=np.float64)
    time_mask[:n_real] = 1.0
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
      t_chunk = _make_truth_chunk(f_chunk, truth, by_init, uniq)
      prepared = {
          c: {name: m.prepare_chunk(f_chunk, t_chunk, device=dev)
              for name, m in eval_configs[c].metrics.items()}
          for c in eval_configs
      }
      if truth_dedup:
        t_chunk = _rename_utime(t_chunk)
        prepared = _rename_utime(prepared)
      moved = xds.to_device(
          _normalize_any((f_chunk, t_chunk, prepared, uinv), chunk_dim),
          dev, copy_stream, counter)
      mask_dev = torch.as_tensor(time_mask).to(dev, non_blocking=True)
      event = None
      if copy_stream is not None:
        event = torch.cuda.Event()
        event.record(copy_stream)
    return ci, n_real, sl, moved, mask_dev, event, counter["h2d_bytes"]

  per_time = {c: [] for c in eval_configs}
  sums_acc = {c: None for c in eval_configs}
  counts_acc = {c: None for c in eval_configs}
  chunk_list = list(enumerate(_chunk_slices(total, chunk_size)))
  wait_host = wait_device = 0.0
  h2d_bytes = 0
  inflight: list = []
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=PREFETCH_DEPTH)
  try:
    pending = [pool.submit(prepare_one, ci, sl)
               for ci, sl in chunk_list[:PREFETCH_DEPTH]]
    for idx in range(len(chunk_list)):
      t0 = time.perf_counter()
      ci, n_real, sl, moved, mask_dev, event, nbytes = pending.pop(0).result()
      wait_host += time.perf_counter() - t0
      h2d_bytes += nbytes
      if idx + PREFETCH_DEPTH < len(chunk_list):
        pending.append(pool.submit(prepare_one,
                                   *chunk_list[idx + PREFETCH_DEPTH]))
      if event is not None:
        compute_stream = torch.cuda.current_stream(dev)
        compute_stream.wait_event(event)
        # the copies were allocated on the side stream: keep their memory
        # from being reused while this stream still reads it
        for t in _leaves((moved, mask_dev), []):
          t.record_stream(compute_stream)
      f_dev, t_dev, p_dev, u_dev = moved
      for cname, cfg in eval_configs.items():
        sums, counts = chunk_program(cname, f_dev, t_dev, p_dev[cname],
                                     mask_dev, u_dev)
        if not cfg.temporal_mean:
          coord = np.asarray(forecast.coords_dict()[chunk_dim].data)[sl]
          for name, res in sums.items():
            res = res.isel({chunk_dim: np.arange(n_real)})
            per_time[cname].append(
                (name, ci, res.assign_coords({chunk_dim: coord})))
        elif sums_acc[cname] is None:
          sums_acc[cname], counts_acc[cname] = sums, counts
        else:
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
  finally:
    pool.shutdown(wait=True, cancel_futures=True)

  t0 = time.perf_counter()
  sums_acc, counts_acc, per_time = batched_device_get(
      (sums_acc, counts_acc, per_time))
  wait_device += time.perf_counter() - t0
  if stats is not None:
    stats["chunks"] = stats.get("chunks", 0) + len(chunk_list)
    stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + h2d_bytes
    stats["wait_host_s"] = stats.get("wait_host_s", 0.0) + wait_host
    stats["wait_device_s"] = stats.get("wait_device_s", 0.0) + wait_device

  from weatherbench2_torch.evaluation import merge_metric_results

  out = {}
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
      for name, ci, res in per_time[cname]:
        by_metric.setdefault(name, []).append((ci, res))
      for name in cfg.metrics:
        items = sorted(by_metric[name], key=lambda item: item[0])
        cat = xds.concat([r for _, r in items], chunk_dim)
        per_metric.append(cat.expand_dims(
            metric=np.asarray([name], dtype=object)))
    out[cname] = merge_metric_results(per_metric)
  return out

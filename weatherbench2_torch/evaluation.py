"""Evaluation entry points of the port: open data, evaluate, save results.

Counterpart of ``weatherbench2_tpu/evaluation.py``:
``evaluate_with_mesh`` streams chunks of (init_)time to the card, or to
every rank of a ``parallel.mesh.Mesh``, where every metric × region runs
in the tiers of ``parallel/streaming.py``, with checkpoint/resume;
``evaluate_in_memory`` loads the selection whole on one device and
loops over metrics and regions.  Both substitute the persistence,
climatology and probabilistic-climatology baselines for the forecast where
a config asks, and compute its derived variables on the device after the
copy (the JAX package derives on the host before it).  Results are
written as NetCDF3 (``scipy.io``), which
``weatherbench2_tpu.xds.open_netcdf`` also reads, or as Zarr.
"""
from __future__ import annotations

import copy
import logging
import os
import time
from typing import Mapping, Optional

import numpy as np
import torch

from weatherbench2_torch import config
from weatherbench2_torch import derived_variables
from weatherbench2_torch import device as device_lib
from weatherbench2_torch import metrics as metrics_lib
from weatherbench2_torch import schema
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.xds.core import LazyArrayBase, LazyStack


def make_latitude_increasing(dataset: xds.Dataset) -> xds.Dataset:
  """Make sure latitude values are increasing. Flip dataset if necessary."""
  lat = np.asarray(dataset.coords_dict()["latitude"].data)
  if (np.diff(lat) < 0).all():
    # a negative-step slice keeps lazy payloads lazy
    dataset = dataset.isel(latitude=slice(None, None, -1))
  return dataset


def _ensure_aligned_grid(dataset: xds.Dataset, target: xds.Dataset,
                         atol: float = 1e-3) -> xds.Dataset:
  """Ensure horizontal coordinates on dataset exactly match target."""
  for coord_name in ["latitude", "longitude"]:
    got = np.asarray(dataset.coords_dict()[coord_name].data)
    want = np.asarray(target.coords_dict()[coord_name].data)
    if got.shape != want.shape or not np.allclose(got, want, rtol=0,
                                                  atol=atol):
      raise ValueError(
          f"forecast and truth {coord_name} grids differ beyond {atol}")
  return dataset.assign_coords(
      latitude=target.coords_dict()["latitude"],
      longitude=target.coords_dict()["longitude"],
  )


def _ensure_nonempty(dataset: xds.Dataset, message: str = "") -> None:
  if not min(dataset.sizes.values()):
    raise ValueError(f"`dataset` was empty: {dataset.sizes=}. {message}")


def _decode_pressure_level_suffixes(forecast: xds.Dataset) -> xds.Dataset:
  """Decode '<var>_<level>' variables into a level dim, lazily."""
  by_var: dict[str, list[tuple[int, str]]] = {}
  passthrough = {}
  for var in forecast.keys():
    if var.split("_")[-1].isdigit():
      base = "_".join(var.split("_")[:-1])
      by_var.setdefault(base, []).append((int(var.split("_")[-1]), var))
    else:
      passthrough[var] = forecast.variables_dict()[var]
  out = xds.Dataset(passthrough, coords=dict(forecast.coords_dict()),
                    attrs=forecast.attrs)
  all_levels = None
  for base, entries in by_var.items():
    entries.sort()
    levels = [lev for lev, _ in entries]
    if all_levels is None:
      all_levels = levels
    elif levels != all_levels:
      raise ValueError(
          f"inconsistent pressure-level suffixes: {base} has {levels}, "
          f"expected {all_levels}"
      )
    variables = [forecast.variables_dict()[name] for _, name in entries]
    dims = variables[0].dims
    datas = [v.data for v in variables]
    if any(isinstance(d, LazyArrayBase) for d in datas):
      stacked = LazyStack(datas)
    else:
      stacked = np.stack([np.asarray(d) for d in datas], axis=0)
    out[base] = xds.DataArray(
        xds.Variable(("level",) + dims, stacked, variables[0].attrs),
        coords={
            "level": np.asarray(levels),
            **{k: v for k, v in forecast.coords_dict().items()
               if set(v.dims) <= set(dims)},
        },
        name=base,
    )
  return out


def open_source_files(
    forecast_path: str,
    obs_path: str,
    by_init: bool = False,
    rename_variables: Optional[dict] = None,
    pressure_level_suffixes: bool = False,
    lazy: bool = False,
) -> tuple[xds.Dataset, xds.Dataset]:
  """Open forecast and obs Zarr stores and standardize them."""
  obs = xds.open_zarr(obs_path, lazy=lazy)
  forecast = xds.open_zarr(forecast_path, lazy=lazy)
  if pressure_level_suffixes:
    forecast = _decode_pressure_level_suffixes(forecast)
  if rename_variables is not None:
    forecast = forecast.rename(rename_variables)
  obs = make_latitude_increasing(obs)
  forecast = make_latitude_increasing(forecast)
  forecast = _ensure_aligned_grid(forecast, obs)
  forecast = schema.apply_time_conventions(forecast, by_init=by_init)
  _ensure_nonempty(obs)
  _ensure_nonempty(forecast)
  return forecast, obs


def _impose_data_selection(
    dataset: xds.Dataset,
    selection: config.Selection,
    select_time: bool = True,
    time_dim: Optional[str] = None,
    select_aux: bool = False,
) -> xds.Dataset:
  """Apply a Selection to a dataset."""
  sel_variables = list(selection.variables)
  if select_aux and selection.aux_variables is not None:
    sel_variables = list(dict.fromkeys(
        sel_variables + list(selection.aux_variables)))
  missing = [v for v in sel_variables if v not in dataset]
  if missing:
    raise KeyError(
        f"selection variables {missing} not found in dataset with "
        f"variables {sorted(dataset.keys())}"
    )
  dataset = dataset[sel_variables]
  dataset = dataset.sel(latitude=selection.lat_slice,
                        longitude=selection.lon_slice)
  if selection.levels is not None and "level" in dataset.sizes:
    dataset = dataset.sel(level=list(selection.levels))
  if select_time:
    dataset = dataset.sel({time_dim: selection.time_slice})
  _ensure_nonempty(dataset, message="Selection created empty dataset")
  return dataset


def create_persistence_forecast(forecast: xds.Dataset,
                                obs: xds.Dataset) -> xds.Dataset:
  """Persistence forecast for by-valid data: the observation at init time,
  shaped like the forecast."""
  logging.warning("by-valid with evaluate_persistence is not 100% correct.")
  init_time = forecast["init_time"]  # dims (time, lead_time)
  time_vals = np.asarray(init_time.coords["time"].data)
  lead_max = np.asarray(forecast.coords_dict()["lead_time"].data).max()
  keep = np.nonzero(time_vals >= time_vals[0] + lead_max)[0]
  indexer = init_time.isel(time=keep).rename_dims({"time": "valid_time_dim"})
  persistence = obs.sel(time=indexer).rename({"valid_time_dim": "time"})
  # drop the stale gathered 'time' coord and restore the index coord
  return xds.Dataset(
      dict(persistence.variables_dict()),
      coords={**{k: v for k, v in persistence.coords_dict().items()
                 if k != "time"},
              "time": time_vals[keep]})


def create_persistence_forecast_by_init(forecast: xds.Dataset,
                                        truth: xds.Dataset) -> xds.Dataset:
  """Persistence for by-init data: truth at init_time, tiled over lead."""
  init_vals = np.asarray(forecast.coords_dict()["init_time"].data)
  persistence = truth.sel(time=init_vals).rename({"time": "init_time"})
  lead = np.asarray(forecast.coords_dict()["lead_time"].data)
  persistence = persistence.expand_dims(lead_time=lead)
  for cn, cv in forecast.coords_dict().items():
    if cn not in persistence.coords_dict():
      persistence = persistence.assign_coords({cn: cv})
  return persistence


def substitute_climatology_forecast(forecast_like: xds.Dataset,
                                    climatology: xds.Dataset,
                                    by_init: bool) -> xds.Dataset:
  """Climatology selected at the forecast's valid times, coords kept.

  The one implementation for both engines (in memory here, per chunk in
  ``parallel/streaming._make_truth_chunk``).
  """
  time_dim = "valid_time" if by_init else "time"
  clim = metrics_lib.select_climatology_variables(
      climatology, list(forecast_like.keys()))
  times = forecast_like[time_dim]
  sel = dict(dayofyear=times.dt.dayofyear)
  if "hour" in climatology.sizes:
    sel["hour"] = times.dt.hour
  return with_forecast_coords(clim.sel(sel), forecast_like)


def probabilistic_climatology(truth, eval_config):
  """The config's probabilistic climatology over ``truth``."""
  return utils.ProbabilisticClimatology(
      truth, eval_config.probabilistic_climatology_start_year,
      eval_config.probabilistic_climatology_end_year,
      eval_config.probabilistic_climatology_hour_interval)


def with_forecast_coords(new_f: xds.Dataset,
                         forecast_like: xds.Dataset) -> xds.Dataset:
  """``new_f`` with the coordinates of ``forecast_like`` it lacks."""
  for cn, cv in forecast_like.coords_dict().items():
    if cn not in new_f.coords_dict():
      new_f = new_f.assign_coords({cn: cv})
  return new_f


def _build_baseline_forecast(forecast, truth, climatology, eval_config,
                             data_config) -> xds.Dataset:
  """Replace the forecast with a climatology, probabilistic-climatology or
  persistence baseline if the config asks for one."""
  if eval_config.evaluate_climatology:
    return substitute_climatology_forecast(forecast, climatology,
                                           data_config.by_init)
  if eval_config.evaluate_probabilistic_climatology:
    time_dim = "valid_time" if data_config.by_init else "time"
    members = probabilistic_climatology(truth, eval_config).members(
        forecast[time_dim], list(forecast.keys()))
    return with_forecast_coords(members, forecast)
  if eval_config.evaluate_persistence:
    if data_config.by_init:
      return create_persistence_forecast_by_init(forecast, truth)
    return create_persistence_forecast(forecast, truth)
  return forecast


def _unique_step_size(data: np.ndarray):
  """The one step between consecutive values, or raise."""
  uniques = np.unique(np.diff(data)) if data.ndim == 1 else []
  if len(uniques) != 1:
    raise ValueError(f"time steps are not unique: {uniques}")
  return uniques[0]


def _ensure_consistent_time_step_sizes(truth: xds.Dataset,
                                       forecast: xds.Dataset):
  """Thin truth or forecast so their time steps agree."""
  truth_step = _unique_step_size(np.asarray(truth.coords_dict()["time"].data))
  forecast_step = _unique_step_size(
      np.asarray(forecast.coords_dict()["time"].data))
  coarse, fine = max(truth_step, forecast_step), min(truth_step,
                                                     forecast_step)
  multiple, remainder = divmod(coarse, fine)
  if remainder:
    raise ValueError("truth and forecast time steps are not multiples: "
                     f"{truth_step} vs {forecast_step}")
  if truth_step > forecast_step:
    forecast = forecast.thin(time=int(multiple))
  elif truth_step < forecast_step:
    truth = truth.thin(time=int(multiple))
  return truth, forecast


def _select_analysis_init_time(forecast: xds.Dataset,
                               forecast_all_times: xds.Dataset):
  """Select forecast/analysis pairings for the init-time convention."""
  analysis = forecast_all_times.sel(lead_time=np.timedelta64(0, "ns"),
                                    drop=True)
  analysis = analysis.rename({"init_time": "time"})
  time_vals = np.asarray(analysis.coords_dict()["time"].data)
  init_interval = np.unique(np.diff(time_vals))
  lead_vals = np.asarray(forecast.coords_dict()["lead_time"].data)
  lead_interval = np.unique(np.diff(lead_vals))
  if init_interval.size != 1 or lead_interval.size != 1:
    raise ValueError("init_time and lead_time intervals must be uniform")
  lead_per_init = init_interval[0] / lead_interval[0]
  if lead_per_init < 1 or lead_per_init != int(lead_per_init):
    raise ValueError("init interval must be a multiple of the lead interval")
  valid_max = np.asarray(forecast.coords_dict()["valid_time"].data).max()
  if time_vals.max() < valid_max:
    raise ValueError("analysis does not extend to latest forecast init+lead")
  forecast = forecast.isel(lead_time=slice(None, None, int(lead_per_init)))
  return forecast, analysis


def _add_base_variables(data_config: config.Data,
                        eval_config: config.Eval) -> config.Data:
  """The selection with the base variables of the config's derived
  variables appended, in a fixed order: the order of the variables is the
  order of the accumulators, and so of a state file (a resumed run, or one
  the JAX package began, must meet the same order)."""
  data_config = copy.deepcopy(data_config)
  variables = list(data_config.selection.variables)
  for derived_variable in eval_config.derived_variables.values():
    for base in sorted(derived_variable.base_variables):
      if base not in variables:
        variables.append(base)
  data_config.selection.variables = variables
  return data_config


def add_derived_variables(forecast: xds.Dataset, truth: xds.Dataset,
                          eval_config: config.Eval):
  """Forecast and truth with the config's derived variables added."""
  for name, dv in eval_config.derived_variables.items():
    forecast[name] = derived_variables.compute_on(dv, forecast)
    truth[name] = derived_variables.compute_on(dv, truth)
  return forecast, truth


def open_forecast_and_truth_datasets(
    data_config: config.Data,
    eval_config: config.Eval,
    lazy: bool = False,
) -> tuple[xds.Dataset, xds.Dataset, Optional[xds.Dataset]]:
  """Open datasets and select desired slices (with the base variables of
  the config's derived variables)."""
  data_config = _add_base_variables(data_config, eval_config)
  forecast, obs = open_source_files(
      forecast_path=data_config.paths.forecast,
      obs_path=data_config.paths.obs,
      by_init=data_config.by_init,
      rename_variables=data_config.rename_variables,
      pressure_level_suffixes=data_config.pressure_level_suffixes,
      lazy=lazy,
  )
  forecast_all_times = _impose_data_selection(
      forecast, data_config.selection, select_time=False, select_aux=True)
  if data_config.by_init:
    obs = _impose_data_selection(obs, data_config.selection,
                                 select_time=False)
  else:
    obs = _impose_data_selection(obs, data_config.selection, time_dim="time")
  forecast = _impose_data_selection(
      forecast, data_config.selection,
      time_dim="init_time" if data_config.by_init else "time",
      select_aux=True,
  )
  if eval_config.against_analysis:
    eval_truth = forecast.sel(lead_time=np.timedelta64(0, "ns"), drop=True)
    if data_config.by_init:
      forecast, eval_truth = _select_analysis_init_time(
          forecast, forecast_all_times)
  else:
    eval_truth = obs
  if not data_config.by_init:
    eval_truth, forecast = _ensure_consistent_time_step_sizes(
        eval_truth, forecast)
  climatology = None
  if eval_config.evaluate_climatology:
    climatology = make_latitude_increasing(
        xds.open_zarr(data_config.paths.climatology, lazy=lazy))
  return forecast, eval_truth, climatology


def _get_output_path(data_config: config.Data, eval_name: str,
                     output_format: str) -> str:
  suffix = {"netcdf": "nc", "zarr": "zarr"}.get(output_format)
  if suffix is None:
    raise ValueError(f"unrecognized data format: {output_format}")
  return os.path.join(
      data_config.paths.output_dir,
      f"{data_config.paths.output_file_prefix}{eval_name}.{suffix}",
  )


def _to_netcdf(dataset: xds.Dataset, filename: str) -> None:
  os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
  xds.to_netcdf(dataset, filename)


def merge_metric_results(results: list, dim: str = "metric") -> xds.Dataset:
  """Combine per-metric result datasets into one (metric, ...) dataset.

  Variables missing for some metrics are NaN-filled; dims differing across
  metrics are broadcast to the union, with coordinate values outer-joined.
  """
  metric_names = []
  for ds in results:
    metric_names.extend(
        np.atleast_1d(np.asarray(ds.coords_dict()[dim].data)).tolist())
  var_names: list = []
  for ds in results:
    for k in ds.keys():
      if k not in var_names:
        var_names.append(k)
  out = xds.Dataset({}, coords={dim: np.asarray(metric_names, dtype=object)})
  coord_pool: dict = {}
  for ds in results:
    for cn, cv in ds.coords_dict().items():
      if cn != dim:
        coord_pool.setdefault(cn, cv)

  union_coord_vals: dict = {}
  for ds in results:
    for cn, cv in ds.coords_dict().items():
      if cn == dim or cv.dims != (cn,):
        continue
      vals = np.asarray(cv.data)
      if cn not in union_coord_vals:
        union_coord_vals[cn] = vals
        continue
      cur = union_coord_vals[cn]
      if cur.dtype.kind in "iuf" and vals.dtype.kind in "iuf":
        common = np.result_type(cur.dtype, vals.dtype)
        cur, vals = cur.astype(common), vals.astype(common)
      if len(cur) == len(vals) and np.array_equal(cur, vals):
        union_coord_vals[cn] = cur
      else:
        merged = list(cur)
        merged += [x for x in vals.tolist() if x not in merged]
        union_coord_vals[cn] = np.asarray(merged, dtype=cur.dtype)

  def reindex_axis(arr, axis, src_vals, dst_vals):
    if src_vals.dtype.kind in "iuf" and dst_vals.dtype.kind in "iuf":
      src_vals = src_vals.astype(dst_vals.dtype)
    if len(src_vals) == len(dst_vals) and np.array_equal(src_vals, dst_vals):
      return arr
    shape = list(arr.shape)
    shape[axis] = len(dst_vals)
    out_arr = np.full(shape, np.nan)
    dst_list = dst_vals.tolist()
    pos = np.asarray([dst_list.index(x) for x in src_vals.tolist()])
    out_arr[tuple(pos if a == axis else slice(None)
                  for a in range(arr.ndim))] = arr
    return out_arr

  for var in var_names:
    union_dims: list = []
    sizes: dict = {}
    holders = []
    for ds in results:
      if var not in ds:
        holders.append((ds, None))
        continue
      da = ds[var]
      holders.append((ds, da))
      for d in da.dims:
        if d == dim:
          continue
        if d not in union_dims:
          union_dims.append(d)
          sizes[d] = (len(union_coord_vals[d]) if d in union_coord_vals
                      else da.sizes[d])
        elif d not in union_coord_vals:
          sizes[d] = max(sizes[d], da.sizes[d])
    full_shape = tuple(sizes[d] for d in union_dims)
    pieces = []
    for ds, da in holders:
      n_metric = len(np.atleast_1d(np.asarray(ds.coords_dict()[dim].data)))
      if da is None:
        pieces.append(np.full((n_metric,) + full_shape, np.nan))
        continue
      if dim in da.dims:
        da = da.transpose(*([dim] + [d for d in da.dims if d != dim]))
        vals = np.asarray(da.values, dtype=np.float64)
      else:
        vals = np.asarray(da.values, dtype=np.float64)[None]
      da_dims = tuple(d for d in da.dims if d != dim)
      ds_coords = ds.coords_dict()
      for ax, d in enumerate(da_dims):
        if d in union_coord_vals and d in ds_coords:
          vals = reindex_axis(vals, ax + 1, np.asarray(ds_coords[d].data),
                              union_coord_vals[d])
        elif vals.shape[ax + 1] < sizes.get(d, vals.shape[ax + 1]):
          pad = [(0, 0)] * vals.ndim
          pad[ax + 1] = (0, sizes[d] - vals.shape[ax + 1])
          vals = np.pad(vals, pad, constant_values=np.nan)
      v = xds.Variable((dim,) + da_dims, vals).broadcast_to_dims(
          (dim,) + tuple(union_dims), {dim: n_metric, **sizes})
      pieces.append(np.asarray(v.data))
    data = np.concatenate(pieces, axis=0)
    coords = {dim: np.asarray(metric_names, dtype=object)}
    for d in union_dims:
      if d in union_coord_vals:
        coords[d] = xds.Variable((d,), union_coord_vals[d])
      elif d in coord_pool:
        coords[d] = coord_pool[d]
    for cn, cv in coord_pool.items():
      if cv.dims and set(cv.dims) <= set(union_dims) and cn not in coords:
        coords[cn] = cv
    out[var] = xds.DataArray(data, dims=(dim,) + tuple(union_dims),
                             coords=coords)
  for cn, cv in coord_pool.items():
    if cn not in out.coords_dict() and (
        not cv.dims or set(cv.dims) <= set(out.sizes)):
      out = out.assign_coords({cn: cv})
  return out


def _metric_and_region_loop(forecast, truth, eval_config,
                            skipna) -> xds.Dataset:
  """Metric results looping over metrics and regions (the config's derived
  variables computed first, where the payloads are)."""
  forecast, truth = add_derived_variables(forecast, truth, eval_config)
  results = []
  for name, metric in eval_config.metrics.items():
    logging.info("metric: %s", name)
    eval_fn = (metric.compute if eval_config.temporal_mean
               else metric.compute_chunk)
    if eval_config.regions is not None:
      per_region = []
      for region_name, region in eval_config.regions.items():
        result = eval_fn(forecast=forecast, truth=truth, region=region,
                         skipna=skipna)
        per_region.append(result.expand_dims(
            region=np.asarray([region_name], dtype=object)))
      result = xds.concat(per_region, "region")
    else:
      result = eval_fn(forecast=forecast, truth=truth, skipna=skipna)
    results.append(result.expand_dims(
        metric=np.asarray([name], dtype=object)))
  return merge_metric_results(results)


def _evaluate_all_metrics(eval_name, eval_config, data_config, skipna,
                          dev) -> None:
  """One eval config in memory: the selection is read whole, moved to the
  device, and every metric × region evaluated there."""
  forecast, truth, climatology = open_forecast_and_truth_datasets(
      data_config, eval_config, lazy=True)
  forecast = _build_baseline_forecast(forecast, truth, climatology,
                                      eval_config, data_config)
  if data_config.by_init:
    truth = truth.sel(time=forecast["valid_time"])
  stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
  forecast = xds.to_device(forecast, dev, stream)
  truth = xds.to_device(truth, dev, stream)
  try:
    results = _metric_and_region_loop(forecast, truth, eval_config,
                                      skipna=skipna)
  finally:
    # the CRPS-spread slot holds the whole forecast on the device
    metrics_lib.clear_caches()
  logging.info("Evaluation complete")
  output_path = _get_output_path(data_config, eval_name, "netcdf")
  _to_netcdf(results, output_path)
  logging.info("Saved results to %s", output_path)


def evaluate_in_memory(data_config: config.Data,
                       eval_configs: Mapping[str, config.Eval],
                       skipna: bool = False, device=None) -> None:
  """Run the evaluation in memory; one results NetCDF per config.

  Output schema: dims ``(metric, region, lead_time[, level])`` per
  variable.  ``device=None`` is the CUDA card; pass ``device="cpu"`` to
  run on the host.
  """
  dev = device_lib.resolve(device)
  for eval_config in eval_configs.values():
    eval_config.validate()  # fail fast, not after hours of evaluation
  for eval_name, eval_config in eval_configs.items():
    _evaluate_all_metrics(eval_name, eval_config, data_config, skipna, dev)


def evaluate_with_mesh(
    data_config: config.Data,
    eval_configs: Mapping[str, config.Eval],
    *,
    input_chunks: Optional[Mapping[str, int]] = None,
    skipna: bool = False,
    device=None,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
) -> dict:
  """Stream every eval config through the metric tiers on one device, or
  on every rank of a mesh.

  Configs whose inputs are built identically share one chunk stream: each
  chunk is read and moved to the device once.  Writes one results file
  per config (``output_format``) and returns the run's counts: chunks,
  h2d bytes, bytes read, seconds spent waiting on the host and on the
  device and finalizing the results (see
  ``streaming.evaluate_streaming_multi``), seconds spent writing the
  results files, and the wall time.  ``device=None`` is the CUDA card;
  pass ``device="cpu"`` to run on the host.  With ``checkpoint_path`` each
  group of configs snapshots its accumulators every ``checkpoint_every``
  chunks into ``<checkpoint_path>.<cfg[+cfg...]>``, and an existing file
  resumes the run, grouped and lead_time-chunked streams included.

  ``mesh`` (a ``parallel.mesh.Mesh``) shards the stream over the ranks of
  its world, each on the mesh's device for it: every rank calls this with
  the same arguments, and rank 0 writes the results and the state files.
  """
  from weatherbench2_torch.parallel import mesh as mesh_lib
  from weatherbench2_torch.parallel import streaming

  if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
    raise TypeError(f"mesh must be a weatherbench2_torch.parallel.mesh.Mesh "
                    f"(make_mesh), not {type(mesh).__name__}")
  if mesh is not None and device is not None and (
      torch.device(device) != mesh.device):
    raise ValueError(f"device {device} is not this rank's mesh device "
                     f"{mesh.device}")
  dev = mesh.device if mesh is not None else device_lib.resolve(device)
  for name, eval_config in eval_configs.items():
    eval_config.validate()  # fail fast, not after hours of streaming
    if checkpoint_path and not eval_config.temporal_mean:
      raise ValueError(
          "checkpoint/resume requires temporal_mean=True (config "
          f"{name!r} emits per-time results, which the accumulator state "
          "does not capture)")
  input_chunks = dict(input_chunks or {})
  stats: dict = {}
  t0 = time.perf_counter()
  groups: dict = {}
  for name, cfg in eval_configs.items():
    groups.setdefault(streaming.input_key(cfg), {})[name] = cfg
  for group in groups.values():
    logging.info("Eval config group: %s", sorted(group))
    forecast, truth, climatology = open_forecast_and_truth_datasets(
        data_config, next(iter(group.values())), lazy=True)
    cpath = state = None
    if checkpoint_path:
      # one state file per group: grouped configs share the chunk stream,
      # so their accumulators are snapshotted together
      group_tag = "+".join(sorted(group))
      cpath = f"{checkpoint_path}.{group_tag}"
      if os.path.exists(cpath):
        state = streaming.StreamingState.load(cpath)
        logging.info("Resuming %s from %s (lead_index=%s, chunk_index=%s)",
                     group_tag, cpath, state.lead_index, state.chunk_index)
    results_by_config = streaming.evaluate_streaming_multi(
        forecast=forecast,
        truth=truth,
        climatology=climatology,
        eval_configs=group,
        data_config=data_config,
        input_chunks=input_chunks,
        skipna=skipna,
        device=dev,
        stats=stats,
        state=state,
        checkpoint_path=cpath,
        checkpoint_every=checkpoint_every,
        mesh=mesh,
    )
    t_write = time.perf_counter()
    for eval_name, results in (results_by_config or {}).items():
      output_format = group[eval_name].output_format
      output_path = _get_output_path(data_config, eval_name, output_format)
      if output_format == "netcdf":
        _to_netcdf(results, output_path)
      else:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        xds.to_zarr(results, output_path)
      logging.info("Saved results to %s", output_path)
    stats["write_s"] = stats.get("write_s", 0.0) + (
        time.perf_counter() - t_write)
  stats["wall_s"] = time.perf_counter() - t0
  return stats

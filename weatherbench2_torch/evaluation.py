"""Evaluation entry point of the port: open data, stream, save results.

Counterpart of ``weatherbench2_tpu/evaluation.py:31-394`` and
``evaluate_with_mesh`` (``:716-833``), on one device: chunks of
(init_)time stream to the card and every metric × region runs in the
fused tiers of ``parallel/streaming.py``.  Results are written as NetCDF3
(``scipy.io``), which ``weatherbench2_tpu.xds.open_netcdf`` also reads.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Mapping, Optional

import numpy as np

from weatherbench2_torch import config
from weatherbench2_torch import device as device_lib
from weatherbench2_torch import schema
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


def open_forecast_and_truth_datasets(
    data_config: config.Data,
    eval_config: config.Eval,
    lazy: bool = False,
) -> tuple[xds.Dataset, xds.Dataset, Optional[xds.Dataset]]:
  """Open datasets and select desired slices."""
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


def evaluate_with_mesh(
    data_config: config.Data,
    eval_configs: Mapping[str, config.Eval],
    *,
    input_chunks: Optional[Mapping[str, int]] = None,
    skipna: bool = False,
    device=None,
    mesh=None,
    checkpoint_path: Optional[str] = None,
) -> dict:
  """Stream every eval config through the fused tiers on one device.

  Configs whose inputs are built identically share one chunk stream: each
  chunk is read and moved to the device once.  Writes one results file
  per config (``output_format``) and returns the run's counts: chunks,
  h2d bytes, and seconds spent waiting on the host and on the device
  (see ``streaming.evaluate_streaming_multi``), plus the wall time.
  ``device=None`` is the CUDA card; pass ``device="cpu"`` to run on the
  host.  ``mesh`` and ``checkpoint_path`` (the JAX package's multi-device
  and resume options) are not ported yet and raise.
  """
  from weatherbench2_torch.parallel import streaming

  if mesh is not None:
    raise NotImplementedError(
        "multi-device evaluation is not ported yet (ROADMAP A.12)")
  if checkpoint_path:
    raise NotImplementedError(
        "checkpoint/resume is not ported yet (ROADMAP A.6)")
  dev = device_lib.resolve(device)
  for eval_config in eval_configs.values():
    eval_config.validate()  # fail fast, not after hours of streaming
  input_chunks = dict(input_chunks or {})
  stats: dict = {}
  t0 = time.perf_counter()
  groups: dict = {}
  for name, cfg in eval_configs.items():
    groups.setdefault(bool(cfg.against_analysis), {})[name] = cfg
  for group in groups.values():
    logging.info("Eval config group: %s", sorted(group))
    forecast, truth, climatology = open_forecast_and_truth_datasets(
        data_config, next(iter(group.values())), lazy=True)
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
    )
    for eval_name, results in results_by_config.items():
      output_format = group[eval_name].output_format
      output_path = _get_output_path(data_config, eval_name, output_format)
      if output_format == "netcdf":
        _to_netcdf(results, output_path)
      else:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        xds.to_zarr(results, output_path)
      logging.info("Saved results to %s", output_path)
  stats["wall_s"] = time.perf_counter() - t0
  return stats

"""Deterministic verification metrics of the port.

Counterpart of ``weatherbench2_tpu/metrics.py:39-808``: latitude weights,
the spatial average, the ``Metric`` protocol, ``MSE``,
``RMSESqrtBeforeTimeAvg``, ``MAE``, ``Bias`` and ``ACC``, the wind-vector
errors, the ``Spatial*`` (per-cell) forms and SEEPS.  The math is written
against the labeled layer, which dispatches to torch when payloads are
tensors.  On the streaming path MSE/RMSE/MAE/Bias without wind vectors run
through the fused deterministic kernel; ACC, SEEPS and MSE/RMSE with wind
vectors through the pointwise tier; the ``Spatial*`` metrics through the
unfused per-region loop (``parallel/streaming.py``).  ``compute_chunk`` is
the unfused form.
"""
import dataclasses
import functools
import os
import threading
import typing as t

import numpy as np
import torch

from weatherbench2_torch import xds
from weatherbench2_torch.regions import Region
from weatherbench2_torch.xds import _xp


def _assert_increasing(x: np.ndarray):
  if not (np.diff(x) > 0).all():
    raise ValueError(f"array is not increasing: {x}")


def _latitude_cell_bounds(x: np.ndarray) -> np.ndarray:
  pi_over_2 = np.array([np.pi / 2], dtype=x.dtype)
  return np.concatenate([-pi_over_2, (x[:-1] + x[1:]) / 2, pi_over_2])


def _cell_area_from_latitude(points: np.ndarray) -> np.ndarray:
  """Normalized area overlap as a function of latitude."""
  bounds = _latitude_cell_bounds(points)
  _assert_increasing(bounds)
  # integral of cos(latitude) from the lower to the upper bound
  return np.sin(bounds[1:]) - np.sin(bounds[:-1])


def get_lat_weights(ds) -> xds.DataArray:
  """Latitude/area weights from the latitude coordinate of a dataset."""
  lat = np.asarray(ds.coords_dict()["latitude"].data)
  weights = _cell_area_from_latitude(np.deg2rad(lat))
  weights /= np.mean(weights)
  return xds.DataArray(weights, dims=("latitude",),
                       coords={"latitude": lat}, name="latitude")


def select_climatology_variables(
    climatology: xds.Dataset, names
) -> xds.Dataset:
  """Select `names` from a climatology, accepting '<name>_mean' forms."""
  src, rename, missing = [], {}, []
  for n in names:
    if n in climatology:
      src.append(n)
    elif f"{n}_mean" in climatology:
      src.append(f"{n}_mean")
      rename[f"{n}_mean"] = n
    else:
      missing.append(n)
  if missing:
    raise KeyError(
        f"climatology is missing variables {missing} (neither bare "
        "names nor their '_mean'-suffixed forms are present)"
    )
  out = climatology[src]
  return out.rename(rename) if rename else out


def _get_climatology_chunk(
    climatology: xds.Dataset, truth: xds.Dataset
) -> xds.Dataset:
  """The climatological mean of the observed true variables."""
  return select_climatology_variables(climatology, truth.keys())


@dataclasses.dataclass
class Metric:
  """Base class for metrics.

  Engine protocol: ``prepare_chunk`` does the coordinate-dependent work on
  the host (climatology gathers keyed by time coords);
  ``compute_chunk_prepared`` is array math on the chunk's device;
  ``pointwise_chunk`` returns per-cell fields whose area-weighted regional
  means ``finalize_fused`` turns into the metric (the pointwise tier
  reduces them with ``ops.fused_region_sums``).  ``compute_chunk`` composes
  the first two and is the reference-parity unfused entry point.
  """

  #: False marks a metric that must run on the host, on numpy chunks (host
  #: RNG, numpy-only code).  The name is the JAX package's, kept so that a
  #: reader finds it: there it means "traceable under jit".
  supports_jit: t.ClassVar[bool] = True

  #: metrics whose chunk value is an area-weighted regional mean of
  #: per-cell fields (optionally post-processed by ``finalize_fused``)
  supports_pointwise_fused: t.ClassVar[bool] = False

  #: NaN handling of the fused regional mean: "global" follows the
  #: evaluation's skipna flag; "skip" always drops NaN cells from the
  #: weighted mean (the p1 mask of SEEPS).
  fused_nan_mode: t.ClassVar[str] = "global"

  def prepare_chunk(self, forecast: xds.Dataset, truth: xds.Dataset,
                    device=None) -> t.Any:
    """Host-side, coordinate-dependent preparation for a chunk.

    ``device`` is where the chunk will be computed; a metric may keep
    chunk-independent state resident there.
    """
    del forecast, truth, device
    return None

  def compute_chunk_prepared(self, forecast, truth, prepared, region=None,
                             skipna=False):
    """Chunk evaluation on the chunk's device, given ``prepare_chunk``'s
    output."""
    del prepared
    return self.compute_chunk(forecast, truth, region=region, skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    """Per-cell fields whose weighted regional mean feeds finalize_fused.

    ``None`` declines (a required variable is missing): the engine then
    runs this metric through its per-region loop.
    """
    del forecast, truth, prepared, skipna
    return None

  def finalize_fused(self, means: xds.Dataset, skipna: bool = False):
    """Regional means of ``pointwise_chunk`` fields -> metric result."""
    del skipna
    return means

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    """Evaluate this metric on a temporal chunk of data."""
    raise NotImplementedError

  def compute(self, forecast, truth, region=None, skipna=False):
    """Evaluate on datasets with full temporal coverage (mean over time)."""
    if "time" in forecast.sizes:
      avg_dim = "time"
    elif "init_time" in forecast.sizes:
      avg_dim = "init_time"
    else:
      raise ValueError("Forecast has neither time nor init_time dimension")
    return self.compute_chunk(
        forecast, truth, region=region, skipna=skipna
    ).mean(avg_dim, skipna=skipna)


def _spatial_average(dataset: xds.Dataset, region: t.Optional[Region],
                     skipna: bool):
  """Area-weighted spatial mean after applying the region mask."""
  weights = get_lat_weights(dataset)
  if region is not None:
    dataset, weights = region.apply(dataset, weights)
    # ignore NaN/Inf values in regions with zero weight
    dataset = dataset.where(weights > 0, 0)
  return dataset.weighted(weights).mean(["latitude", "longitude"],
                                        skipna=skipna)


def _sqrt(obj):
  if isinstance(obj, xds.Dataset):
    return obj.map(_sqrt)
  return obj.copy(data=_xp.namespace(obj.data).sqrt(obj.data))


@dataclasses.dataclass
class WindVectorMSE(Metric):
  """Wind vector mean squared error (see the WeatherBench 2 paper)."""

  u_name: str
  v_name: str
  vector_name: str

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    diff = forecast - truth
    return _spatial_average(
        diff[self.u_name] ** 2 + diff[self.v_name] ** 2,
        region=region, skipna=skipna)


@dataclasses.dataclass
class WindVectorRMSESqrtBeforeTimeAvg(Metric):
  """Wind vector RMSE with the square root taken before time averaging."""

  u_name: str
  v_name: str
  vector_name: str

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    mse = WindVectorMSE(
        u_name=self.u_name, v_name=self.v_name, vector_name=self.vector_name
    ).compute_chunk(forecast, truth, region=region, skipna=skipna)
    return _sqrt(mse)


def _squared_error_fields(forecast, truth, wind_vectors):
  """(f-t)² per variable, plus du²+dv² for each wind-vector pair; ``None``
  when a pair's variable is missing."""
  diff = forecast - truth
  fields = diff * diff
  for wv in wind_vectors or ():
    if wv.u_name not in fields.keys() or wv.v_name not in fields.keys():
      return None
    fields[wv.vector_name] = fields[wv.u_name] + fields[wv.v_name]
  return fields


def _with_wind_vectors(results, wind_vectors, forecast, truth, region,
                       skipna):
  for wv in wind_vectors or ():
    results[wv.vector_name] = wv.compute_chunk(
        forecast, truth, region=region, skipna=skipna)
  return results


@dataclasses.dataclass
class RMSESqrtBeforeTimeAvg(Metric):
  """RMSE with the square root taken before time averaging."""

  wind_vector_rmse: t.Optional[list] = None

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    results = _sqrt(_spatial_average((forecast - truth) ** 2, region=region,
                                     skipna=skipna))
    return _with_wind_vectors(results, self.wind_vector_rmse, forecast,
                              truth, region, skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del prepared, skipna
    return _squared_error_fields(forecast, truth, self.wind_vector_rmse)

  def finalize_fused(self, means, skipna=False):
    del skipna
    return _sqrt(means)


@dataclasses.dataclass
class MSE(Metric):
  """Mean squared error."""

  wind_vector_mse: t.Optional[list] = None

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    results = _spatial_average((forecast - truth) ** 2, region=region,
                               skipna=skipna)
    return _with_wind_vectors(results, self.wind_vector_mse, forecast,
                              truth, region, skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del prepared, skipna
    return _squared_error_fields(forecast, truth, self.wind_vector_mse)


@dataclasses.dataclass
class SpatialMSE(Metric):
  """MSE without spatial averaging."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    del region, skipna
    return (forecast - truth) ** 2


@dataclasses.dataclass
class MAE(Metric):
  """Mean absolute error."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _spatial_average(abs(forecast - truth), region=region,
                            skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del prepared, skipna
    return abs(forecast - truth)


@dataclasses.dataclass
class SpatialMAE(Metric):
  """MAE without spatial averaging."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    del region, skipna
    return abs(forecast - truth)


@dataclasses.dataclass
class Bias(Metric):
  """Mean error."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _spatial_average(forecast - truth, region=region, skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del prepared, skipna
    return forecast - truth


@dataclasses.dataclass
class SpatialBias(Metric):
  """Bias without spatial averaging."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    del region, skipna
    return forecast - truth


def clim_device_budget() -> float:
  """Largest climatology (bytes) kept resident on the device for ACC.

  Larger ones (hourly 0.25° is hundreds of GB) are gathered per chunk on
  the host.  ``WB2_CLIM_DEVICE_BYTES`` overrides the 2 GB default, as in
  the JAX package.
  """
  return float(os.environ.get("WB2_CLIM_DEVICE_BYTES", 2e9))


@dataclasses.dataclass
class ACC(Metric):
  """Anomaly correlation coefficient.

  Attributes:
    climatology: Climatology dataset for computing anomalies.
  """

  climatology: xds.Dataset

  supports_pointwise_fused: t.ClassVar[bool] = True

  @staticmethod
  def _validated_positions(coord_vals, wanted, what):
    """Exact positions of `wanted` in sorted `coord_vals`, or raise.

    A raw searchsorted would select the NEXT row for labels missing from
    the climatology; the reference's `.sel` raises KeyError instead.
    """
    wanted = np.asarray(wanted)
    pos = np.searchsorted(coord_vals, wanted)
    clipped = np.minimum(pos, len(coord_vals) - 1)
    bad = coord_vals[clipped] != wanted
    if np.any(bad):
      raise KeyError(
          f"forecast {what} values {np.unique(wanted[bad])!r} not found "
          f"in the climatology {what} coordinate"
      )
    return clipped.astype(np.int64)

  def _gather_indices(self, forecast, hour_vals):
    """(dayofyear[, hour]) gather indices for a chunk's valid times."""
    time_dim = "valid_time" if "init_time" in forecast.sizes else "time"
    doy_vals = np.asarray(self.climatology.coords_dict()["dayofyear"].data)
    times = forecast[time_dim]
    indices = {"doy": xds.DataArray(self._validated_positions(
        doy_vals, times.dt.dayofyear.values, "dayofyear"), dims=times.dims)}
    if hour_vals is not None:
      indices["hour"] = xds.DataArray(self._validated_positions(
          hour_vals, times.dt.hour.values, "hour"), dims=times.dims)
    return indices

  def prepare_chunk(self, forecast, truth, device=None):
    """Gather indices for this chunk, and the climatology they index.

    A climatology within ``clim_device_budget()`` moves to ``device`` once
    and stays resident: each chunk ships only small (dayofyear, hour)
    indices and gathers on the device.  A larger one is gathered on the
    host per chunk, deduplicated to its unique (dayofyear, hour) rows.
    """
    cache_key = (
        tuple(sorted(truth.keys())),
        tuple(np.asarray(forecast["level"].values).tolist())
        if "level" in forecast.sizes else None,
        str(device),
    )
    with self.__dict__.setdefault("_cache_lock", threading.Lock()):
      cached = self.__dict__.get("_clim_cache")
      if cached is None or cached[0] != cache_key:
        cached = self._build_clim_cache(cache_key, forecast, truth, device)
        self._clim_cache = cached
    _, clim, hour_vals = cached
    indices = self._gather_indices(forecast, hour_vals)
    if clim is None:  # host-gather mode
      return self._host_gather(indices)
    return {"clim": clim, "indices": indices}

  def _build_clim_cache(self, cache_key, forecast, truth, device):
    clim = _get_climatology_chunk(self.climatology, truth)
    if "level" in forecast.sizes and "level" in clim.sizes:
      lev_pos = xds.Index(
          np.asarray(clim.coords_dict()["level"].data)
      ).positions_for_labels(np.asarray(forecast["level"].values))
      clim = clim.isel(level=lev_pos)
    # the gathered dims' coords would be indexed by device tensors; the
    # engine needs none of them
    hour_coord = clim.coords_dict().get("hour")
    clim = xds.Dataset(
        dict(clim.variables_dict()),
        coords={k: v for k, v in clim.coords_dict().items()
                if not set(v.dims) & {"dayofyear", "hour"}},
    )
    hour_vals = None if hour_coord is None else np.asarray(hour_coord.data)
    nbytes = sum(4 * v.size for v in clim.variables_dict().values())
    if nbytes > clim_device_budget():
      self._clim_host = clim
      return cache_key, None, hour_vals
    if device is not None:
      # pinned and on the caller's current stream (the engine's copy
      # stream), like the chunks
      stream = (torch.cuda.current_stream(device)
                if torch.device(device).type == "cuda" else None)
      clim = xds.to_device(clim, torch.device(device), stream)
    return cache_key, clim, hour_vals

  def _host_gather(self, indices):
    """Unique-(dayofyear, hour) climatology rows + device expansion map.

    Within an init-chunked streaming chunk the (dayofyear, hour) pairs of
    its valid times repeat across leads, so shipping a chunk-shaped
    selection would move several times the needed bytes: gather the
    unique pairs once (a bounded lazy read) and expand on the device.
    """
    doy = np.asarray(indices["doy"].data)
    dims = indices["doy"].dims
    if "hour" in indices:
      hour = np.asarray(indices["hour"].data)
      uniq, inv = np.unique(np.stack([doy.ravel(), hour.ravel()], axis=1),
                            axis=0, return_inverse=True)
    else:
      uniq, inv = np.unique(doy.ravel(), return_inverse=True)
      uniq = uniq[:, None]
    sel = {"dayofyear": xds.DataArray(uniq[:, 0], dims=("__clim_upair",))}
    if "hour" in indices:
      sel["hour"] = xds.DataArray(uniq[:, 1], dims=("__clim_upair",))
    chunk = self._clim_host.isel(sel)
    clim_u = chunk.copy(data={k: np.asarray(v.data)
                              for k, v in chunk.variables_dict().items()})
    uinv = xds.DataArray(inv.reshape(doy.shape).astype(np.int64), dims=dims)
    return {"clim_u": clim_u, "uinv": uinv}

  @staticmethod
  def _prepared_clim_chunk(prepared):
    """Chunk-shaped climatology from either prepared form."""
    if "clim_u" in prepared:
      return prepared["clim_u"].isel({"__clim_upair": prepared["uinv"]})
    sel = {"dayofyear": prepared["indices"]["doy"]}
    if "hour" in prepared["indices"]:
      sel["hour"] = prepared["indices"]["hour"]
    return prepared["clim"].isel(sel)

  def compute_chunk_prepared(self, forecast, truth, prepared, region=None,
                             skipna=False):
    clim = self._prepared_clim_chunk(prepared)
    fa = forecast - clim
    ta = truth - clim
    return _spatial_average(fa * ta, region=region, skipna=skipna) / _sqrt(
        _spatial_average(fa**2, region=region, skipna=skipna)
        * _spatial_average(ta**2, region=region, skipna=skipna))

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    """Three stacked anomaly products fa*ta, fa², ta² (dim __fstat).

    Each variable's three fields broadcast to their union dims before
    stacking: the regional mean of a broadcast field equals the broadcast
    of the mean, so this matches three independent spatial averages.
    """
    del skipna
    clim = self._prepared_clim_chunk(prepared)
    fa = forecast - clim
    ta = truth - clim
    num = fa * ta
    fsq = fa * fa
    tsq = ta * ta
    out = xds.Dataset({}, coords=dict(num.coords_dict()))
    for name in num.keys():
      vs = [num.variables_dict()[name], fsq.variables_dict()[name],
            tsq.variables_dict()[name]]
      dims = xds.broadcast_dims_order(*(v.dims for v in vs))
      sizes: dict = {}
      for v in vs:
        sizes.update(v.sizes)
      arrs = [v.broadcast_to_dims(dims, sizes).data for v in vs]
      out[name] = xds.Variable(("__fstat",) + dims,
                               _xp.namespace(*arrs).stack(arrs))
    return out

  def finalize_fused(self, means, skipna=False):
    del skipna
    num = means.isel(__fstat=0, drop=True)
    fvar = means.isel(__fstat=1, drop=True)
    tvar = means.isel(__fstat=2, drop=True)
    return num / _sqrt(fvar * tvar)

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return self.compute_chunk_prepared(
        forecast, truth, self.prepare_chunk(forecast, truth),
        region=region, skipna=skipna,
    )


@dataclasses.dataclass
class SpatialSEEPS(Metric):
  """Stable Equitable Error in Probability Space (Rodwell et al. 2010).

  Scores 3-category precipitation (dry / light / heavy) against
  per-location climatological wet thresholds and dry fractions.

  Attributes:
    climatology: dataset containing ``{precip_name}_seeps_threshold`` [m]
      and ``{precip_name}_seeps_dry_fraction`` [0-1].
    dry_threshold_mm: dry threshold in mm.
    precip_name: name of the precipitation variable.
    min_p1 / max_p1: mask out locations with climatological dry fraction
      outside (min_p1, max_p1).
  """

  climatology: xds.Dataset
  dry_threshold_mm: float = 0.25
  precip_name: str = "total_precipitation_24hr"
  min_p1: float = 0.1
  max_p1: float = 0.85

  @functools.cached_property
  def p1(self) -> xds.DataArray:
    """The climatological dry fraction per cell (one read of that one
    variable, whatever else the climatology store holds)."""
    dry_fraction = self.climatology[f"{self.precip_name}_seeps_dry_fraction"]
    return dry_fraction.mean(["hour", "dayofyear"])

  def _category_indicators(self, ds: xds.Dataset, wet: xds.DataArray):
    """(dry, light, heavy) indicators in the data's float type, NaN where
    the data is NaN."""
    dry_threshold = self.dry_threshold_mm / 1000.0
    da = ds[self.precip_name]
    valid = da.notnull()
    as_float = lambda cond: cond.astype(da.dtype).where(valid)
    return (as_float(da < dry_threshold),
            as_float((da > dry_threshold) & (da < wet)),
            as_float(da >= wet))

  def prepare_chunk(self, forecast, truth, device=None):
    del device
    wet_threshold = self.climatology[f"{self.precip_name}_seeps_threshold"]
    if "time" in truth.sizes and "time" not in forecast.sizes:
      # compact truth of a streaming chunk (its time axis is the chunk's
      # unique valid times): one threshold row per unique time, expanded on
      # the device together with the truth
      times = truth["time"]
    else:
      times = forecast["valid_time"]
    wet = wet_threshold.sel(dayofyear=times.dt.dayofyear, hour=times.dt.hour)
    return {"wet": wet, "p1": self.p1}

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return self.compute_chunk_prepared(
        forecast, truth, self.prepare_chunk(forecast, truth),
        region=region, skipna=skipna)

  def compute_chunk_prepared(self, forecast, truth, prepared, region=None,
                             skipna=False):
    del region, skipna  # skipna is effectively True because of the p1 mask
    wet = prepared["wet"]
    f_dry, f_light, f_heavy = self._category_indicators(forecast, wet)
    t_dry, t_light, t_heavy = self._category_indicators(truth, wet)
    p1 = prepared["p1"]
    # scoring matrix (row: forecast category, column: truth), times 0.5:
    #   [[0,             1/(1-p1),   4/(1-p1)],
    #    [1/p1,          0,          3/(1-p1)],
    #    [1/p1+3/(2+p1), 3/(2+p1),   0       ]]
    result = 0.5 * (
        f_dry * t_light * (1.0 / (1 - p1))
        + f_dry * t_heavy * (4.0 / (1 - p1))
        + f_light * t_dry * (1.0 / p1)
        + f_light * t_heavy * (3.0 / (1 - p1))
        + f_heavy * t_dry * (1.0 / p1 + 3.0 / (2 + p1))
        + f_heavy * t_light * (3.0 / (2 + p1))
    )
    result = result.where(p1 < self.max_p1, np.nan)
    result = result.where(p1 > self.min_p1, np.nan)
    return xds.Dataset({self.precip_name: result.variable},
                       coords={**result.coords})


@dataclasses.dataclass
class SEEPS(SpatialSEEPS):
  """Spatially averaged SEEPS."""

  supports_pointwise_fused: t.ClassVar[bool] = True
  #: the p1 mask puts NaN into climatologically degenerate cells; the
  #: spatial mean always leaves them out
  fused_nan_mode: t.ClassVar[str] = "skip"

  def compute_chunk_prepared(self, forecast, truth, prepared, region=None,
                             skipna=False):
    del skipna
    result = SpatialSEEPS.compute_chunk_prepared(self, forecast, truth,
                                                 prepared)
    return _spatial_average(result, region=region, skipna=True)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del skipna
    if self.precip_name not in truth.keys():
      return None
    return SpatialSEEPS.compute_chunk_prepared(self, forecast, truth,
                                               prepared)

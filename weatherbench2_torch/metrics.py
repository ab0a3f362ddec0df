"""Verification metrics of the port, deterministic and probabilistic.

Counterpart of ``weatherbench2_tpu/metrics.py``: latitude weights, the
spatial average, the ``Metric`` protocol, ``MSE``,
``RMSESqrtBeforeTimeAvg``, ``MAE``, ``Bias`` and ``ACC``, the wind-vector
errors, the ``Spatial*`` (per-cell) forms and SEEPS; then the ensemble
metrics (CRPS and its spread and skill, ensemble mean and variance, energy
scores, rank histograms), the Gaussian closed forms and the threshold
scores (Brier, ignorance, RPS).  The math is written against the labeled
layer, which dispatches to torch when payloads are tensors.  On the
streaming path MSE/RMSE/MAE/Bias without wind vectors run through the fused
deterministic kernel; the CRPS family and the ensemble mean/variance
metrics through the probabilistic plan (one member pass, then the region
kernel); ACC, SEEPS, MSE/RMSE with wind vectors, the Gaussian, threshold
and energy scores through the pointwise tier; the ``Spatial*`` metrics and
rank histograms through the unfused per-region loop
(``parallel/streaming.py``).  ``compute_chunk`` is the unfused form.
"""
import dataclasses
import functools
import math
import os
import threading
import typing as t

import numpy as np
import torch

from weatherbench2_torch import thresholds as thresholds_lib
from weatherbench2_torch import xds
from weatherbench2_torch.regions import Region
from weatherbench2_torch.xds import _xp

REALIZATION = "realization"


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


def _log(obj):
  if isinstance(obj, xds.Dataset):
    return obj.map(_log)
  with np.errstate(divide="ignore"):  # log(0) = -inf is the answer
    return obj.copy(data=_xp.namespace(obj.data).log(obj.data))


def _norm_cdf(obj):
  """The standard normal CDF, erfc(-x/√2)/2, in float64 on tensors too.

  The JAX package writes (1 + erf(x/√2))/2 and 1 - cdf for the upper tail;
  both cancel in the tails (in float32 from about 5.4 sigma to exactly 0 or
  1, in float64 from about 7 sigma to a few ulps), where the card's and the
  host's erf round differently and the ignorance score's log turns those
  ulps into differences of 0.2 or into +inf on one side only.  erfc keeps
  the lower tail, and ``_norm_cdf(-x)`` is the upper tail without the
  subtraction.
  """
  if isinstance(obj, xds.Dataset):
    return obj.map(_norm_cdf)
  if _xp.is_tensor(obj.data):
    x, erfc = obj.data.to(torch.float64), torch.special.erfc
  else:
    from scipy.special import erfc
    x = obj.data
  return obj.copy(data=0.5 * erfc(-x / math.sqrt(2.0)))


def _norm_pdf(obj):
  if isinstance(obj, xds.Dataset):
    return obj.map(_norm_pdf)
  xp = _xp.namespace(obj.data)
  return obj.copy(data=xp.exp(-0.5 * obj.data**2) / math.sqrt(2.0 * math.pi))


def _spatial_average_l2_norm(dataset, region, skipna):
  """sqrt(spatial_average(ds**2))."""
  return _sqrt(_spatial_average(dataset**2, region=region, skipna=skipna))


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

  @property
  def p1(self) -> xds.DataArray:
    """The climatological dry fraction per cell (one read of that one
    variable, whatever else the climatology store holds), computed once:
    the prefetch threads that ask for it meanwhile wait for that mean (at
    0.25 degrees it reads 6 GB)."""
    with self.__dict__.setdefault("_p1_lock", threading.Lock()):
      if "_p1" not in self.__dict__:
        dry_fraction = self.climatology[
            f"{self.precip_name}_seeps_dry_fraction"]
        self._p1 = dry_fraction.mean(["hour", "dayofyear"])
      return self._p1

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


################################################################################
# Probabilistic metrics (weatherbench2_tpu/metrics.py:816-1948).
################################################################################


def _get_n_ensemble(ds: xds.Dataset, ensemble_dim: str,
                    expect_n_ensemble_at_least: int = 1) -> int:
  if ensemble_dim not in ds.sizes:
    raise ValueError(f"ensemble_dim={ensemble_dim!r} not found in {ds.sizes}")
  n_ensemble = ds.sizes[ensemble_dim]
  if n_ensemble < expect_n_ensemble_at_least:
    raise ValueError(f"{n_ensemble=} is less than expected size of "
                     f"{expect_n_ensemble_at_least}")
  return n_ensemble


def _debiased_ensemble_mean_mse(forecast, truth, ensemble_dim: str,
                                skipna: bool) -> xds.Dataset:
  """Unbiased estimate of E(forecast.mean() - truth)²."""
  forecast_mean = forecast.mean(ensemble_dim, skipna=skipna)
  forecast_var = forecast.var(ensemble_dim, skipna=skipna, ddof=1)
  biased_mse = (truth - forecast_mean) ** 2
  return biased_mse - forecast_var / _get_n_ensemble(forecast, ensemble_dim)


@dataclasses.dataclass
class EnsembleMetric(Metric):
  """Ensemble metric base class."""

  ensemble_dim: str = REALIZATION

  def _ensemble_slice(self, ds: xds.Dataset, slice_obj: slice) -> xds.Dataset:
    ds = ds.isel({self.ensemble_dim: slice_obj})
    return ds.assign_coords(
        {self.ensemble_dim: np.arange(ds.sizes[self.ensemble_dim])})

  def compute(self, forecast, truth, region=None, skipna=False):
    result = super().compute(forecast, truth, region=region, skipna=skipna)
    return result.assign_attrs(
        ensemble_size=forecast.sizes[self.ensemble_dim])


def _rankdata(x: np.ndarray, axis: int) -> np.ndarray:
  """Ordinal rank along axis, 1-based (ties broken by order)."""
  return np.argsort(np.argsort(x, axis=axis), axis=axis) + 1


def pwm_spread(x: torch.Tensor, axis: int, skipna: bool) -> torch.Tensor:
  """CRPS spread E|X - X'| along ``axis`` of a tensor, from one sort.

  λ₂ = 1/(M(M-1)) Σᵢ (2i - M - 1) x₍ᵢ₎ (Zamo & Naveau's PWM estimator),
  times two.  The member axis is moved last and made contiguous, so the
  sort runs along contiguous memory; NaN sorts last.  Under ``skipna`` a
  valid value at sorted position i has ordinal rank i+1 among all members,
  so the sum over valid positions divided by the valid count is the rank
  form's NaN-skipping mean; the coefficients keep the global M, as there.
  """
  m = x.shape[axis]
  xs = torch.movedim(x, axis, -1).contiguous().sort(dim=-1).values
  coef = 2 * torch.arange(1, m + 1, device=x.device, dtype=x.dtype) - m - 1
  if skipna:
    valid = ~torch.isnan(xs)
    count = valid.sum(dim=-1).to(x.dtype)
    return 2 * (torch.where(valid, xs, 0.0) @ coef) / count / (m - 1)
  return 2 * (xs @ coef) / m / (m - 1)


def _pointwise_crps_spread(forecast: xds.Dataset, ensemble_dim: str,
                           skipna: bool) -> xds.Dataset:
  """CRPS spread E|X - X'| per cell: one sort on tensors (``pwm_spread``),
  the double-argsort rank form on host arrays, as the JAX package."""
  n_ensemble = _get_n_ensemble(forecast, ensemble_dim)
  if n_ensemble < 2:
    return xds.zeros_like(forecast.isel({ensemble_dim: 0}))

  def per_var(da: xds.DataArray) -> xds.DataArray:
    ax = da.dims.index(ensemble_dim)
    if _xp.is_tensor(da.data):
      dims = tuple(d for d in da.dims if d != ensemble_dim)
      coords = {k: v for k, v in da.coords.items()
                if ensemble_dim not in v.dims}
      return xds.DataArray(
          xds.Variable(dims, pwm_spread(da.data, ax, skipna)),
          coords=coords, name=da.name)
    rank = da.copy(data=_rankdata(np.asarray(da.data), ax))
    return 2 * (((2 * rank - n_ensemble - 1) * da).mean(
        ensemble_dim, skipna=skipna)) / (n_ensemble - 1)

  return forecast.map(per_var)


_CRPS_SPREAD_CACHE: dict = {}


def clear_caches() -> None:
  """Drop the CRPS-spread slot (it holds its forecast alive)."""
  _CRPS_SPREAD_CACHE.clear()


def _pointwise_crps_spread_cached(forecast: xds.Dataset, ensemble_dim: str,
                                  skipna: bool) -> xds.Dataset:
  """Single-slot cache over ``_pointwise_crps_spread``.

  CRPS, CRPSSpread and their Spatial* forms evaluate the spread of the
  SAME forecast (in memory, for every region too); the slot keeps the
  member sort from running once per metric.  Keyed by payload identity and
  holding the forecast, so that the ids stay valid; the engines clear it
  after each chunk and each evaluation.
  """
  key = (tuple((n, id(v.data)) for n, v in forecast.variables_dict().items()),
         ensemble_dim, bool(skipna))
  if _CRPS_SPREAD_CACHE.get("key") == key:
    return _CRPS_SPREAD_CACHE["result"]
  result = _pointwise_crps_spread(forecast, ensemble_dim, skipna)
  _CRPS_SPREAD_CACHE.clear()
  _CRPS_SPREAD_CACHE.update(key=key, forecast=forecast, result=result)
  return result


def _pointwise_crps_skill(forecast, truth, ensemble_dim: str,
                          skipna: bool) -> xds.Dataset:
  """CRPS skill E|X - Y| at each point."""
  _get_n_ensemble(forecast, ensemble_dim)
  return abs(truth - forecast).mean(ensemble_dim, skipna=skipna)


@dataclasses.dataclass
class CRPS(EnsembleMetric):
  """Continuous Ranked Probability Score: E|X-Y| - 0.5 E|X-X'|."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return CRPSSkill(self.ensemble_dim).compute_chunk(
        forecast, truth, region=region, skipna=skipna
    ) - 0.5 * CRPSSpread(self.ensemble_dim).compute_chunk(
        forecast, truth, region=region, skipna=skipna)


@dataclasses.dataclass
class CRPSSpread(EnsembleMetric):
  """The spread measure associated with CRPS, E|X - X'|."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _spatial_average(
        _pointwise_crps_spread_cached(forecast, self.ensemble_dim, skipna),
        region=region, skipna=skipna)


@dataclasses.dataclass
class CRPSSkill(EnsembleMetric):
  """The skill measure associated with CRPS, E|X - Y|."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _spatial_average(
        _pointwise_crps_skill(forecast, truth, self.ensemble_dim, skipna),
        region=region, skipna=skipna)


@dataclasses.dataclass
class SpatialCRPS(EnsembleMetric):
  """CRPS without spatial averaging."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return SpatialCRPSSkill(self.ensemble_dim).compute_chunk(
        forecast, truth, region=region, skipna=skipna
    ) - 0.5 * SpatialCRPSSpread(self.ensemble_dim).compute_chunk(
        forecast, truth, region=region, skipna=skipna)


@dataclasses.dataclass
class SpatialCRPSSpread(EnsembleMetric):
  """CRPSSpread without spatial averaging."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _pointwise_crps_spread_cached(forecast, self.ensemble_dim, skipna)


@dataclasses.dataclass
class SpatialCRPSSkill(EnsembleMetric):
  """CRPSSkill without spatial averaging."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _pointwise_crps_skill(forecast, truth, self.ensemble_dim, skipna)


def _gaussian_var_pairs(forecast: xds.Dataset) -> list:
  return [str(var) for var in forecast.keys()
          if f"{var}_std" in forecast.keys()]


def _pointwise_gaussian_crps(forecast, truth) -> xds.Dataset:
  """Closed-form CRPS of a Gaussian forecast (Gneiting et al. 2005)."""
  dataset = xds.Dataset({}, coords=dict(forecast.coords_dict()))
  for var_name in _gaussian_var_pairs(forecast):
    std = forecast[f"{var_name}_std"]
    norm_diff = (forecast[var_name] - truth[var_name]) / std
    dataset[var_name] = std * (
        norm_diff * (2 * _norm_cdf(norm_diff) - 1)
        + 2 * _norm_pdf(norm_diff) - 1 / math.sqrt(math.pi))
  return dataset


def _gaussian_variance(forecast) -> xds.Dataset:
  dataset = xds.Dataset({}, coords=dict(forecast.coords_dict()))
  for var_name in _gaussian_var_pairs(forecast):
    std = forecast[f"{var_name}_std"]
    dataset[var_name] = std * std
  return dataset


@dataclasses.dataclass
class GaussianCRPS(Metric):
  """The analytical formulation of CRPS for a Gaussian."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _spatial_average(_pointwise_gaussian_crps(forecast, truth),
                            region=region, skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del prepared, skipna
    if not _gaussian_var_pairs(forecast):
      return None
    return _pointwise_gaussian_crps(forecast, truth)


@dataclasses.dataclass
class GaussianVariance(Metric):
  """The variance of a Gaussian forecast."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    del truth
    return _spatial_average(_gaussian_variance(forecast), region=region,
                            skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del truth, prepared, skipna
    if not _gaussian_var_pairs(forecast):
      return None
    return _gaussian_variance(forecast)


@dataclasses.dataclass
class ThresholdMetric(Metric):
  """Base class for metrics based on climatological thresholds."""

  thresholds: t.Sequence[thresholds_lib.Threshold] = ()

  def prepare_chunk(self, forecast, truth, device=None):
    """The (coordinate-dependent) threshold datasets, on the host."""
    del forecast, device
    return [threshold.compute_cached(truth) for threshold in self.thresholds]

  def compute_chunk_prepared(self, forecast, truth, prepared, region=None,
                             skipna=False):
    self._prepared_thresholds = prepared
    try:
      return self.compute_chunk(forecast, truth, region=region, skipna=skipna)
    finally:
      self._prepared_thresholds = None

  def _threshold_scores(self, calculate_score, forecast, truth, prepared):
    """Each threshold's score, with a ``quantile`` dim of its own."""
    scores = []
    for i, threshold in enumerate(self.thresholds):
      threshold_ds = (prepared[i] if prepared is not None
                      else threshold.compute_cached(truth))
      score = calculate_score(forecast, truth, threshold_ds)
      scores.append(score.expand_dims({"quantile": [threshold.quantile]}))
    return scores

  def _concat_scores(self, scores) -> xds.Dataset:
    return xds.concat(scores, dim="quantile").assign_attrs(
        threshold_method=type(self.thresholds[0]).__name__)

  def _map_over_thresholds(self, calculate_score, forecast, truth, region,
                           skipna, spatial_agg) -> xds.Dataset:
    prepared = getattr(self, "_prepared_thresholds", None)
    if spatial_agg:
      score_fn = calculate_score
      calculate_score = lambda f, t_, thr: _spatial_average(
          score_fn(f, t_, thr), region=region, skipna=skipna)
    return self._concat_scores(self._threshold_scores(
        calculate_score, forecast, truth, prepared))

  def _pointwise_threshold_fields(self, calculate_score, forecast, truth,
                                  prepared) -> t.Optional[xds.Dataset]:
    """Pointwise per-threshold scores stacked along a `quantile` dim."""
    if not self.thresholds:
      return None
    return self._concat_scores(self._threshold_scores(
        calculate_score, forecast, truth, prepared))


def _indicator(condition: xds.DataArray) -> xds.DataArray:
  """A boolean DataArray as 0/1: float64 on the host, as in the JAX
  package; float32 on tensors, the type kernel 2 reads and the JAX
  package's on its chip (0 and 1 are exact, member means k/M within an
  ulp)."""
  return condition.astype(
      torch.float32 if _xp.is_tensor(condition.data) else np.float64)


def _binarize(condition: xds.Dataset) -> xds.Dataset:
  return condition.map(_indicator)


def _binarize_gt(ds: xds.Dataset, threshold: xds.Dataset) -> xds.Dataset:
  return _binarize(ds > threshold)


_PINF_SUFFIX = "__pinf"


def _inf_safe_fields(fields: xds.Dataset) -> xds.Dataset:
  """Replace ±inf cells with 0 and record them in companion indicator rows.

  Ignorance scores are -log(probability) and reach +inf wherever the
  forecast gives the observed category probability zero.  Inf cells must
  not enter the region kernel: a zero region weight times inf is NaN in the
  weighted sum, which would poison regions without the cell.  The indicator
  row rides the same launch; ``_inf_safe_finalize`` restores +inf for a
  region that holds an inf cell.  NaN cells pass (isinf(nan) is false).
  """
  out = xds.Dataset({}, coords=dict(fields.coords_dict()))
  for name in fields.keys():
    v = fields[name]
    is_inf = _indicator(abs(v) == np.inf)
    out[name] = xds.where(is_inf, 0.0, v)
    out[name + _PINF_SUFFIX] = is_inf
  return out.assign_attrs(**fields.attrs)


def _inf_safe_finalize(means: xds.Dataset) -> xds.Dataset:
  out = xds.Dataset({}, coords=dict(means.coords_dict()))
  for name in means.keys():
    if name.endswith(_PINF_SUFFIX):
      continue
    base = means[name]
    # a NaN regional mean (skipna=False with a NaN cell in the region) stays
    # NaN even when an inf cell is also present
    out[name] = xds.where(
        (means[name + _PINF_SUFFIX] > 0) & base.notnull(), np.inf, base)
  return out.assign_attrs(**means.attrs)


def _compute_gaussian_brier_score(forecast, truth, threshold):
  """Brier score for a Gaussian forecast distribution."""
  truth_probability = _binarize_gt(truth, threshold)
  exceedance = xds.Dataset({}, coords=dict(forecast.coords_dict()))
  for var_name in _gaussian_var_pairs(forecast):
    std = forecast[f"{var_name}_std"]
    norm_threshold = (threshold[var_name] - forecast[var_name]) / std
    exceedance[var_name] = 1 - _norm_cdf(norm_threshold)
  return (exceedance - truth_probability) ** 2


@dataclasses.dataclass
class GaussianBrierScore(ThresholdMetric):
  """Brier score of a Gaussian forecast at climatological thresholds."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return self._map_over_thresholds(
        _compute_gaussian_brier_score, forecast, truth, region=region,
        skipna=skipna, spatial_agg=True)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del skipna
    if not _gaussian_var_pairs(forecast):
      return None
    return self._pointwise_threshold_fields(
        _compute_gaussian_brier_score, forecast, truth, prepared)


def _compute_gaussian_ignorance_score(forecast, truth, threshold):
  """Ignorance (log) score for a Gaussian forecast distribution."""
  truth_probability = _binarize_gt(truth, threshold)
  out = xds.Dataset({}, coords=dict(forecast.coords_dict()))
  for var_name in _gaussian_var_pairs(forecast):
    std = forecast[f"{var_name}_std"]
    norm_threshold = (threshold[var_name] - forecast[var_name]) / std
    out[var_name] = -xds.where(truth_probability[var_name],
                               _log(_norm_cdf(-norm_threshold)),
                               _log(_norm_cdf(norm_threshold)))
  return out


@dataclasses.dataclass
class GaussianIgnoranceScore(ThresholdMetric):
  """Ignorance score of a Gaussian forecast at climatological thresholds."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return self._map_over_thresholds(
        _compute_gaussian_ignorance_score, forecast, truth, region=region,
        skipna=skipna, spatial_agg=True)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del skipna
    if not _gaussian_var_pairs(forecast):
      return None
    fields = self._pointwise_threshold_fields(
        _compute_gaussian_ignorance_score, forecast, truth, prepared)
    return None if fields is None else _inf_safe_fields(fields)

  def finalize_fused(self, means, skipna=False):
    del skipna
    return _inf_safe_finalize(means)


def _compute_gaussian_rps_part(forecast, truth, threshold):
  """One threshold's contribution to Gaussian RPS."""
  truth_ecdf = _binarize(truth < threshold)
  cdf_values = xds.Dataset({}, coords=dict(forecast.coords_dict()))
  for var_name in _gaussian_var_pairs(forecast):
    std = forecast[f"{var_name}_std"]
    norm_threshold = (threshold[var_name] - forecast[var_name]) / std
    cdf_values[var_name] = _norm_cdf(norm_threshold)
  return (cdf_values - truth_ecdf) ** 2


@dataclasses.dataclass
class GaussianRPS(ThresholdMetric):
  """Ranked probability score of a Gaussian forecast over thresholds."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return self._map_over_thresholds(
        _compute_gaussian_rps_part, forecast, truth, region=region,
        skipna=skipna, spatial_agg=True).sum("quantile")

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del skipna
    if not _gaussian_var_pairs(forecast):
      return None
    return self._pointwise_threshold_fields(
        _compute_gaussian_rps_part, forecast, truth, prepared)

  def finalize_fused(self, means, skipna=False):
    del skipna
    return means.sum("quantile")


def _single_member_zeros(forecast, ensemble_dim, region, skipna):
  """What the spread metrics give for one member: zeros of the result's
  shape."""
  return xds.zeros_like(
      _spatial_average(forecast, region=region, skipna=skipna).mean(
          ensemble_dim, skipna=skipna))


@dataclasses.dataclass
class EnsembleStddevSqrtBeforeTimeAvg(EnsembleMetric):
  """Area-averaged L2 norm of the ensemble standard deviation."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    del truth
    if _get_n_ensemble(forecast, self.ensemble_dim) == 1:
      return _single_member_zeros(forecast, self.ensemble_dim, region, skipna)
    return _spatial_average_l2_norm(
        forecast.std(self.ensemble_dim, ddof=1, skipna=skipna),
        region=region, skipna=skipna)


@dataclasses.dataclass
class EnsembleVariance(EnsembleMetric):
  """The variance of an ensemble of forecasts."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    del truth
    if _get_n_ensemble(forecast, self.ensemble_dim) == 1:
      return _single_member_zeros(forecast, self.ensemble_dim, region, skipna)
    return _spatial_average(
        forecast.var(self.ensemble_dim, ddof=1, skipna=skipna),
        region=region, skipna=skipna)


@dataclasses.dataclass
class SpatialEnsembleVariance(EnsembleMetric):
  """Ensemble variance without spatial averaging."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    del truth
    if _get_n_ensemble(forecast, self.ensemble_dim) == 1:
      return xds.zeros_like(forecast).mean(self.ensemble_dim, skipna=skipna)
    return forecast.var(self.ensemble_dim, ddof=1, skipna=skipna)


@dataclasses.dataclass
class EnsembleMeanRMSESqrtBeforeTimeAvg(EnsembleMetric):
  """RMSE between the ensemble mean and ground truth (sqrt before t-avg)."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    _get_n_ensemble(forecast, self.ensemble_dim)
    return _spatial_average_l2_norm(
        truth - forecast.mean(self.ensemble_dim, skipna=skipna),
        region=region, skipna=skipna)


@dataclasses.dataclass
class EnsembleMeanMSE(EnsembleMetric):
  """MSE between the ensemble mean and ground truth (bias σ²/n)."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    _get_n_ensemble(forecast, self.ensemble_dim)
    return _spatial_average(
        (truth - forecast.mean(self.ensemble_dim, skipna=skipna)) ** 2,
        region=region, skipna=skipna)


@dataclasses.dataclass
class DebiasedEnsembleMeanMSE(EnsembleMetric):
  """Unbiased MSE between ensemble mean and truth (requires n > 1)."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    _get_n_ensemble(forecast, self.ensemble_dim)
    return _spatial_average(
        _debiased_ensemble_mean_mse(forecast, truth, self.ensemble_dim,
                                    skipna=skipna),
        region=region, skipna=skipna)


@dataclasses.dataclass
class SpatialEnsembleMeanMSE(EnsembleMetric):
  """EnsembleMeanMSE without spatial averaging."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    _get_n_ensemble(forecast, self.ensemble_dim)
    return (truth - forecast.mean(self.ensemble_dim, skipna=skipna)) ** 2


@dataclasses.dataclass
class DebiasedSpatialEnsembleMeanMSE(EnsembleMetric):
  """DebiasedEnsembleMeanMSE without spatial averaging."""

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    _get_n_ensemble(forecast, self.ensemble_dim)
    return _debiased_ensemble_mean_mse(forecast, truth, self.ensemble_dim,
                                       skipna=skipna)


def _adjacent_differences(metric, forecast):
  """x[i] - x[i+1] over the member dim (M - 1 pairs)."""
  return (metric._ensemble_slice(forecast, slice(None, -1))
          - metric._ensemble_slice(forecast, slice(1, None)))


@dataclasses.dataclass
class EnergyScore(EnsembleMetric):
  """Energy score E‖X-Y‖ - 0.5 E‖X-X'‖ with adjacent-difference spread."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return EnergyScoreSkill(self.ensemble_dim).compute_chunk(
        forecast, truth, region=region, skipna=skipna
    ) - 0.5 * EnergyScoreSpread(self.ensemble_dim).compute_chunk(
        forecast, truth, region=region, skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    """Squared skill and spread difference fields; the L2 norm's sqrt and
    the member means come after the regional reduction (finalize_fused).
    Spread pairs get a ``{ensemble_dim}_pairs`` dim (one entry fewer than
    the member dim), and the member axis stays: (2M - 1) rows per
    variable-level and time."""
    del prepared, skipna
    if forecast.sizes.get(self.ensemble_dim, 0) < 2:
      return None
    skill = forecast - truth
    skill = skill * skill
    spread = _adjacent_differences(self, forecast)
    spread = (spread * spread).rename(
        {self.ensemble_dim: f"{self.ensemble_dim}_pairs"})
    out = xds.Dataset({}, coords={
        k: v for k, v in skill.coords_dict().items()
        if self.ensemble_dim not in v.dims})
    for name in truth.keys():
      out[f"__es_skill__{name}"] = skill[name].variable
      out[f"__es_spread__{name}"] = spread[name].variable
    return out

  def finalize_fused(self, means, skipna=False):
    pair_dim = f"{self.ensemble_dim}_pairs"
    out = xds.Dataset({}, coords={
        k: v for k, v in means.coords_dict().items()
        if not {self.ensemble_dim, pair_dim} & set(v.dims)})
    for name in means.keys():
      if not str(name).startswith("__es_skill__"):
        continue
      base = str(name)[len("__es_skill__"):]
      skill = _sqrt(means[name]).mean(self.ensemble_dim, skipna=skipna)
      spread = _sqrt(means[f"__es_spread__{base}"]).mean(pair_dim,
                                                         skipna=skipna)
      out[base] = (skill - 0.5 * spread).variable
    return out


@dataclasses.dataclass
class EnergyScoreSpread(EnsembleMetric):
  """Energy score spread, E‖X - X'‖, via N-1 adjacent differences."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    if _get_n_ensemble(forecast, self.ensemble_dim) == 1:
      return _single_member_zeros(forecast, self.ensemble_dim, region, skipna)
    return _spatial_average_l2_norm(
        _adjacent_differences(self, forecast), region=region,
        skipna=skipna).mean(self.ensemble_dim, skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del truth, prepared, skipna
    if forecast.sizes.get(self.ensemble_dim, 0) < 2:
      return None
    diff = _adjacent_differences(self, forecast)
    return diff * diff

  def finalize_fused(self, means, skipna=False):
    return _sqrt(means).mean(self.ensemble_dim, skipna=skipna)


@dataclasses.dataclass
class EnergyScoreSkill(EnsembleMetric):
  """Energy score skill, E‖X - Y‖."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    _get_n_ensemble(forecast, self.ensemble_dim)
    return _spatial_average_l2_norm(
        forecast - truth, region=region, skipna=skipna).mean(
            self.ensemble_dim, skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del prepared, skipna
    if self.ensemble_dim not in forecast.sizes:
      return None
    diff = forecast - truth
    return diff * diff

  def finalize_fused(self, means, skipna=False):
    return _sqrt(means).mean(self.ensemble_dim, skipna=skipna)


def _compute_brier_score(forecast, truth, threshold, ensemble_dim, debias,
                         skipna):
  """Brier score of an ensemble forecast for one threshold."""
  truth_probability = xds.where(truth.isnull(), np.nan,
                                _binarize_gt(truth, threshold))
  forecast_probability = xds.where(forecast.isnull(), np.nan,
                                   _binarize_gt(forecast, threshold))
  if debias:
    return _debiased_ensemble_mean_mse(
        forecast_probability, truth_probability, ensemble_dim, skipna=skipna)
  return (forecast_probability.mean(ensemble_dim, skipna=skipna)
          - truth_probability) ** 2


def _compute_ignorance_score(forecast, truth, threshold, ensemble_dim,
                             skipna):
  """Ignorance score of an ensemble forecast for one threshold."""
  truth_probability = _binarize_gt(truth, threshold)
  ensemble_forecast_probability = _binarize_gt(forecast, threshold).mean(
      ensemble_dim, skipna=skipna)
  return -xds.where(truth_probability, _log(ensemble_forecast_probability),
                    _log(1 - ensemble_forecast_probability))


def _compute_rps_part(forecast, truth, threshold, ensemble_dim, skipna):
  """One threshold's contribution to ensemble RPS."""
  truth_ecdf = _binarize(truth < threshold)
  ensemble_forecast_ecdf = _binarize(forecast < threshold).mean(
      ensemble_dim, skipna=skipna)
  return (ensemble_forecast_ecdf - truth_ecdf) ** 2


@dataclasses.dataclass
class _EnsembleThresholdMetric(EnsembleMetric, ThresholdMetric):
  """An ensemble score per threshold: ``_compute`` (with ``_kwargs``, the
  member dim and ``skipna``) for each threshold; ``_spatial`` keeps the
  per-cell map, ``_sum_quantiles`` sums over the thresholds (RPS)."""

  _compute: t.ClassVar[t.Callable] = None
  _kwargs: t.ClassVar[dict] = {}
  _spatial: t.ClassVar[bool] = False
  _sum_quantiles: t.ClassVar[bool] = False
  _min_members: t.ClassVar[int] = 1

  def _score(self, skipna):
    return functools.partial(type(self)._compute,
                             ensemble_dim=self.ensemble_dim, skipna=skipna,
                             **self._kwargs)

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    out = self._map_over_thresholds(
        self._score(skipna), forecast, truth, region=region, skipna=skipna,
        spatial_agg=not self._spatial)
    return out.sum("quantile") if self._sum_quantiles else out

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    if forecast.sizes.get(self.ensemble_dim, 0) < self._min_members:
      return None
    return self._pointwise_threshold_fields(self._score(skipna), forecast,
                                            truth, prepared)

  def finalize_fused(self, means, skipna=False):
    del skipna
    return means.sum("quantile") if self._sum_quantiles else means


@dataclasses.dataclass
class EnsembleBrierScore(_EnsembleThresholdMetric):
  """Brier score of an ensemble forecast at climatological thresholds."""

  supports_pointwise_fused: t.ClassVar[bool] = True
  _compute = staticmethod(_compute_brier_score)
  _kwargs = {"debias": False}


@dataclasses.dataclass
class SpatialEnsembleBrierScore(_EnsembleThresholdMetric):
  """Spatial map of ensemble Brier score."""

  _spatial = True
  _compute = staticmethod(_compute_brier_score)
  _kwargs = {"debias": False}


@dataclasses.dataclass
class DebiasedEnsembleBrierScore(_EnsembleThresholdMetric):
  """Debiased ensemble Brier score (requires n > 1)."""

  supports_pointwise_fused: t.ClassVar[bool] = True
  _min_members = 2
  _compute = staticmethod(_compute_brier_score)
  _kwargs = {"debias": True}


@dataclasses.dataclass
class SpatialDebiasedEnsembleBrierScore(_EnsembleThresholdMetric):
  """Spatial map of debiased ensemble Brier score."""

  _spatial = True
  _compute = staticmethod(_compute_brier_score)
  _kwargs = {"debias": True}


@dataclasses.dataclass
class EnsembleIgnoranceScore(_EnsembleThresholdMetric):
  """Ignorance score of an ensemble forecast at climatological thresholds."""

  supports_pointwise_fused: t.ClassVar[bool] = True
  _compute = staticmethod(_compute_ignorance_score)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    fields = super().pointwise_chunk(forecast, truth, prepared, skipna)
    return None if fields is None else _inf_safe_fields(fields)

  def finalize_fused(self, means, skipna=False):
    del skipna
    return _inf_safe_finalize(means)


@dataclasses.dataclass
class SpatialEnsembleIgnoranceScore(_EnsembleThresholdMetric):
  """Spatial map of ensemble ignorance score."""

  _spatial = True
  _compute = staticmethod(_compute_ignorance_score)


@dataclasses.dataclass
class EnsembleRPS(_EnsembleThresholdMetric):
  """Ranked probability score of an ensemble forecast over thresholds."""

  supports_pointwise_fused: t.ClassVar[bool] = True
  _sum_quantiles = True
  _compute = staticmethod(_compute_rps_part)


@dataclasses.dataclass
class SpatialEnsembleRPS(_EnsembleThresholdMetric):
  """Spatial map of ensemble RPS."""

  _spatial = True
  _sum_quantiles = True
  _compute = staticmethod(_compute_rps_part)


_BELOW_ONE = np.nextafter(np.float32(1), np.float32(0))


class RankHistogram(EnsembleMetric):
  """Histogram of truth's rank with respect to the ensemble members.

  One-hot over M+1 bins (optionally aggregated into ``num_bins`` that
  evenly divide M+1), with random tie breaking, in the JAX package's
  counting form: rank = (#members < truth) + floor(u·(#ties + 1)), with
  u ~ U[0, 1) drawn on the host by ``prepare_chunk`` (a fresh
  ``default_rng(seed)`` per call, variables in truth's order, float32), so
  that with a seed the counts equal the JAX package's (but where its draw
  rounds to 1, see ``prepare_chunk``).  NaN ranks above any value.
  """

  #: the arguments of ``__init__`` that are not dataclass fields, by the
  #: attribute that keeps each (``convert`` carries them across)
  init_attributes: t.ClassVar[dict] = {
      "num_bins": "num_bins", "break_ties_randomly": "_break_ties_randomly",
      "seed": "_seed"}

  def __init__(self, ensemble_dim: str = REALIZATION,
               num_bins: t.Optional[int] = None,
               break_ties_randomly: bool = True,
               seed: t.Optional[int] = None):
    super().__init__(ensemble_dim=ensemble_dim)
    self.num_bins = num_bins
    self._break_ties_randomly = break_ties_randomly
    self._seed = seed

  def _num_bins_actual(self, ensemble_size: int) -> int:
    default_n_bins = ensemble_size + 1
    if self.num_bins is None:
      return default_n_bins
    if default_n_bins % self.num_bins:
      raise ValueError(
          f"Cannot bin data with {ensemble_size=} into {self.num_bins} bins")
    return self.num_bins

  def prepare_chunk(self, forecast, truth, device=None):
    """Host-side tie-breaking draws: one uniform per non-member point.

    A float64 draw within 2**-25 of 1 rounds to 1.0 in float32 (about one
    point in 3e7), which would rank the truth past its ties, a bin too high
    even with none; the JAX package keeps those, the port keeps its draws
    below 1.  Every other draw is the JAX package's.
    """
    del device
    if not self._break_ties_randomly:
      return {}
    rng = np.random.default_rng(self._seed)
    out = {}
    for name in truth.keys():
      fda = forecast[name]
      dims = tuple(d for d in fda.dims if d != self.ensemble_dim)
      shape = tuple(fda.sizes[d] for d in dims)
      u = rng.uniform(size=shape).astype(np.float32)
      out[name] = xds.DataArray(np.minimum(u, _BELOW_ONE), dims=dims)
    return out

  def compute_chunk_prepared(self, forecast, truth, prepared, region=None,
                             skipna=False):
    del region, skipna  # rank histograms are unweighted and NaN-ranking
    ensemble_size = forecast.sizes[self.ensemble_dim]
    num_bins = self._num_bins_actual(ensemble_size)
    reduction_factor = (ensemble_size + 1) // num_bins
    out = xds.Dataset({}, coords={
        k: v for k, v in forecast.coords_dict().items()
        if self.ensemble_dim not in v.dims})
    bins_da = xds.DataArray(np.arange(num_bins, dtype=np.int32),
                            dims=("bins",),
                            coords={"bins": np.arange(num_bins)})
    for name in truth.keys():
      fda = forecast[name]
      tda = truth[name]
      # NaN ranks above any value: a member is below a NaN truth iff it is
      # itself valid; NaN-vs-NaN ties are not broken (``eq`` counts real
      # ties only), as in the JAX package
      lt = (fda < tda) | (tda.isnull() & fda.notnull())
      count_less = lt.astype(np.float32).sum(self.ensemble_dim)
      if self._break_ties_randomly:
        count_eq = (fda == tda).astype(np.float32).sum(self.ensemble_dim)
        count_less = count_less + (
            prepared[name] * (count_eq + 1.0)
        ).astype(np.int32).astype(np.float32)
      rank = count_less.astype(np.int32) // int(reduction_factor)
      out[name] = (rank == bins_da).astype(np.float32)
    return out.assign_coords(bins=np.arange(num_bins))

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return self.compute_chunk_prepared(
        forecast, truth, self.prepare_chunk(forecast, truth),
        region=region, skipna=skipna)


def central_reliability(hist: xds.Dataset) -> xds.Dataset:
  """Reliability diagram for central rank-histogram probabilities."""
  n_bins = hist.sizes["bins"]
  if n_bins < 3:
    raise ValueError(f"Too few bins. {n_bins=} but should be >= 3")
  left = hist.isel(bins=np.arange(n_bins // 2)[::-1])  # inside out
  right = hist.isel(bins=np.arange(n_bins // 2 + n_bins % 2, n_bins))
  linear_bins = np.arange(n_bins // 2)
  left = left.assign_coords(bins=linear_bins)
  right = right.assign_coords(bins=linear_bins)
  probs = (left + right).cumsum("bins").rename({"bins": "prob_index"})
  desired_prob_unnormalized = np.ones((n_bins // 2,))
  if n_bins % 2:
    probs = probs.assign_coords(prob_index=linear_bins + 1)
    center_prob = hist.isel(bins=n_bins // 2, drop=True)
    probs = xds.concat(
        [center_prob.expand_dims(prob_index=[0]), center_prob + probs],
        dim="prob_index")
    desired_prob_unnormalized = np.concatenate(
        ([0.5], desired_prob_unnormalized))
  else:
    probs = probs.assign_coords(prob_index=np.arange(n_bins // 2))
  desired_prob_unnormalized = np.cumsum(desired_prob_unnormalized)
  desired = desired_prob_unnormalized / desired_prob_unnormalized[-1]
  probs = probs.assign_coords(
      desired_prob=xds.Variable(("prob_index",), desired))
  return probs.swap_dims({"prob_index": "desired_prob"})


# The short names of the WeatherBench 2 documentation.
RMSE = RMSESqrtBeforeTimeAvg
EnsembleStddev = EnsembleStddevSqrtBeforeTimeAvg
EnsembleMeanRMSE = EnsembleMeanRMSESqrtBeforeTimeAvg

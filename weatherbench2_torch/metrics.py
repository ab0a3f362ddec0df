"""Deterministic verification metrics of the port's first slice.

Counterpart of ``weatherbench2_tpu/metrics.py:39-692``: latitude weights,
the spatial average, the ``Metric`` protocol, and ``MSE``,
``RMSESqrtBeforeTimeAvg``, ``MAE``, ``Bias`` and ``ACC``.  The math is
written against the labeled layer, which dispatches to torch when payloads
are tensors.  On the streaming path MSE/RMSE/MAE/Bias run through the fused
deterministic kernel and ACC through the pointwise tier
(``parallel/streaming.py``); ``compute_chunk`` is the unfused form.
"""
import dataclasses
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
  ``pointwise_chunk`` returns per-cell fields whose area-weighted regional
  means ``finalize_fused`` turns into the metric (the pointwise tier
  reduces them with ``ops.fused_region_sums``).  ``compute_chunk`` is the
  reference-parity unfused entry point.
  """

  #: metrics whose chunk value is an area-weighted regional mean of
  #: per-cell fields (optionally post-processed by ``finalize_fused``)
  supports_pointwise_fused: t.ClassVar[bool] = False

  def prepare_chunk(self, forecast: xds.Dataset, truth: xds.Dataset,
                    device=None) -> t.Any:
    """Host-side, coordinate-dependent preparation for a chunk.

    ``device`` is where the chunk will be computed; a metric may keep
    chunk-independent state resident there.
    """
    del forecast, truth, device
    return None

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    """Per-cell fields whose weighted regional mean feeds finalize_fused."""
    del forecast, truth, prepared, skipna
    return None

  def finalize_fused(self, means: xds.Dataset, skipna: bool = False):
    """Regional means of ``pointwise_chunk`` fields -> metric result."""
    del skipna
    return means

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    """Evaluate this metric on a temporal chunk of data."""
    raise NotImplementedError


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


def _no_wind_vectors(wind_vectors):
  if wind_vectors is not None:
    raise NotImplementedError(
        "wind-vector metrics are not ported yet (ROADMAP A.9)")


@dataclasses.dataclass
class RMSESqrtBeforeTimeAvg(Metric):
  """RMSE with the square root taken before time averaging."""

  wind_vector_rmse: t.Optional[list] = None

  supports_pointwise_fused: t.ClassVar[bool] = True

  def __post_init__(self):
    _no_wind_vectors(self.wind_vector_rmse)

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _sqrt(_spatial_average((forecast - truth) ** 2, region=region,
                                  skipna=skipna))

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del prepared, skipna
    diff = forecast - truth
    return diff * diff

  def finalize_fused(self, means, skipna=False):
    del skipna
    return _sqrt(means)


@dataclasses.dataclass
class MSE(Metric):
  """Mean squared error."""

  wind_vector_mse: t.Optional[list] = None

  supports_pointwise_fused: t.ClassVar[bool] = True

  def __post_init__(self):
    _no_wind_vectors(self.wind_vector_mse)

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _spatial_average((forecast - truth) ** 2, region=region,
                            skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del prepared, skipna
    diff = forecast - truth
    return diff * diff


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
class Bias(Metric):
  """Mean error."""

  supports_pointwise_fused: t.ClassVar[bool] = True

  def compute_chunk(self, forecast, truth, region=None, skipna=False):
    return _spatial_average(forecast - truth, region=region, skipna=skipna)

  def pointwise_chunk(self, forecast, truth, prepared, skipna):
    del prepared, skipna
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

"""Climatology statistics, the probabilistic climatology and resampling in
time.

Counterpart of ``weatherbench2_tpu/utils.py``: the rolling day-of-year
(and hour-of-day) climatology statistics, the weighted quantile, the
probabilistic climatology (years of the truth as ensemble members), and
resampling and rolling windows in time.  The time code is numpy only (the
card's machine has no pandas): timedelta strings, date and timedelta
ranges, and the resampling plan are ``datetime64``/``timedelta64``
arithmetic on the host; the bin reductions and rolling windows run on the
payload's device (segment sums, cumulative sums, windowed extremes).

Each statistic takes a Dataset whose payloads are numpy arrays or tensors.
Either way it runs as torch ops (``ops.climatology``): numpy payloads as
float64 CPU tensors, the precision of the JAX package's host path, and back
to numpy; tensors on their device, in float32 as the JAX package's device
path (daily means in float64, for the window quantiles).  The years are
stacked to (year, dayofyear, ...) by one gather, the window is a circulant
matmul, a day-of-year group is an ``index_add_``, and a quantile one sort
per pencil.
A callable statistic receives the stacked windows as in the JAX package.

``make_probabilistic_climatology`` builds every year x hour at once, as the
JAX package does: at the official scale (30 years of 1.5° truth, 17
variable-levels) that is tens of GB of host memory.  The engines use
``ProbabilisticClimatology`` instead, which gives the same members for the
valid times of one chunk, read from the truth store year by year.
"""
from __future__ import annotations

import functools
import re
from typing import Callable, Union

import numpy as np
import torch

from weatherbench2_torch import xds
from weatherbench2_torch.ops import climatology as clim_ops
from weatherbench2_torch.xds import _xp


def open_nc(filename: str) -> xds.Dataset:
  """Open a NetCDF3 file from the filesystem."""
  return xds.open_netcdf(filename)


def random_like(dataset: xds.Dataset, seed: int = 0) -> xds.Dataset:
  """Random normal dataset configured like ``dataset``: float64 draws of
  ``np.random.RandomState(seed)``, the JAX package's, so fixtures made by
  either package are equal."""
  rs = np.random.RandomState(seed)
  return dataset.copy(data={k: rs.normal(size=v.shape)
                            for k, v in dataset.variables_dict().items()})


def replace_time_with_doy(ds: xds.Dataset) -> xds.Dataset:
  """Replace time coordinate with days of year."""
  doy = ds["time"].dt.dayofyear.values
  return ds.assign_coords(time=doy).rename({"time": "dayofyear"})


def select_hour(ds: xds.Dataset, hour: int) -> xds.Dataset:
  """Select a given hour of day from a Dataset."""
  hours = ds["time"].dt.hour.values
  ds = ds.isel(time=np.nonzero(hours == hour)[0])
  time = np.asarray(ds.coords_dict()["time"].data)
  return ds.assign_coords(
      time=time.astype("datetime64[D]").astype("datetime64[ns]"))


def reindex_with_nan(ds: xds.Dataset, dim: str,
                     new_labels: np.ndarray) -> xds.Dataset:
  """Reindex `dim` onto new_labels, filling missing labels with NaN."""
  new_labels = np.asarray(new_labels)
  old = np.asarray(ds.coords_dict()[dim].data)
  pos = {v: i for i, v in enumerate(old.tolist())}
  idx = np.array([pos.get(v, -1) for v in new_labels.tolist()])
  sel = ds.isel({dim: np.where(idx >= 0, idx, 0)})
  if (idx >= 0).all():
    return sel.assign_coords({dim: new_labels})
  filled = {}
  for name in sel.keys():
    da = sel[name]
    if dim not in da.dims:
      continue
    vals = np.asarray(da.values, dtype=np.float64).copy()
    key = [slice(None)] * vals.ndim
    key[da.dims.index(dim)] = idx < 0
    vals[tuple(key)] = np.nan
    filled[name] = vals
  return sel.copy(data=filled).assign_coords({dim: new_labels})


def make_probabilistic_climatology(
    ds: xds.Dataset, start_year: int, end_year: int, hour_interval: int
) -> xds.Dataset:
  """Stack years as an ensemble. Day 366 only has data for leap years."""
  hours = np.arange(0, 24, hour_interval)
  years = np.arange(start_year, end_year + 1)
  out = []
  for hour in hours:
    datasets = []
    for year in years:
      tmp = select_hour(ds, int(hour)).sel(time=str(year))
      doy = tmp["time"].dt.dayofyear.values
      tmp = tmp.assign_coords(dayofyear=xds.Variable(("time",), doy))
      tmp = tmp.swap_dims({"time": "dayofyear"})
      tmp = tmp.drop_vars(
          [n for n in ("time",) if n in tmp.coords_dict()], errors="ignore")
      datasets.append(tmp)
    # pad all years to a common dayofyear axis (leap years have day 366)
    all_doys = np.array(sorted(set(np.concatenate([
        np.asarray(d.coords_dict()["dayofyear"].data) for d in datasets
    ]).tolist())))
    padded = [reindex_with_nan(d, "dayofyear", all_doys) for d in datasets]
    out.append(xds.concat(
        [p.expand_dims(number=[i]) for i, p in enumerate(padded)], "number"))
  return xds.concat([o.expand_dims(hour=[h]) for o, h in zip(out, hours)],
                    "hour")


# the dim of the distinct (day of year, hour) pairs of a chunk's members
MEMBER_PAIR = "__pclim_pair"


class ProbabilisticClimatology:
  """The members of ``make_probabilistic_climatology``, read per chunk.

  Member ``number = i`` of a valid time is the truth at the same day of
  year and hour in year ``start_year + i`` (paired by day of year, not by
  date), or NaN where that year has no such day (day 366 outside leap
  years).  As in the JAX package, a year with no truth at one of the hours
  ``0, hour_interval, ...`` raises ``KeyError``, and so does a (day of year,
  hour) that no year holds or an hour off that grid.
  """

  def __init__(self, truth: xds.Dataset, start_year: int, end_year: int,
               hour_interval: int):
    self.truth = truth
    self.hours = np.arange(0, 24, hour_interval)
    self.years = np.arange(start_year, end_year + 1)
    times = np.asarray(truth.coords_dict()["time"].data).astype(
        "datetime64[ns]")
    year = times.astype("datetime64[Y]").astype(np.int64) + 1970
    day = times.astype("datetime64[D]")
    doy = (day - times.astype("datetime64[Y]")).astype(np.int64) + 1
    hour = (times - day).astype("timedelta64[h]").astype(np.int64)
    for h in self.hours:
      for y in self.years:
        if not np.any((year == y) & (hour == h)):
          raise KeyError(f"no truth at hour {h} of year {y}")
    # (year, doy, hour) -> truth position; a repeated time keeps its last
    self._position = {key: i for i, key in enumerate(
        zip(year.tolist(), doy.tolist(), hour.tolist()))}

  @property
  def size(self) -> int:
    """Members: one per year."""
    return len(self.years)

  def compact_members(self, times: xds.DataArray, names):
    """(members, index): the members of each distinct (day of year, hour)
    of ``times``, dims (``__pclim_pair``, number, ...), and the int64 index
    of each time's pair, with ``times``' dims; ``members.isel(__pclim_pair=
    index)`` are the members of every time."""
    doy = times.dt.dayofyear.values.ravel()
    hour = times.dt.hour.values.ravel()
    off_grid = np.setdiff1d(hour, self.hours)
    if off_grid.size:
      raise KeyError(f"hours {off_grid.tolist()} are not in the "
                     f"probabilistic climatology's {self.hours.tolist()}")
    pairs, inverse = np.unique(np.stack([doy, hour], axis=1), axis=0,
                               return_inverse=True)
    pos = np.array([[self._position.get((int(y), int(d), int(h)), -1)
                     for y in self.years] for d, h in pairs])
    lost = np.all(pos < 0, axis=1)
    if lost.any():
      raise KeyError(f"no year holds (dayofyear, hour) "
                     f"{pairs[lost][0].tolist()}")
    gather = xds.Variable((MEMBER_PAIR, "number"),
                          np.where(pos >= 0, pos, 0))
    members = self.truth[list(names)].isel(time=gather, drop=True)
    members = members.drop_vars(
        [k for k, v in members.coords_dict().items()
         if MEMBER_PAIR in v.dims])
    if (pos < 0).any():
      members = members.where(
          xds.DataArray(pos >= 0, dims=(MEMBER_PAIR, "number")))
    members = members.assign_coords(number=np.arange(self.size))
    index = xds.DataArray(inverse.reshape(times.shape).astype(np.int64),
                          dims=times.dims)
    return members, index

  def members(self, times: xds.DataArray, names) -> xds.Dataset:
    """The members of every time of ``times``, expanded on the host."""
    members, index = self.compact_members(times, names)
    return members.isel({MEMBER_PAIR: index})


# -- climatology statistics ---------------------------------------------------


def _is_tensor_ds(ds: xds.Dataset) -> bool:
  return any(_xp.is_tensor(v.data) for v in ds.variables_dict().values())


def _host_in_float64(fn):
  """Numpy payloads go through ``fn``'s tensor code as float64 CPU tensors
  (the JAX package's host path forms float64) and come back as numpy;
  tensor payloads go straight through."""

  @functools.wraps(fn)
  def wrapped(ds: xds.Dataset, *args, **kwargs):
    if _is_tensor_ds(ds):
      return fn(ds, *args, **kwargs)
    out = fn(ds.copy(data={
        k: torch.from_numpy(np.asarray(v.data, np.float64))
        for k, v in ds.variables_dict().items()}), *args, **kwargs)
    return out.copy(data={k: _xp.to_numpy(v.data)
                          for k, v in out.variables_dict().items()})

  return wrapped


def _as_float32(ds: xds.Dataset) -> xds.Dataset:
  """Tensor payloads in float32, the JAX package's device precision (daily
  means come float64, for the window quantiles)."""
  return ds.copy(data={k: v.data.to(torch.float32)
                       for k, v in ds.variables_dict().items()})


def create_window_weights(window_size: int) -> xds.DataArray:
  """Create linearly decaying (triangular) window weights."""
  if window_size % 2 != 1:
    raise ValueError("Window size must be odd.")
  half_window_size = window_size // 2
  window_weights = np.concatenate([
      np.linspace(0, 1, half_window_size + 1),
      np.linspace(1, 0, half_window_size + 1)[1:],
  ])
  window_weights = window_weights / window_weights.mean()
  return xds.DataArray(window_weights, dims=("window",))


def _windowed_stack(values, axis: int, window: int):
  """Stack circular rolling windows; the window axis is appended LAST."""
  half = window // 2
  n = values.shape[axis]
  idx = (np.arange(n)[:, None] + np.arange(-half, half + 1)[None, :]) % n
  out = values.movedim(axis, -1)[..., torch.as_tensor(
      idx, device=values.device)]  # (..., n, window)
  return out.movedim(-2, axis)


def weighted_quantile(values, q, weights, axis: int = -1,
                      skipna: bool = True):
  """Interpolated weighted quantile along one axis, the quantile axis
  first.

  The standard weighted-percentile estimator: sort values, form the
  normalized cumulative-weight positions p_k = (cumw_k - w_k/2) / W, and
  linearly interpolate q over (p_k, v_k); NaNs carry zero weight.  One
  sort per pencil on the tensor's device
  (``ops.climatology.sorted_weighted_quantile``), in float32; a numpy
  array runs as a float64 CPU tensor (the precision of the JAX package's
  host path) and comes back as numpy.
  """
  if not skipna:
    raise NotImplementedError("weighted_quantile skips NaNs")
  host = not _xp.is_tensor(values)
  dtype = torch.float64 if host else torch.float32
  if host:
    values = torch.from_numpy(np.asarray(values, np.float64))
  w = torch.as_tensor(weights if _xp.is_tensor(weights)
                      else np.asarray(weights), dtype=dtype,
                      device=values.device)
  if w.ndim == values.ndim:
    w = w.movedim(axis, -1)
  v = values.to(dtype).movedim(axis, -1)
  w = torch.broadcast_to(w, v.shape)
  out = clim_ops.sorted_weighted_quantile(
      v.reshape(-1, v.shape[-1]), w.reshape(-1, v.shape[-1]), q)
  out = out.T.reshape((out.shape[-1],) + tuple(v.shape[:-1]))
  return out.numpy() if host else out


def _year_doy(times: np.ndarray):
  times = np.asarray(times).astype("datetime64[ns]")
  year = times.astype("datetime64[Y]").astype(np.int64) + 1970
  doy = (times.astype("datetime64[D]")
         - times.astype("datetime64[Y]")).astype(np.int64) + 1
  return year, doy


@_host_in_float64
def stack_years(ds: xds.Dataset) -> xds.Dataset:
  """Each variable as (year, dayofyear, *other dims): one gather of the
  time axis, NaN where a year lacks a day; where days 365 and 366 are both
  present every NaN takes its year's day 365 (the JAX package's
  ``stacked.fillna(stacked.sel(dayofyear=365))``).  A day that a year
  holds twice keeps its last time, as ``reindex_with_nan`` does."""
  year, doy = _year_doy(ds.coords_dict()["time"].data)
  years, yi = np.unique(year, return_inverse=True)
  doys, di = np.unique(doy, return_inverse=True)
  pos = np.full((len(years), len(doys)), -1, np.int64)
  np.maximum.at(pos, (yi, di), np.arange(len(year)))
  missing = pos < 0
  fill = 365 in doys and 366 in doys
  out = xds.Dataset({}, coords={
      **{k: v for k, v in ds.coords_dict().items() if "time" not in v.dims},
      "year": years, "dayofyear": doys})
  for name in ds.keys():
    da = ds[name]
    ax = da.dims.index("time")
    moved = da.data.movedim(ax, 0)
    stacked = moved[torch.as_tensor(np.where(missing, 0, pos),
                                    device=moved.device)]
    if missing.any():
      mask = missing.reshape(missing.shape + (1,) * (moved.ndim - 1))
      stacked = torch.where(torch.as_tensor(mask, device=stacked.device),
                            torch.nan, stacked)
    if fill:
      d365 = stacked[:, int(np.searchsorted(doys, 365))][:, None]
      stacked = torch.where(torch.isnan(stacked), d365, stacked)
    rest = tuple(d for d in da.dims if d != "time")
    out[name] = xds.Variable(("year", "dayofyear") + rest, stacked, da.attrs)
  return out


@_host_in_float64
def build_stacked_windows(ds: xds.Dataset,
                          window_weights: xds.DataArray) -> xds.Dataset:
  """Stack (year, wrapped dayofyear window) for each variable.

  Returns a Dataset whose variables have dims
  ``(year,) + original_dims_with_dayofyear + ('window',)``.
  """
  window_size = len(window_weights.values)
  stacked = stack_years(ds)
  out = xds.Dataset({}, coords=dict(stacked.coords_dict()))
  for name in stacked.keys():
    dims = ("year",) + _doy_dims(ds[name])
    v = stacked[name].transpose(*dims)
    out[name] = xds.Variable(
        dims + ("window",),
        _windowed_stack(v.data, dims.index("dayofyear"), window_size))
  return out


def _doy_dims(da) -> tuple:
  return tuple("dayofyear" if d == "time" else d for d in da.dims)


def compute_rolling_stat(
    ds: xds.Dataset,
    window_weights: xds.DataArray,
    stat_fn: Union[str, Callable] = "mean",
) -> xds.Dataset:
  """Rolling climatology over a wrapped dayofyear axis.

  Stack years, fill the leap-day gap (366) with day 365, apply a periodic
  weighted rolling window over dayofyear, and reduce over (window, year).
  A callable ``stat_fn`` receives the full stacked-window Dataset:
  ``stat_fn(stacked_ds, weights=window_weights, dim=('window', 'year'))``.
  'mean' and 'std' are ``ops.climatology.device_rolling_clim``.
  """
  if callable(stat_fn):
    stacked = build_stacked_windows(ds, window_weights)
    return stat_fn(stacked, weights=window_weights, dim=("window", "year"))
  if stat_fn not in ("mean", "std"):
    raise NotImplementedError(f"stat {stat_fn!r} not implemented")
  if _is_tensor_ds(ds):
    ds = _as_float32(ds)
  return _rolling_stat(ds, window_weights.values, stat_fn)


@_host_in_float64
def _rolling_stat(ds: xds.Dataset, w: np.ndarray, stat: str) -> xds.Dataset:
  stacked = stack_years(ds)
  out = xds.Dataset({}, coords={
      k: v for k, v in stacked.coords_dict().items() if k != "year"})
  for name in stacked.keys():
    res = clim_ops.device_rolling_clim(stacked[name].data, w, stat)
    out[name] = xds.Variable(stacked[name].dims[1:], res).transpose(
        *_doy_dims(ds[name]))
  return out


def _group_sums(data, inverse: np.ndarray, n_groups: int, ax: int):
  """(sums, valid counts) of ``data`` over groups of its axis ``ax``, NaN
  dropped, the group axis first: one ``index_add_`` each."""
  moved = data.movedim(ax, 0)
  nan = torch.isnan(moved)
  idx = torch.as_tensor(inverse, device=data.device)
  shape = (n_groups,) + tuple(moved.shape[1:])
  sums = torch.zeros(shape, dtype=data.dtype, device=data.device)
  sums.index_add_(0, idx, torch.where(nan, 0.0, moved))
  counts = torch.zeros(shape, dtype=data.dtype, device=data.device)
  counts.index_add_(0, idx, (~nan).to(data.dtype))
  return sums, counts


@_host_in_float64
def resample_daily_mean(ds: xds.Dataset) -> xds.Dataset:
  """Resample time to daily means (like ``obs.resample(time='D').mean()``),
  NaN skipped, a day without data NaN."""
  days = ds["time"].dt.floor("D").values
  unique_days, inverse = np.unique(days, return_inverse=True)
  out = xds.Dataset({}, coords={
      k: v for k, v in ds.coords_dict().items() if "time" not in v.dims})
  for name in ds.keys():
    da = ds[name]
    ax = da.dims.index("time")
    # float64, as the JAX package's host path: the window quantiles of
    # daily means are sorted in the precision it forms them in
    sums, counts = _group_sums(da.data.to(torch.float64), inverse,
                               len(unique_days), ax)
    mean = torch.where(counts == 0, torch.nan, sums / counts)
    out[name] = xds.Variable(da.dims, mean.movedim(0, ax))
  return out.assign_coords(time=unique_days)


def compute_daily_stat(obs: xds.Dataset, window_size: int, clim_years: slice,
                       stat_fn: Union[str, Callable] = "mean"
                       ) -> xds.Dataset:
  """Compute daily average climatology with running window."""
  obs_daily = resample_daily_mean(obs.sel(time=clim_years))
  return compute_rolling_stat(obs_daily, create_window_weights(window_size),
                              stat_fn)


def compute_hourly_stat(obs: xds.Dataset, window_size: int,
                        clim_years: slice, hour_interval: int,
                        stat_fn: Union[str, Callable] = "mean"
                        ) -> xds.Dataset:
  """Compute climatology by day of year and hour of day."""
  hours = np.arange(0, 24, hour_interval)
  window_weights = create_window_weights(window_size)
  return xds.concat([
      compute_rolling_stat(select_hour(obs.sel(time=clim_years), int(hour)),
                           window_weights, stat_fn).expand_dims(hour=[hour])
      for hour in hours], "hour")


def smooth_dayofyear_variable_with_rolling_window(
    obs_dayofyear: xds.Dataset, window_size: int) -> xds.Dataset:
  """Smooth day-of-year values with a circular weighted rolling window:
  the weighted sum of the valid values over the unweighted count of valid
  window positions (the zero-weight edges included), as the JAX package
  does."""
  if "dayofyear" not in obs_dayofyear.sizes:
    raise ValueError("dayofyear must be a dimension.")
  if _is_tensor_ds(obs_dayofyear):
    obs_dayofyear = _as_float32(obs_dayofyear)
  return _smooth(obs_dayofyear, create_window_weights(window_size).values)


@_host_in_float64
def _smooth(obs_dayofyear: xds.Dataset, w: np.ndarray) -> xds.Dataset:
  out = xds.Dataset({}, coords=dict(obs_dayofyear.coords_dict()))
  for name in obs_dayofyear.keys():
    da = obs_dayofyear[name]
    ax = da.dims.index("dayofyear")
    acc, count = clim_ops.rolling_window_sums(da.data.movedim(ax, 0), w)
    mean = torch.where(count == 0, torch.nan, acc / count)
    out[name] = xds.Variable(da.dims, mean.movedim(0, ax))
  return out


@_host_in_float64
def _groupby_dayofyear(ds: xds.Dataset, stat: str) -> xds.Dataset:
  """``groupby('time.dayofyear').mean()/std()``, NaN skipped (ddof 0)."""
  if stat not in ("mean", "std"):
    raise NotImplementedError(stat)
  doy = ds["time"].dt.dayofyear.values
  unique_doy, inverse = np.unique(doy, return_inverse=True)
  out = xds.Dataset({}, coords={
      k: v for k, v in ds.coords_dict().items() if "time" not in v.dims})
  for name in ds.keys():
    da = ds[name]
    ax = da.dims.index("time")
    sums, counts = _group_sums(da.data, inverse, len(unique_doy), ax)
    mean = sums / counts  # NaN where a day has no valid value
    if stat == "std":
      dev = da.data.movedim(ax, 0) - mean[torch.as_tensor(
          inverse, device=mean.device)]
      sq, _ = _group_sums((dev * dev).movedim(0, ax), inverse,
                          len(unique_doy), ax)
      mean = torch.sqrt(sq / counts)
    out[name] = xds.Variable(_doy_dims(da), mean.movedim(0, ax))
  return out.assign_coords(dayofyear=unique_doy)


def compute_daily_climatology_std(obs: xds.Dataset, window_size: int,
                                  clim_years: slice) -> xds.Dataset:
  """Daily climatological std with rolling window ('fast' method)."""
  obs_daily = resample_daily_mean(obs.sel(time=clim_years))
  return smooth_dayofyear_variable_with_rolling_window(
      _groupby_dayofyear(obs_daily, "std"), window_size)


def compute_daily_climatology_mean(obs: xds.Dataset, window_size: int,
                                   clim_years: slice) -> xds.Dataset:
  """Daily climatological mean with rolling window ('fast' method)."""
  return smooth_dayofyear_variable_with_rolling_window(
      _groupby_dayofyear(obs.sel(time=clim_years), "mean"), window_size)


def _hourly_fast(obs, window_size, clim_years, hour_interval, stat):
  obs = obs.sel(time=clim_years)
  return xds.concat([
      smooth_dayofyear_variable_with_rolling_window(
          _groupby_dayofyear(select_hour(obs, int(hour)), stat), window_size
      ).expand_dims(hour=[hour])
      for hour in np.arange(0, 24, hour_interval)], "hour")


def compute_hourly_climatology_mean_fast(obs: xds.Dataset, window_size: int,
                                         clim_years: slice,
                                         hour_interval: int = 1
                                         ) -> xds.Dataset:
  """Climatology mean by day of year and hour of day ('fast' method)."""
  return _hourly_fast(obs, window_size, clim_years, hour_interval, "mean")


def compute_hourly_climatology_std_fast(obs: xds.Dataset, window_size: int,
                                        clim_years: slice,
                                        hour_interval: int = 1
                                        ) -> xds.Dataset:
  """Climatology std by day of year and hour of day ('fast' method)."""
  return _hourly_fast(obs, window_size, clim_years, hour_interval, "std")


def compute_hourly_stat_fast(obs: xds.Dataset, window_size: int,
                             clim_years: slice, hour_interval: int,
                             stat_fn: str = "mean") -> xds.Dataset:
  """Climatology mean or std by day of year and hour of day."""
  if stat_fn not in ("mean", "std"):
    raise NotImplementedError(f"stat {stat_fn} not implemented.")
  return _hourly_fast(obs, window_size, clim_years, hour_interval, stat_fn)


def compute_daily_stat_fast(obs: xds.Dataset, window_size: int,
                            clim_years: slice, stat_fn: str = "mean"
                            ) -> xds.Dataset:
  """Climatology mean or std by day of year."""
  if stat_fn == "mean":
    return compute_daily_climatology_mean(obs, window_size, clim_years)
  if stat_fn == "std":
    return compute_daily_climatology_std(obs, window_size, clim_years)
  raise NotImplementedError(f"stat {stat_fn} not implemented.")


# -- time without pandas ------------------------------------------------------


def normalize_timedelta_str(s):
  """Day and week units of a timedelta string in upper case ("1d" ->
  "1D"), as the JAX package writes the scripts' strings for pandas; the
  port's parser takes either case."""
  if not isinstance(s, str):
    return s
  return re.sub(r"(\d\s*)([dw])\b",
                lambda m: m.group(1) + m.group(2).upper(), s)


def to_timedelta(s) -> np.timedelta64:
  """A timedelta64[ns] from a count and a unit ("6h", "1d", "1w", "30min",
  "15 days", "6 hours") or a timedelta; any other string raises, naming
  it."""
  return xds.core.to_timedelta64(normalize_timedelta_str(s))


def date_range(start, stop, step) -> np.ndarray:
  """datetime64[ns] from ``start`` to ``stop``, both included, every
  ``step`` (``pd.date_range(start, stop, freq=step).values``)."""
  start = np.datetime64(start, "ns")
  stop = np.datetime64(stop, "ns")
  return np.arange(start, stop + np.timedelta64(1, "ns"), to_timedelta(step))


def timedelta_range(start, stop, step) -> np.ndarray:
  """timedelta64[ns] from ``start`` to ``stop``, both included, every
  ``step`` (``pd.timedelta_range(start, stop, freq=step).values``)."""
  start, stop = to_timedelta(start), to_timedelta(stop)
  return np.arange(start, stop + np.timedelta64(1, "ns"), to_timedelta(step))


def time_parts(times):
  """(year, day of year, hour) of datetime64 ``times``, int64."""
  times = np.asarray(times).astype("datetime64[ns]")
  year, doy = _year_doy(times)
  hour = (times - times.astype("datetime64[D]")) // np.timedelta64(1, "h")
  return year, doy, hour.astype(np.int64)


# -- resampling in time -------------------------------------------------------

STATISTICS = ("mean", "min", "max", "sum")


def resample_time_plan(times, period, label: str = "left",
                       origin: str = "start_day"):
  """Host-side binning plan for resampling a sorted time axis.

  Returns ``(label_times, starts, ends)``: output bin labels plus, per bin,
  the half-open input position range [starts[i], ends[i]) feeding it.
  ``label="left"``: bins [T, T + period) labelled T; ``"right"``: bins
  (T - period, T] labelled T, the first bin dropped.  Every bin between
  the first and the last occupied one is emitted, an empty one as an empty
  range (NaN rows downstream), so that the output axis is regular across
  gaps.  The bins count from the first time's midnight (``start_day``) or
  from the first time.  A decreasing time axis raises.
  """
  period64 = to_timedelta(period)
  times = np.asarray(times).astype("datetime64[ns]")
  origin_ts = (times[0].astype("datetime64[D]").astype("datetime64[ns]")
               if origin == "start_day" else times[0])
  if len(times) > 1 and not (np.diff(times) >= np.timedelta64(0)).all():
    raise ValueError(
        "resampling requires a monotonically increasing time axis; "
        "sort the input (e.g. via slice_dataset) first")
  offs = times - origin_ts
  if label == "left":
    bins = offs // period64
  elif label == "right":
    bins = -((-offs) // period64)  # ceil: (T - period, T] -> bin index
  else:
    raise ValueError(f"Unhandled {label=}")
  occupied, occ_starts = np.unique(bins, return_index=True)
  occ_ends = np.append(occ_starts[1:], len(times))
  labels_idx = np.arange(int(occupied[0]), int(occupied[-1]) + 1)
  # an empty bin is the empty range at the end of the bins before it
  where = np.searchsorted(occupied, labels_idx)
  full = occupied[np.minimum(where, len(occupied) - 1)] == labels_idx
  ends = np.where(full, occ_ends[np.minimum(where, len(occupied) - 1)],
                  np.concatenate([[0], occ_ends])[where])
  starts = np.where(full, occ_starts[np.minimum(where, len(occupied) - 1)],
                    ends)
  label_times = origin_ts + labels_idx * period64
  if label == "right":
    label_times, starts, ends = label_times[1:], starts[1:], ends[1:]
  return label_times, starts.astype(np.int64), ends.astype(np.int64)


def _as_time_first_tensor(data, ax: int):
  """(tensor with the time axis first, whether ``data`` was on the
  host)."""
  host = not _xp.is_tensor(data)
  x = torch.from_numpy(np.asarray(data)) if host else data
  return x.movedim(ax, 0), host


def _segment_counts(mask, seg, n_bins):
  """Per-bin counts of ``mask`` (bins along axis 0), float64."""
  out = torch.zeros((n_bins,) + tuple(mask.shape[1:]), dtype=torch.float64,
                    device=mask.device)
  return out.index_add_(0, seg, mask.to(torch.float64))


def bin_reduce(x, starts, ends, statistic: str, skipna: bool = False):
  """The ``statistic`` of each range [starts[i], ends[i]) of ``x``'s first
  axis, float64, as segment reductions on ``x``'s device: ``index_add_``
  for mean and sum (accumulated in float64), ``scatter_reduce_`` for min
  and max.  A range with a NaN is NaN, or with ``skipna`` the NaNs are
  left out (numpy's nan* functions: a sum of none is 0, a mean, min or max
  of none NaN); an empty range is NaN."""
  if statistic not in STATISTICS:
    raise ValueError(f"unknown statistic {statistic!r}")
  starts = np.asarray(starts, np.int64)
  ends = np.asarray(ends, np.int64)
  n_bins = len(starts)
  lengths = ends - starts
  rest = tuple(x.shape[1:])
  dev = x.device
  if n_bins and (starts[1:] == ends[:-1]).all():
    rows = x[int(starts[0]):int(ends[-1])]
  else:  # bins that do not tile a range: gather their rows
    first = np.repeat(starts - np.cumsum(lengths) + lengths, lengths)
    rows = x[torch.as_tensor(first + np.arange(int(lengths.sum())),
                             device=dev)]
  seg = torch.as_tensor(np.repeat(np.arange(n_bins), lengths), device=dev)
  nan = torch.isnan(rows)
  n_rows = torch.as_tensor(lengths, dtype=torch.float64, device=dev).reshape(
      (n_bins,) + (1,) * len(rest))
  if statistic in ("mean", "sum"):
    v = rows.to(torch.float64)
    if skipna:
      v = torch.where(nan, 0.0, v)
    out = torch.zeros((n_bins,) + rest, dtype=torch.float64, device=dev)
    out.index_add_(0, seg, v)
    if statistic == "mean":
      out = out / (_segment_counts(~nan, seg, n_bins) if skipna else n_rows)
  else:
    fill = torch.inf if statistic == "min" else -torch.inf
    v = torch.where(nan, fill, rows)
    out = torch.full((n_bins,) + rest, fill, dtype=rows.dtype, device=dev)
    out.scatter_reduce_(
        0, seg.reshape((-1,) + (1,) * len(rest)).expand(v.shape), v,
        "amin" if statistic == "min" else "amax")
    n_nan = _segment_counts(nan, seg, n_bins)
    out = torch.where(n_nan == n_rows if skipna else n_nan > 0, torch.nan,
                      out.to(torch.float64))
  return torch.where(n_rows == 0, torch.nan, out)


def reduce_time_bins(ds: xds.Dataset, starts, ends, label_times,
                     statistic: str, skipna: bool = False,
                     time_dim: str = "time") -> xds.Dataset:
  """Reduce each [starts[i], ends[i]) time range of ``ds`` to one step
  (``bin_reduce``; float64, as the JAX package's).  Payloads stay where
  they are: tensors on their device, numpy as CPU tensors back to numpy."""
  out = xds.Dataset({}, coords={
      k: v for k, v in ds.coords_dict().items() if time_dim not in v.dims})
  for name in ds.keys():
    da = ds[name]
    if time_dim not in da.dims:
      out[name] = da
      continue
    ax = da.dims.index(time_dim)
    x, host = _as_time_first_tensor(da.data, ax)
    red = bin_reduce(x, starts, ends, statistic, skipna).movedim(0, ax)
    out[name] = xds.Variable(da.dims, red.numpy() if host else red)
  return out.assign_coords({time_dim: np.asarray(label_times)})


def resample_in_time(ds: xds.Dataset, period, statistic: str = "mean",
                     label: str = "left", skipna: bool = False,
                     time_dim: str = "time",
                     origin: str = "start_day") -> xds.Dataset:
  """Resample along time into period bins with the given statistic (see
  ``resample_time_plan`` for the bins and their labels)."""
  label_times, starts, ends = resample_time_plan(
      ds.coords_dict()[time_dim].data, period, label, origin)
  return reduce_time_bins(ds, starts, ends, label_times, statistic, skipna,
                          time_dim)


def _window_sums(v, window: int):
  """Sums of each run of ``window`` entries along axis 0 (the first
  ``window - 1`` positions have none): a cumulative sum's differences."""
  c = torch.cumsum(v, 0)
  c = torch.cat([torch.zeros_like(c[:1]), c])
  return c[window:] - c[:-window]


def rolling_reduce(x, window: int, statistic: str, skipna: bool = False):
  """The trailing ``window``-step ``statistic`` along ``x``'s first axis,
  float64, NaN in the first ``window - 1`` steps; NaN handling as
  ``bin_reduce``.  Mean and sum are differences of a float64 cumulative
  sum of the finite values (±inf and NaN counted apart, so that one does
  not spoil the windows after it), min and max one reduction over an
  ``unfold`` of the windows."""
  if statistic not in STATISTICS:
    raise ValueError(f"unknown statistic {statistic!r}")
  out = torch.full(x.shape, torch.nan, dtype=torch.float64, device=x.device)
  if x.shape[0] < window:
    return out
  xf = x.to(torch.float64)
  nan = torch.isnan(xf)
  n_nan = _window_sums(nan.to(torch.float64), window)
  if statistic in ("mean", "sum"):
    res = _window_sums(torch.where(torch.isfinite(xf), xf, 0.0), window)
    pos = _window_sums(torch.isposinf(xf).to(torch.float64), window) > 0
    neg = _window_sums(torch.isneginf(xf).to(torch.float64), window) > 0
    res = torch.where(pos, torch.inf, torch.where(neg, -torch.inf, res))
    res = torch.where(pos & neg, torch.nan, res)
    if statistic == "mean":
      res = res / (window - n_nan if skipna else window)
    bad = n_nan > 0 if not skipna else torch.zeros_like(pos)
  else:
    fill = torch.inf if statistic == "min" else -torch.inf
    windows = torch.where(nan, fill, xf).unfold(0, window, 1)
    res = (torch.amin if statistic == "min" else torch.amax)(windows, -1)
    bad = n_nan == window if skipna else n_nan > 0
  out[window - 1:] = torch.where(bad, torch.nan, res)
  return out


def rolling_in_time(ds: xds.Dataset, window: int, statistic: str = "mean",
                    skipna: bool = False,
                    time_dim: str = "time") -> xds.Dataset:
  """Trailing rolling-window statistic (``rolling_reduce``); the first
  window - 1 entries are NaN."""
  out = xds.Dataset({}, coords=dict(ds.coords_dict()))
  for name in ds.keys():
    da = ds[name]
    if time_dim not in da.dims:
      out[name] = da
      continue
    ax = da.dims.index(time_dim)
    x, host = _as_time_first_tensor(da.data, ax)
    res = rolling_reduce(x, window, statistic, skipna).movedim(0, ax)
    out[name] = xds.Variable(da.dims, res.numpy() if host else res)
  return out

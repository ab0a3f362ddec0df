"""The probabilistic climatology: years of the truth as ensemble members.

Counterpart of the part of ``weatherbench2_tpu/utils.py`` that the
probabilistic-climatology baseline needs (``replace_time_with_doy``,
``select_hour``, ``reindex_with_nan``, ``make_probabilistic_climatology``);
the climatology statistics of that module are not ported yet.

``make_probabilistic_climatology`` builds every year × hour at once, as the
JAX package does: at the official scale (30 years of 1.5° truth, 17
variable-levels) that is tens of GB of host memory.  The engines use
``ProbabilisticClimatology`` instead, which gives the same members for the
valid times of one chunk, read from the truth store year by year.
"""
from __future__ import annotations

import numpy as np

from weatherbench2_torch import xds


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

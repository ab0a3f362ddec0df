"""Horizontal regridding: nearest, bilinear and linear-conservative.

Counterpart of ``weatherbench2_tpu/regridding.py``.  The grid geometry
(overlap weight matrices, interpolation indices and lerp weights, the
nearest-neighbour index map) is the JAX package's host numpy, copied: a
pure function of the two grids, computed once per regridder.  Applying it
is array work on the payload's own device:

  * conservative: two float32 matmuls on a tensor (TF32 is off, see
    ``device.py``), latitude contracted first (for 1440x721 -> 240x121,
    1440*721*121 + 240*1440*121 = 1.67e8 multiply-adds a field, where
    longitude first would take 2.70e8); NaN cells drop out through a
    second pair of matmuls on the valid mask, and a cell with no valid data
    is NaN.  On numpy, the JAX package's float64 einsum;
  * bilinear: two gathers and a lerp along latitude, then longitude, NaN
    outside a source grid without poles;
  * nearest: one gather of the precomputed flat indices.

Fields have trailing dims (..., longitude, latitude), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np
import torch

from weatherbench2_torch import device as _device  # noqa: F401  (TF32 off)
from weatherbench2_torch.xds import _xp


class LongitudeScheme(enum.Enum):
  # [0, Δ, 2Δ, ..., 360 - Δ]
  START_AT_ZERO = enum.auto()
  # [-180 + Δ/2, ..., 180 - Δ/2]
  CENTER_AT_ZERO = enum.auto()


class LatitudeSpacing(enum.Enum):
  EQUIANGULAR_WITH_POLES = enum.auto()
  EQUIANGULAR_WITHOUT_POLES = enum.auto()
  CUSTOM = enum.auto()


def latitude_values(latitude_spacing: LatitudeSpacing, num: int) -> np.ndarray:
  """Latitude node values given spacing and number of nodes."""
  if latitude_spacing == LatitudeSpacing.EQUIANGULAR_WITH_POLES:
    return np.linspace(-90, 90, num=num)
  if latitude_spacing == LatitudeSpacing.EQUIANGULAR_WITHOUT_POLES:
    half = 0.5 * 180 / num
    return np.linspace(-90 + half, 90 - half, num=num)
  raise ValueError(f"Unhandled {latitude_spacing=}")


def longitude_values(longitude_scheme: LongitudeScheme, num: int) -> np.ndarray:
  """Longitude node values given scheme and number of nodes."""
  delta = 360 / num
  if longitude_scheme == LongitudeScheme.START_AT_ZERO:
    return np.linspace(0, 360 - delta, num=num)
  if longitude_scheme == LongitudeScheme.CENTER_AT_ZERO:
    return np.linspace(-180 + delta / 2, 180 - delta / 2, num=num)
  raise ValueError(f"Unhandled {longitude_scheme=}")


def _assert_increasing(x: np.ndarray) -> None:
  if not (np.diff(x) > 0).all():
    raise ValueError(f"array is not increasing: {x}")


@dataclasses.dataclass(frozen=True)
class Grid:
  """A rectilinear lat/lon grid (irregular spacing OK).

  Attributes:
    longitudes: 1D longitudes in degrees (0..360 or -180..180).
    latitudes: 1D increasing latitudes in degrees.
    periodic: whether longitudes wrap around the sphere.
    includes_poles: whether the grid covers the poles.
  """

  longitudes: np.ndarray = dataclasses.field(kw_only=True)
  latitudes: np.ndarray = dataclasses.field(kw_only=True)
  periodic: bool = dataclasses.field(kw_only=True)
  includes_poles: bool = dataclasses.field(kw_only=True)

  def __post_init__(self):
    _assert_increasing(self.latitudes)

  @classmethod
  def from_degrees(cls, lon: np.ndarray, lat: np.ndarray) -> "Grid":
    return cls(
        longitudes=np.asarray(lon),
        latitudes=np.asarray(lat),
        periodic=True,
        includes_poles=True,
    )

  @property
  def shape(self) -> tuple:
    return (len(self.longitudes), len(self.latitudes))

  def _to_tuple(self):
    return (
        tuple(np.asarray(self.longitudes).tolist()),
        tuple(np.asarray(self.latitudes).tolist()),
        self.periodic,
        self.includes_poles,
    )

  def __eq__(self, other):
    return isinstance(other, Grid) and self._to_tuple() == other._to_tuple()

  def __hash__(self):
    return hash(self._to_tuple())


# ---------------------------------------------------------------------------
# Geometry precomputation (host-side numpy)
# ---------------------------------------------------------------------------


def _cell_bounds_lat(x: np.ndarray, include_poles: bool) -> np.ndarray:
  if include_poles:
    initial, final = np.array([-90.0]), np.array([90.0])
  else:
    initial = x[:1] - (x[1] - x[0]) / 2
    final = x[-1:] + (x[-1] - x[-2]) / 2
  return np.concatenate([initial, (x[:-1] + x[1:]) / 2, final])


def _lat_area_from_bounds(lower, upper):
  # normalized cell area: integral of cos(latitude) over the cell
  return np.sin(np.deg2rad(upper)) - np.sin(np.deg2rad(lower))


def conservative_latitude_weights(
    source_points: np.ndarray,
    target_points: np.ndarray,
    source_includes_poles: bool = True,
    target_includes_poles: bool = True,
) -> np.ndarray:
  """(target, source) weight matrix along latitude; rows sum to 1.

  Entries are the cos-weighted interval overlaps of source and target
  latitude cells, normalized per target cell; target cells not fully
  covered by a non-global source get NaN rows.
  """
  _assert_increasing(np.asarray(source_points))
  _assert_increasing(np.asarray(target_points))
  sb = _cell_bounds_lat(np.asarray(source_points), source_includes_poles)
  tb = _cell_bounds_lat(np.asarray(target_points), target_includes_poles)
  upper = np.minimum(tb[1:, None], sb[None, 1:])
  lower = np.maximum(tb[:-1, None], sb[None, :-1])
  overlap = (upper > lower) * _lat_area_from_bounds(lower, upper)
  coverage = overlap.sum(axis=1, keepdims=True)
  with np.errstate(invalid="ignore", divide="ignore"):
    weights = overlap / coverage
  if not source_includes_poles:
    target_areas = _lat_area_from_bounds(tb[:-1], tb[1:])[:, None]
    is_covered = np.isclose(coverage, target_areas, rtol=1e-3)
    weights = np.where(is_covered, weights, np.nan)
  return weights


def _wrap_phase(x, ref, period):
  """Shift x by ±period so it lies within period/2 of ref."""
  return x + period * (x < ref - period / 2) - period * (
      x > ref + period / 2
  )


def _lon_cell_bounds(x: np.ndarray, periodic: bool):
  """(lower, upper) bounds of longitude cells (wrapped midpoints)."""
  x = np.asarray(x, dtype=np.float64)
  if periodic:
    x = x % 360
    nxt = _wrap_phase(np.roll(x, -1), x, 360)
    prv = _wrap_phase(np.roll(x, 1), x, 360)
    return (prv + x) / 2, (x + nxt) / 2
  lower_ext = np.concatenate([x[:1] - (x[1] - x[0]), x[:-1]])
  upper_ext = np.concatenate([x[1:], x[-1:] + (x[-1] - x[-2])])
  return (lower_ext + x) / 2, (x + upper_ext) / 2


def conservative_longitude_weights(
    source_points: np.ndarray,
    target_points: np.ndarray,
    source_periodic: bool = True,
    target_periodic: bool = True,
) -> np.ndarray:
  """(target, source) weight matrix along longitude; rows sum to 1."""
  source_points = np.asarray(source_points)
  target_points = np.asarray(target_points)
  if len(target_points) < 3 and target_periodic:
    raise ValueError(
        "Need 3 or more target points else overlap is not well defined. "
        f"Found {len(target_points)}"
    )
  _assert_increasing(source_points)
  _assert_increasing(target_points)
  t_lower, t_upper = _lon_cell_bounds(target_points, target_periodic)
  s_lower, s_upper = _lon_cell_bounds(source_points, source_periodic)
  # Align each source interval's phase to the target interval, then take
  # the standard interval overlap (valid while cells < period/2 wide).
  s0 = _wrap_phase(s_lower[None, :], t_lower[:, None], 360)
  s1 = _wrap_phase(s_upper[None, :], t_lower[:, None], 360)
  upper = np.minimum(t_upper[:, None], s1)
  lower = np.maximum(t_lower[:, None], s0)
  overlap = np.maximum(upper - lower, 0)
  coverage = overlap.sum(axis=1, keepdims=True)
  with np.errstate(invalid="ignore", divide="ignore"):
    weights = overlap / coverage
  if not source_periodic:
    target_lengths = (t_upper - t_lower)[:, None]
    is_covered = np.isclose(coverage, target_lengths, rtol=1e-3)
    weights = np.where(is_covered, weights, np.nan)
  return weights


def nearest_neighbor_indices(
    source_grid: Grid, target_grid: Grid
) -> np.ndarray:
  """Exact haversine nearest-neighbor indices into the raveled source grid.

  Exploits rectilinearity: haversine(d) = hav(Δlat) + cosφ₁cosφ₂ hav(Δlon),
  and for a fixed source latitude the best source longitude is simply the
  nearest one in wrapped angular distance.  The argmin then reduces to a
  scan over source latitudes per (target lat, target lon) — O(Tlat·Tlon·
  Slat) numpy work with no spatial tree.
  """
  slat = np.deg2rad(np.asarray(source_grid.latitudes))
  slon = np.deg2rad(np.asarray(source_grid.longitudes))
  tlat = np.deg2rad(np.asarray(target_grid.latitudes))
  tlon = np.deg2rad(np.asarray(target_grid.longitudes))

  # nearest source lon for every target lon (wrapped)
  dlon = np.abs(
      (tlon[:, None] - slon[None, :] + np.pi) % (2 * np.pi) - np.pi
  )
  best_lon_idx = np.argmin(dlon, axis=1)  # (Tlon,)
  best_dlon = dlon[np.arange(len(tlon)), best_lon_idx]  # (Tlon,)

  hav_dlon = np.sin(best_dlon / 2) ** 2  # (Tlon,)
  # distance metric per (tlat, tlon, slat):
  hav_dlat = np.sin((tlat[:, None] - slat[None, :]) / 2) ** 2  # (Tlat,Slat)
  coscos = np.cos(tlat)[:, None] * np.cos(slat)[None, :]  # (Tlat, Slat)
  # d[i,j,k] = hav_dlat[i,k] + coscos[i,k]*hav_dlon[j]
  d = (
      hav_dlat[:, None, :]
      + coscos[:, None, :] * hav_dlon[None, :, None]
  )  # (Tlat, Tlon, Slat)
  best_lat_idx = np.argmin(d, axis=-1)  # (Tlat, Tlon)

  # raveled index into (lon, lat)-ordered source points, matching the
  # (lon, lat) array layout used by regrid_array
  n_slat = len(slat)
  flat = best_lon_idx[None, :] * n_slat + best_lat_idx  # (Tlat, Tlon)
  return flat.T.ravel()  # (Tlon*Tlat,) in (lon, lat) order


def _interp_indices_weights(
    source: np.ndarray, target: np.ndarray, periodic: bool,
    extrapolate: bool,
):
  """1-d linear interpolation as (lo_idx, hi_idx, weight_hi[, nan_mask])."""
  source = np.asarray(source, dtype=np.float64)
  target = np.asarray(target, dtype=np.float64)
  n = len(source)
  if periodic:
    # unwrap target into source phase
    src = source % 360
    order = np.argsort(src)
    src_sorted = src[order]
    tgt = target % 360
    # positions in the sorted circular source
    hi = np.searchsorted(src_sorted, tgt, side="right") % n
    lo = (hi - 1) % n
    x_lo = src_sorted[lo]
    x_hi = src_sorted[hi]
    span = (x_hi - x_lo) % 360
    span = np.where(span == 0, 360, span)
    frac = ((tgt - x_lo) % 360) / span
    return order[lo], order[hi], frac, np.zeros(len(tgt), dtype=bool)
  hi = np.clip(np.searchsorted(source, target, side="right"), 1, n - 1)
  lo = hi - 1
  denom = source[hi] - source[lo]
  frac = np.clip((target - source[lo]) / denom, 0.0, 1.0)
  oob = (target < source[0]) | (target > source[-1])
  if extrapolate:
    # clamp to edge values (like jnp.interp default)
    return lo, hi, frac, np.zeros(len(target), dtype=bool)
  return lo, hi, frac, oob


# ---------------------------------------------------------------------------
# Regridders
# ---------------------------------------------------------------------------


def _take(field, idx, axis):
  """``field`` gathered at indices ``idx`` (host, or a tensor on the
  field's device) along ``axis`` (< 0)."""
  if _xp.is_tensor(field):
    return field.index_select(field.ndim + axis, idx)
  return np.take(field, idx, axis=axis)


def _host_or_tensor(field):
  """A tensor stays; anything else (a lazy payload too) becomes numpy."""
  return field if _xp.is_tensor(field) else np.asarray(field)


@dataclasses.dataclass(frozen=True)
class Regridder:
  """Base class for regridding (source grid -> target grid)."""

  source: Grid
  target: Grid

  @functools.cached_property
  def _on_device(self) -> dict:
    return {}

  def _device_plan(self, name: str, like: torch.Tensor) -> tuple:
    """The host arrays of the plan ``name`` as tensors on ``like``'s
    device, floats in its dtype: moved once per device and dtype, not on
    every call."""
    key = (name, like.device, like.dtype)
    if key not in self._on_device:
      self._on_device[key] = tuple(
          torch.as_tensor(a, device=like.device) if a.dtype.kind in "iub"
          else _xp.like(a, like) for a in getattr(self, name))
    return self._on_device[key]

  def regrid_array(self, field):
    """Regrid an array with trailing dims (..., lon, lat)."""
    raise NotImplementedError

  def regrid_dataset(self, dataset):
    """Regrid an ``xds.Dataset`` from source to target: a decreasing
    latitude is flipped first, variables without both horizontal dims pass
    through, and each variable keeps its dim order."""
    from weatherbench2_torch import xds

    lat = np.asarray(dataset.coords_dict()["latitude"].data)
    if not (np.diff(lat) > 0).all():
      dataset = dataset.isel(latitude=np.arange(len(lat))[::-1])
    out = xds.Dataset(
        {},
        coords={
            **{k: v for k, v in dataset.coords_dict().items()
               if k not in ("latitude", "longitude")},
            "latitude": np.asarray(self.target.latitudes),
            "longitude": np.asarray(self.target.longitudes),
        },
        attrs=dataset.attrs,
    )
    for name in dataset.keys():
      da = dataset[name]
      if "longitude" not in da.dims or "latitude" not in da.dims:
        out[name] = da
        continue
      other = [d for d in da.dims if d not in ("longitude", "latitude")]
      arranged = da.transpose(*(other + ["longitude", "latitude"]))
      result = self.regrid_array(arranged.data)
      result_var = xds.Variable(
          tuple(other) + ("longitude", "latitude"), result, da.attrs)
      out[name] = (result_var.transpose(*da.dims)
                   if tuple(result_var.dims) != tuple(da.dims)
                   else result_var)
    return out


class NearestRegridder(Regridder):
  """Nearest neighbour on the sphere via precomputed gather indices."""

  @functools.cached_property
  def indices(self) -> np.ndarray:
    return nearest_neighbor_indices(self.source, self.target)

  @property
  def _index_plan(self):
    return (self.indices,)

  def regrid_array(self, field):
    field = _host_or_tensor(field)
    n_lon, n_lat = self.source.shape
    if tuple(field.shape[-2:]) != (n_lon, n_lat):
      raise ValueError(
          f"expected trailing dims {(n_lon, n_lat)}, got "
          f"{tuple(field.shape[-2:])}")
    flat = field.reshape(tuple(field.shape[:-2]) + (n_lon * n_lat,))
    idx = (self._device_plan("_index_plan", field)[0]
           if _xp.is_tensor(field) else self.indices)
    gathered = _take(flat, idx, -1)
    return gathered.reshape(tuple(field.shape[:-2]) + self.target.shape)


class BilinearRegridder(Regridder):
  """Bilinear interpolation via precomputed gather + lerp weights."""

  @functools.cached_property
  def _lat_plan(self):
    return _interp_indices_weights(
        np.asarray(self.source.latitudes),
        np.asarray(self.target.latitudes),
        periodic=False,
        extrapolate=self.source.includes_poles,
    )

  @functools.cached_property
  def _lon_plan(self):
    return _interp_indices_weights(
        np.asarray(self.source.longitudes),
        np.asarray(self.target.longitudes),
        periodic=self.source.periodic,
        extrapolate=False,
    )

  def regrid_array(self, field):
    field = _host_or_tensor(field)
    on_device = _xp.is_tensor(field)
    # latitude (last axis), then longitude (second to last)
    for axis, name in ((-1, "_lat_plan"), (-2, "_lon_plan")):
      has_oob = getattr(self, name)[3].any()
      lo, hi, frac, oob = (self._device_plan(name, field) if on_device
                           else getattr(self, name))
      if axis == -2:
        frac, oob = frac[:, None], oob[:, None]
      f_lo, f_hi = _take(field, lo, axis), _take(field, hi, axis)
      field = f_lo * (1 - frac) + f_hi * frac
      if has_oob:
        field = (torch.where(oob, torch.nan, field) if on_device
                 else np.where(oob, np.nan, field))
    return field


class ConservativeRegridder(Regridder):
  """Linear conservative regridding as two matmuls."""

  @functools.cached_property
  def _lon_weights(self) -> np.ndarray:
    return conservative_longitude_weights(
        np.asarray(self.source.longitudes),
        np.asarray(self.target.longitudes),
        self.source.periodic,
        self.target.periodic,
    ).astype(np.float32)

  @functools.cached_property
  def _lat_weights(self) -> np.ndarray:
    return conservative_latitude_weights(
        np.asarray(self.source.latitudes),
        np.asarray(self.target.latitudes),
        self.source.includes_poles,
        self.target.includes_poles,
    ).astype(np.float32)

  @property
  def _weights(self):
    return (self._lon_weights, self._lat_weights)

  def _mean(self, field):
    """Cell-averages of field on the target grid."""
    if _xp.is_tensor(field):
      lon_w, lat_w = self._device_plan("_weights", field)
      # (..., b, d) . (d, c) -> (..., b, c), then (a, b) . (..., b, c)
      return torch.matmul(lon_w, torch.matmul(field, lat_w.T))
    return np.einsum(
        "ab,cd,...bd->...ac",
        self._lon_weights.astype(np.float64),
        self._lat_weights.astype(np.float64),
        field,
        optimize=True,
    )

  def _nanmean(self, field):
    """Cell-averages skipping NaNs (NaN where a cell has no valid data)."""
    field = _host_or_tensor(field)
    if _xp.is_tensor(field):
      nulls = torch.isnan(field)
      total = self._mean(torch.where(nulls, 0.0, field))
      count = self._mean((~nulls).to(field.dtype))
      return total / count  # NaN where count == 0
    nulls = np.isnan(field)
    total = self._mean(np.where(nulls, 0, field))
    count = self._mean((~nulls).astype(field.dtype))
    with np.errstate(invalid="ignore", divide="ignore"):
      return total / count  # intentionally NaN if count == 0

  regrid_array = _nanmean

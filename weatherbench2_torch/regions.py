"""Spatial region selectors applied before area-weighted averaging.

Counterpart of ``weatherbench2_tpu/regions.py``: ``apply`` keeps the
reference semantics (slice boxes / multiply weights), and ``mask_weights``
compiles a region to a dense (latitude, longitude) weight mask, which the
fused reduction kernels consume as rows of their region-weight matrix.
"""
import dataclasses
import typing as t

import numpy as np

from weatherbench2_torch import xds


@dataclasses.dataclass
class Region:
  """Region selector for spatially averaged metrics."""

  def apply(
      self, dataset: xds.Dataset, weights: xds.DataArray
  ) -> tuple[xds.Dataset, xds.DataArray]:
    raise NotImplementedError

  def mask_weights(
      self, latitude: np.ndarray, longitude: np.ndarray
  ) -> np.ndarray:
    """Dense (latitude, longitude) 0/1 (or fractional) weight multiplier."""
    raise NotImplementedError


def _slices_to_mask(index: np.ndarray, slices) -> np.ndarray:
  """Boolean mask of index values selected by one-or-more label slices."""
  slices = slices if isinstance(slices, list) else [slices]
  mask = np.zeros(index.shape, dtype=bool)
  for s in slices:
    lo = -np.inf if s.start is None else s.start
    hi = np.inf if s.stop is None else s.stop
    if lo <= hi:
      mask |= (index >= lo) & (index <= hi)
    else:  # wrapped longitude interval
      mask |= (index >= lo) | (index <= hi)
  return mask


@dataclasses.dataclass
class SliceRegion(Region):
  """Latitude-longitude box selection."""

  lat_slice: t.Optional[t.Union[slice, list]] = dataclasses.field(
      default_factory=lambda: slice(None, None)
  )
  lon_slice: t.Optional[t.Union[slice, list]] = dataclasses.field(
      default_factory=lambda: slice(None, None)
  )

  def apply(self, dataset, weights):
    lat_pos = np.nonzero(_slices_to_mask(
        np.asarray(dataset.coords_dict()["latitude"].data), self.lat_slice))[0]
    lon_pos = np.nonzero(_slices_to_mask(
        np.asarray(dataset.coords_dict()["longitude"].data),
        self.lon_slice))[0]
    dataset = dataset.isel(latitude=lat_pos, longitude=lon_pos)
    windexers = {}
    if "latitude" in weights.dims:
      windexers["latitude"] = lat_pos
    if "longitude" in weights.dims:
      windexers["longitude"] = lon_pos
    return dataset, weights.isel(windexers) if windexers else weights

  def mask_weights(self, latitude, longitude):
    lat_mask = _slices_to_mask(np.asarray(latitude), self.lat_slice)
    lon_mask = _slices_to_mask(np.asarray(longitude), self.lon_slice)
    return (lat_mask[:, None].astype(np.float64)
            * lon_mask[None, :].astype(np.float64))


@dataclasses.dataclass
class ExtraTropicalRegion(Region):
  """Exclude the tropics: |latitude| >= threshold_lat."""

  threshold_lat: t.Optional[float] = 20

  def apply(self, dataset, weights):
    lat = np.asarray(dataset.coords_dict()["latitude"].data)
    region_weights = xds.DataArray(
        (np.abs(lat) >= self.threshold_lat).astype(float),
        dims=("latitude",), coords={"latitude": lat},
    )
    return dataset, weights * region_weights

  def mask_weights(self, latitude, longitude):
    lat_mask = np.abs(np.asarray(latitude)) >= self.threshold_lat
    return np.broadcast_to(lat_mask[:, None].astype(np.float64),
                           (len(latitude), len(longitude))).copy()


@dataclasses.dataclass
class LandRegion(Region):
  """Select land grid points via a land-sea-mask DataArray.

  Attributes:
    land_sea_mask: DataArray with dims (latitude, longitude) in the data's
      resolution; values in [0, 1].
    threshold: if given, binarize the mask at this threshold.
  """

  land_sea_mask: xds.DataArray
  threshold: t.Optional[float] = None

  def _weights_da(self) -> xds.DataArray:
    lw = self.land_sea_mask
    if self.threshold is not None:
      lw = lw.copy(data=(np.asarray(lw.values) > self.threshold).astype(float))
    return lw

  def apply(self, dataset, weights):
    return dataset, weights * self._weights_da()

  def mask_weights(self, latitude, longitude):
    sub = self._weights_da().sel(
        latitude=np.asarray(latitude), longitude=np.asarray(longitude))
    return np.asarray(sub.transpose("latitude", "longitude").values,
                      dtype=np.float64)


@dataclasses.dataclass
class CombinedRegion(Region):
  """Sequentially applies region selections (e.g. box + land)."""

  regions: list = dataclasses.field(default_factory=list)

  def apply(self, dataset, weights):
    for region in self.regions:
      dataset, weights = region.apply(dataset, weights)
    return dataset, weights

  def mask_weights(self, latitude, longitude):
    mask = np.ones((len(latitude), len(longitude)), dtype=np.float64)
    for region in self.regions:
      mask = mask * region.mask_weights(latitude, longitude)
    return mask

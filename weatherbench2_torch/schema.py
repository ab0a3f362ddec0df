"""Dataset time conventions and mock-data factories, without pandas.

Counterpart of ``weatherbench2_tpu/schema.py``: by-init forecasts carry
(init_time, lead_time) with a derived valid_time coord; by-valid forecasts
carry (time, lead_time) with a derived init_time coord.  The factories give
the same dims and coords as the JAX ones.
"""
from collections import abc
from typing import Optional

import numpy as np

from weatherbench2_torch import xds
from weatherbench2_torch.xds.core import to_timedelta64


def apply_time_conventions(forecast: xds.Dataset,
                           by_init: bool) -> xds.Dataset:
  """Apply WeatherBench2 time name conventions onto a forecast dataset."""
  if "prediction_timedelta" in forecast.coords_dict():
    forecast = forecast.rename({"prediction_timedelta": "lead_time"})
    lead = forecast.coords_dict()["lead_time"].data
    if by_init:
      forecast = forecast.rename({"time": "init_time"})
      init = forecast.coords_dict()["init_time"].data
      forecast = forecast.assign_coords(valid_time=xds.Variable(
          ("init_time", "lead_time"), init[:, None] + lead[None, :]))
    else:
      time = forecast.coords_dict()["time"].data
      forecast = forecast.assign_coords(init_time=xds.Variable(
          ("time", "lead_time"), time[:, None] - lead[None, :]))
  return forecast


ALL_3D_VARIABLES = (
    "geopotential",
    "temperature",
    "u_component_of_wind",
    "v_component_of_wind",
    "specific_humidity",
)

ALL_2D_VARIABLES = ("2m_temperature",)


def mock_truth_data(
    *,
    variables_3d: abc.Sequence[str] = ALL_3D_VARIABLES,
    variables_2d: abc.Sequence[str] = ALL_2D_VARIABLES,
    levels: abc.Sequence[int] = (500, 700, 850),
    spatial_resolution_in_degrees: float = 10.0,
    time_start: str = "2020-01-01",
    time_stop: str = "2021-01-01",
    time_resolution: str = "1 day",
    dtype=np.float32,
) -> xds.Dataset:
  """All-zero ground-truth dataset with correct dims/coords.

  ``round(180/res)+1`` latitudes from -90 to 90 and ``round(360/res)``
  longitudes from 0; 3-D variables have dims (time, level, longitude,
  latitude), 2-D ones drop level.  ``time_stop`` is exclusive.
  """
  num_latitudes = round(180 / spatial_resolution_in_degrees) + 1
  num_longitudes = round(360 / spatial_resolution_in_degrees)
  coords = {
      "time": np.arange(np.datetime64(time_start, "ns"),
                        np.datetime64(time_stop, "ns"),
                        to_timedelta64(time_resolution)),
      "latitude": np.linspace(-90, 90, num_latitudes),
      "longitude": np.linspace(0, 360, num_longitudes, endpoint=False),
      "level": np.array(list(levels)),
  }
  dims_3d = ("time", "level", "longitude", "latitude")
  shape_3d = tuple(len(coords[d]) for d in dims_3d)
  data_vars = {k: (dims_3d, np.zeros(shape_3d, dtype)) for k in variables_3d}
  if not data_vars:
    del coords["level"]
  dims_2d = ("time", "longitude", "latitude")
  shape_2d = tuple(len(coords[d]) for d in dims_2d)
  for k in variables_2d:
    data_vars[k] = (dims_2d, np.zeros(shape_2d, dtype))
  return xds.Dataset(data_vars, coords=coords)


def mock_forecast_data(
    *,
    lead_start: str = "0 day",
    lead_stop: str = "10 day",
    lead_resolution: str = "1 day",
    ensemble_size: Optional[int] = None,
    **kwargs,
) -> xds.Dataset:
  """A mock forecast dataset with all zeros (lead_stop inclusive)."""
  lead_time = np.arange(
      to_timedelta64(lead_start),
      to_timedelta64(lead_stop) + np.timedelta64(1, "ns"),
      to_timedelta64(lead_resolution),
  )
  ds = mock_truth_data(**kwargs)
  ds = ds.expand_dims(prediction_timedelta=lead_time)
  if ensemble_size is not None:
    ds = ds.expand_dims(realization=ensemble_size)
    ds = ds.assign_coords(realization=np.arange(ensemble_size))
  return ds


def mock_hourly_climatology_data(
    *, hour_interval: int = 1, **kwargs
) -> xds.Dataset:
  """A mock hourly climatology dataset with all zeros."""
  hours = np.arange(0, 24, hour_interval)
  ds = mock_truth_data(**kwargs)
  ds = ds.isel(time=0, drop=True)
  ds = ds.expand_dims(hour=hours)
  ds = ds.expand_dims(dayofyear=1 + np.arange(366))
  return ds

"""Derived variables computed on the fly, on the host or on the card.

Counterpart of ``weatherbench2_tpu/derived_variables.py`` (and so of the
reference WeatherBench 2 module): the same class names, ``base_variables``
and ``core_dims`` contracts and physics (spherical finite differences,
pressure-integrated continuity, Bolton-1980 relative humidity,
precipitation accumulations, Parseval-normalized zonal energy spectra).

The math runs on whatever the payloads are: numpy on the host, torch on the
card.  Coefficients computed from coordinates (latitude in degrees, level
in hPa) are float64 on the host and are cast to the payload's dtype before
they meet it, so a float32 field stays float32.  The zonal spectrum of a
tensor is one ``torch.fft.rfft`` (cuFFT on the card); the JAX package's
cos/sin matmuls existed only because its TPU transport had no complex
dtype.
"""
from __future__ import annotations

import dataclasses
import typing as t

import numpy as np
import torch

from weatherbench2_torch import schema
from weatherbench2_torch import xds
from weatherbench2_torch.xds import _xp

# pylint: disable=invalid-name


@dataclasses.dataclass
class DerivedVariable:
  """Derived variable base class."""

  # whether the values may be ±inf by design (the geostrophic winds on the
  # equator): the streaming engine keeps such a variable's inf cells out of
  # the kernels, which take finite numbers only (streaming's
  # _inf_safe_region_sums)
  may_be_infinite: t.ClassVar[bool] = False

  @property
  def base_variables(self) -> list:
    """Return a list of base variables."""
    return []

  @property
  def core_dims(self) -> t.Tuple[t.Tuple[t.List[str], ...], t.List[str]]:
    """Core dims: (per-input core dims, output core dims)."""
    raise NotImplementedError

  @property
  def all_input_core_dims(self) -> set:
    return set().union(*self.core_dims[0]) if self.core_dims[0] else set()

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    raise NotImplementedError


# by-init time conventions rename the raw store dims
# (schema.apply_time_conventions); registry variables declare the raw names
_CONVENTION_RENAMES = {"prediction_timedelta": "lead_time"}


def compute_on(dv: DerivedVariable, dataset: xds.Dataset) -> xds.DataArray:
  """``dv`` computed on ``dataset``, across the time-convention renames.

  A registry variable (a precipitation accumulation over
  ``prediction_timedelta``) declares the raw store dims, while the
  evaluation engines' datasets carry the renamed ``lead_time``: the
  dataset is renamed to the variable's dims for the computation and the
  result renamed back.
  """
  ren = {raw: renamed for raw, renamed in _CONVENTION_RENAMES.items()
         if raw in dv.all_input_core_dims and raw not in dataset.sizes
         and renamed in dataset.sizes}
  if not ren:
    return dv.compute(dataset)
  out = dv.compute(dataset.rename({v: k for k, v in ren.items()}))
  return out.rename_dims({k: v for k, v in ren.items() if k in out.dims})


def _latitude_array(field, values) -> xds.DataArray:
  """Float64 ``values`` along the field's latitude, in the field's dtype."""
  lat = np.asarray(field.coords["latitude"].data)
  return xds.DataArray(_xp.like(values, field.data), dims=("latitude",),
                       coords={"latitude": lat})


def _sqrt_da(da: xds.DataArray) -> xds.DataArray:
  return da.copy(data=_xp.namespace(da.data).sqrt(da.data))


@dataclasses.dataclass
class _WindVariable(DerivedVariable):
  """A variable derived from U and V wind components."""

  u_name: str
  v_name: str

  @property
  def base_variables(self) -> list:
    return [self.u_name, self.v_name]


@dataclasses.dataclass
class WindSpeed(_WindVariable):
  """Wind speed sqrt(u² + v²)."""

  @property
  def core_dims(self):
    return ([], []), []

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    u = dataset[self.u_name]
    v = dataset[self.v_name]
    return _sqrt_da(u**2 + v**2)


def _zero_poles(field: xds.DataArray, epsilon: float = 1e-6):
  """The field with 0 where cos(latitude) <= epsilon (compared in float64
  on the coordinate)."""
  lat = np.asarray(field.coords["latitude"].data)
  keep = xds.DataArray(np.cos(np.deg2rad(lat)) > epsilon, dims=("latitude",),
                       coords={"latitude": lat})
  return field.where(keep, 0.0)


_METERS_PER_DEGREE = 2 * np.pi * schema.EARTH_RADIUS_M / 360


def _d_dx(field: xds.DataArray) -> xds.DataArray:
  """Zonal spherical derivative (per meter), zeroed at the poles."""
  lat = np.asarray(field.coords["latitude"].data)
  cos_theta = _latitude_array(field, np.cos(np.deg2rad(lat)))
  return _zero_poles(
      field.differentiate("longitude") / cos_theta / _METERS_PER_DEGREE)


def _d_dy(field: xds.DataArray) -> xds.DataArray:
  """Meridional spherical derivative (per meter)."""
  return field.differentiate("latitude") / _METERS_PER_DEGREE


def _divergence(u: xds.DataArray, v: xds.DataArray) -> xds.DataArray:
  return _d_dx(u) + _d_dy(v)


def _curl(u: xds.DataArray, v: xds.DataArray) -> xds.DataArray:
  return _d_dx(v) - _d_dy(u)


@dataclasses.dataclass
class _3DWindVariable(DerivedVariable):
  """A variable derived from 3D U and V wind components."""

  u_name: str = "u_component_of_wind"
  v_name: str = "v_component_of_wind"

  @property
  def base_variables(self) -> list:
    return [self.u_name, self.v_name]


@dataclasses.dataclass
class WindDivergence(_3DWindVariable):
  """Wind divergence."""

  @property
  def core_dims(self):
    lon_lat = ["longitude", "latitude"]
    return (lon_lat, lon_lat), lon_lat

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    return _divergence(dataset[self.u_name], dataset[self.v_name])


@dataclasses.dataclass
class WindVorticity(_3DWindVariable):
  """Wind vorticity."""

  @property
  def core_dims(self):
    lon_lat = ["longitude", "latitude"]
    return (lon_lat, lon_lat), lon_lat

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    return _curl(dataset[self.u_name], dataset[self.v_name])


@dataclasses.dataclass
class VerticalVelocity(_3DWindVariable):
  r"""Hydrostatic vertical velocity ω = -∫ dp ∇_p · u (continuity eqn)."""

  @property
  def core_dims(self):
    zxy = ["level", "longitude", "latitude"]
    return (zxy, zxy), zxy

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    divergence = _divergence(dataset[self.u_name], dataset[self.v_name])
    pascals_per_hpa = 100
    pressure = pascals_per_hpa * np.asarray(
        dataset.coords_dict()["level"].data, dtype=np.float64)
    ax = divergence.dims.index("level")
    f = -divergence.data
    xp = _xp.namespace(f)
    shape = [1] * f.ndim
    shape[ax] = len(pressure) - 1
    dp = _xp.like(np.diff(pressure).reshape(shape), f)

    def key(index):
      k = [slice(None)] * f.ndim
      k[ax] = index
      return tuple(k)

    # cumulative trapezoid along ascending level, 0 at the first level
    cum = xp.cumsum(0.5 * (f[key(slice(1, None))] + f[key(slice(None, -1))])
                    * dp, axis=ax)
    zero = xp.zeros_like(f[key(slice(0, 1))])
    return divergence.copy(data=xp.concatenate([zero, cum], axis=ax))


@dataclasses.dataclass
class EddyKineticEnergy(_3DWindVariable):
  """Eddy kinetic energy (deviation from the instantaneous zonal mean)."""

  @property
  def core_dims(self):
    return (["level", "longitude"], ["level", "longitude"]), ["longitude"]

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    u_wind = dataset[self.u_name]
    v_wind = dataset[self.v_name]
    u_delta = u_wind - u_wind.mean("longitude")
    v_delta = v_wind - v_wind.mean("longitude")
    return (1 / 2) * (u_delta**2 + v_delta**2).integrate("level")


def _geostrophic_wind(geopotential: xds.DataArray):
  omega = 7.292e-5  # radians / second
  lat = np.asarray(geopotential.coords["latitude"].data)
  coriolis_parameter = _latitude_array(
      geopotential, 2 * omega * np.sin(np.deg2rad(lat)))
  # Geostrophic wind is inf on the equator; intentionally not clipped.
  return (-_d_dy(geopotential) / coriolis_parameter,
          _d_dx(geopotential) / coriolis_parameter)


@dataclasses.dataclass
class _GeostrophicWindVariable(DerivedVariable):
  """Base class for geostrophic wind variables."""

  may_be_infinite: t.ClassVar[bool] = True
  geopotential_name: str = "geopotential"

  @property
  def base_variables(self) -> list:
    return [self.geopotential_name]

  @property
  def core_dims(self):
    lon_lat = ["longitude", "latitude"]
    return (lon_lat,), lon_lat


@dataclasses.dataclass
class GeostrophicWindSpeed(_GeostrophicWindVariable):
  """Geostrophic wind speed (diagnostic per Bonavita, arXiv:2309.08473)."""

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    u, v = _geostrophic_wind(dataset[self.geopotential_name])
    return _sqrt_da(u**2 + v**2)


class UComponentOfGeostrophicWind(_GeostrophicWindVariable):
  """East-west component of geostrophic wind."""

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    u, _ = _geostrophic_wind(dataset[self.geopotential_name])
    return u


class VComponentOfGeostrophicWind(_GeostrophicWindVariable):
  """North-south component of geostrophic wind."""

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    _, v = _geostrophic_wind(dataset[self.geopotential_name])
    return v


@dataclasses.dataclass
class _AgeostrophicWindVariable(DerivedVariable):
  """Base class for ageostrophic wind variables."""

  may_be_infinite: t.ClassVar[bool] = True
  u_name: str = "u_component_of_wind"
  v_name: str = "v_component_of_wind"
  geopotential_name: str = "geopotential"

  @property
  def base_variables(self) -> list:
    return [self.u_name, self.v_name, self.geopotential_name]

  @property
  def core_dims(self):
    lon_lat = ["longitude", "latitude"]
    return (lon_lat, lon_lat, lon_lat), lon_lat


class AgeostrophicWindSpeed(_AgeostrophicWindVariable):
  """Ageostrophic wind speed."""

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    u = dataset[self.u_name]
    v = dataset[self.v_name]
    u_geo, v_geo = _geostrophic_wind(dataset[self.geopotential_name])
    return _sqrt_da((u - u_geo) ** 2 + (v - v_geo) ** 2)


class UComponentOfAgeostrophicWind(_AgeostrophicWindVariable):
  """East-west component of ageostrophic wind."""

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    u_geo, _ = _geostrophic_wind(dataset[self.geopotential_name])
    return dataset[self.u_name] - u_geo


class VComponentOfAgeostrophicWind(_AgeostrophicWindVariable):
  """North-south component of ageostrophic wind."""

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    _, v_geo = _geostrophic_wind(dataset[self.geopotential_name])
    return dataset[self.v_name] - v_geo


@dataclasses.dataclass
class LapseRate(DerivedVariable):
  """Lapse rate dT/dz via pressure derivatives."""

  temperature_name: str = "temperature"
  geopotential_name: str = "geopotential"

  @property
  def base_variables(self) -> list:
    return [self.temperature_name, self.geopotential_name]

  @property
  def core_dims(self):
    return (["level"], ["level"]), ["level"]

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    g = 9.81
    dT_dp = dataset[self.temperature_name].differentiate("level")
    dz_dp = (1 / g) * dataset[self.geopotential_name].differentiate("level")
    return dT_dp / dz_dp


@dataclasses.dataclass
class TotalColumnWater(DerivedVariable):
  """Total column water: (1/g) ∫ q dp over level."""

  water_species_name: str = "specific_humidity"

  @property
  def base_variables(self) -> list:
    return [self.water_species_name]

  @property
  def core_dims(self):
    return (["level"],), []

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    g = 9.81
    return 1 / g * dataset[self.water_species_name].integrate("level")


@dataclasses.dataclass
class IntegratedWaterTransport(DerivedVariable):
  """Integrated horizontal water (vapor) transport — IVT."""

  u_name: str = "u_component_of_wind"
  v_name: str = "v_component_of_wind"
  water_species_name: str = "specific_humidity"
  level_min: t.Optional[float] = 300
  level_max: t.Optional[float] = 1000

  @property
  def base_variables(self) -> list:
    return [self.u_name, self.v_name, self.water_species_name]

  @property
  def core_dims(self):
    return (["level"], ["level"]), []

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    g = 9.81
    q = dataset[self.water_species_name]
    levels = slice(self.level_min, self.level_max)
    u_integral = (q * dataset[self.u_name]).sel(level=levels).integrate(
        "level")
    v_integral = (q * dataset[self.v_name]).sel(level=levels).integrate(
        "level")
    return (1 / g) * _sqrt_da(u_integral**2 + v_integral**2)


@dataclasses.dataclass
class RelativeHumidity(DerivedVariable):
  """Relative humidity from specific humidity (Bolton 1980 SVP formula)."""

  temperature_name: str = "temperature"
  specific_humidity_name: str = "specific_humidity"
  pressure_name: str = "level"

  @property
  def base_variables(self) -> list:
    return [self.temperature_name, self.specific_humidity_name,
            self.pressure_name]

  @property
  def core_dims(self):
    return ([], []), []

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    temperature = dataset[self.temperature_name]
    specific_humidity = dataset[self.specific_humidity_name]
    lev = np.asarray(dataset.coords_dict()[self.pressure_name].data,
                     dtype=np.float64)
    pressure = xds.DataArray(_xp.like(lev, temperature.data),
                             dims=(self.pressure_name,),
                             coords={self.pressure_name: lev})
    t_data = temperature.data
    svp = temperature.copy(data=6.112 * _xp.namespace(t_data).exp(
        17.67 * (t_data - 273.15) / (t_data - 29.65)))
    mixing_ratio = specific_humidity / (1 - specific_humidity)
    saturation_mixing_ratio = 0.622 * svp / (pressure - svp)
    return mixing_ratio / saturation_mixing_ratio


@dataclasses.dataclass
class PrecipitationAccumulation(DerivedVariable):
  """Accumulated precipitation over a trailing window of lead times.

  The accumulation at lead_time=T covers (T - accumulation_hours, T].
  Small negative differences (model artifacts) are clamped to zero; the
  first lead is NaN.
  """

  total_precipitation_name: str
  accumulation_hours: int
  lead_time_name: str = "prediction_timedelta"
  set_negative_to_zero: bool = True

  @property
  def base_variables(self) -> list:
    return [self.total_precipitation_name]

  @property
  def core_dims(self):
    return ([self.lead_time_name],), [self.lead_time_name]

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    tp = dataset[self.total_precipitation_name]
    diff = tp.diff(self.lead_time_name)

    lead = np.asarray(dataset.coords_dict()[self.lead_time_name].data)
    timestep = np.diff(lead)
    assert (timestep == timestep[0]).all(), "All time steps must be equal."
    steps = float(np.timedelta64(self.accumulation_hours, "h") / timestep[0])
    assert steps.is_integer(), (
        "Accumulation time must be multiple of timestep.")

    accumulation = diff.rolling_sum(self.lead_time_name, int(steps))
    if self.set_negative_to_zero:
      acc = accumulation.data
      xp = _xp.namespace(acc)
      accumulation = accumulation.copy(
          data=xp.where((acc >= 0.0) | xp.isnan(acc), acc, 0.0))
    first = tp.isel({self.lead_time_name: [0]}) * np.nan
    return xds.concat([first, accumulation], self.lead_time_name)


@dataclasses.dataclass
class ZonalEnergySpectrum(DerivedVariable):
  """Zonal energy spectrum with Parseval normalization.

  The DFT is forward-normalized, positive wavenumbers count twice, and the
  result is scaled by the latitude's circumference, so that the spectrum
  sums to the discrete integral around the zonal circle (with an even
  longitude count the Nyquist bin counts twice too, as in the reference).
  A tensor goes through one ``torch.fft.rfft``; a numpy payload through
  ``np.fft.rfft``.
  """

  variable_name: str

  @property
  def base_variables(self) -> list:
    return [self.variable_name]

  @property
  def core_dims(self):
    return (["longitude"],), ["zonal_wavenumber"]

  def _circumference_values(self, latitude: np.ndarray) -> np.ndarray:
    circum_at_equator = 2 * np.pi * schema.EARTH_RADIUS_M
    return np.cos(np.deg2rad(latitude)) * circum_at_equator

  def lon_spacing_m(self, dataset) -> xds.DataArray:
    """Spacing (meters) between longitudinal values in `dataset`."""
    coords = (dataset.coords_dict() if isinstance(dataset, xds.Dataset)
              else dataset.coords)
    lon = np.asarray(coords["longitude"].data)
    lat = np.asarray(coords["latitude"].data)
    diffs = np.diff(lon)
    if np.max(np.abs(diffs - diffs[0])) > 1e-3:
      raise ValueError(f"Expected uniform longitude spacing. {lon=}")
    return xds.DataArray(self._circumference_values(lat) * diffs[0] / 360,
                         dims=("latitude",), coords={"latitude": lat})

  def compute(self, dataset: xds.Dataset) -> xds.DataArray:
    da = dataset[self.variable_name]
    spacing = self.lon_spacing_m(dataset)
    lat = np.asarray(da.coords["latitude"].data)
    n_lon = da.sizes["longitude"]

    ax = da.dims.index("longitude")
    data = da.data
    if _xp.is_tensor(data):
      f_k = torch.fft.rfft(data, dim=ax, norm="forward")
      power = f_k.real ** 2 + f_k.imag ** 2
    else:
      f_k = np.fft.rfft(np.asarray(data), axis=ax, norm="forward")
      power = (f_k * np.conj(f_k)).real
    ones_twos = np.concatenate(([1.0], [2.0] * (power.shape[ax] - 1)))
    shape = [1] * power.ndim
    shape[ax] = power.shape[ax]
    power = power * _xp.like(ones_twos.reshape(shape), power)

    dims = tuple("zonal_wavenumber" if d == "longitude" else d
                 for d in da.dims)
    wavenumber = np.arange(power.shape[ax])
    coords = {k: v for k, v in da.coords.items() if "longitude" not in v.dims}
    coords["zonal_wavenumber"] = xds.Variable(("zonal_wavenumber",),
                                              wavenumber)
    spectrum = xds.DataArray(xds.Variable(dims, power), coords=coords,
                             name=self.variable_name)
    base_frequency = xds.DataArray(
        np.fft.rfftfreq(n_lon), dims=("zonal_wavenumber",),
        coords={"zonal_wavenumber": wavenumber})
    frequency = base_frequency / spacing
    frequency.variable.attrs["units"] = "1 / m"
    spectrum = spectrum.assign_coords(frequency=frequency.variable)
    with np.errstate(divide="ignore"):  # wavenumber 0: an infinite wavelength
      wavelength = 1 / frequency
    wavelength.variable.attrs["units"] = "m"
    spectrum = spectrum.assign_coords(wavelength=wavelength.variable)
    return spectrum * _latitude_array(spectrum, self._circumference_values(lat))


def interpolate_spectral_frequencies(
    spectrum: xds.DataArray,
    wavenumber_dim: str,
    frequencies: t.Optional[t.Sequence[float]] = None,
    method: str = "linear",
    **interp_kwargs,
) -> xds.DataArray:
  """Interpolate per-latitude spectral frequencies to common values (on the
  host, linearly; NaN outside each latitude's range)."""
  del method, interp_kwargs  # only linear interpolation is supported
  freq_coord = spectrum.coords["frequency"]
  if set(freq_coord.dims) != {wavenumber_dim, "latitude"}:
    raise ValueError(
        f"{freq_coord.dims=} was not a permutation of "
        f"('{wavenumber_dim}', 'latitude')")
  freq_np = xds.DataArray(freq_coord, coords={}, name="frequency").transpose(
      "latitude", wavenumber_dim).values

  if frequencies is None:
    freq_min = freq_np.max(axis=0).min()
    freq_max = freq_np.min(axis=0).max()
    frequencies = np.linspace(freq_min, freq_max,
                              num=spectrum.sizes[wavenumber_dim])
  frequencies = np.asarray(frequencies)
  if frequencies.ndim != 1:
    raise ValueError(f"Expected 1-D frequencies, found {frequencies.shape=}")

  lats = np.asarray(spectrum.coords["latitude"].data)
  interped = []
  for i in range(len(lats)):
    da = spectrum.isel(latitude=i)
    vals = np.moveaxis(np.asarray(da.values, dtype=np.float64),
                       da.dims.index(wavenumber_dim), -1)
    flat = vals.reshape(-1, vals.shape[-1])
    out = np.stack([np.interp(frequencies, freq_np[i], row, left=np.nan,
                              right=np.nan) for row in flat])
    dims = tuple(d for d in da.dims if d != wavenumber_dim) + ("frequency",)
    out_da = xds.DataArray(
        out.reshape(vals.shape[:-1] + (len(frequencies),)), dims=dims,
        coords={
            **{k: v for k, v in da.coords.items()
               if wavenumber_dim not in v.dims and "latitude" not in v.dims},
            "frequency": frequencies,
        },
        name=da.name)
    interped.append(out_da.expand_dims(latitude=[lats[i]]))
  result = xds.concat(interped, "latitude")
  wavelength = xds.Variable(("frequency",), 1 / frequencies, {"units": "m"})
  return result.assign_coords(wavelength=wavelength)


@dataclasses.dataclass
class AggregatePrecipitationAccumulation(DerivedVariable):
  """Aggregate longer accumulations from shorter raw accumulations."""

  accumulation_hours: int
  raw_accumulation_name: str = "total_precipitation_6hr"
  raw_accumulation_hours: int = 6
  lead_time_name: str = "prediction_timedelta"

  @property
  def base_variables(self):
    return [self.raw_accumulation_name]

  @property
  def core_dims(self):
    return ([self.lead_time_name],), [self.lead_time_name]

  def compute(self, dataset: xds.Dataset):
    tp6h = dataset[self.raw_accumulation_name]
    steps = float(np.timedelta64(self.accumulation_hours, "h")
                  / np.timedelta64(self.raw_accumulation_hours, "h"))
    assert steps.is_integer(), (
        "Accumulation time must be multiple of timestep.")
    return tp6h.rolling_sum(self.lead_time_name, int(steps))


# Dictionary of common derived variables
DERIVED_VARIABLE_DICT = {
    "wind_speed": WindSpeed(
        u_name="u_component_of_wind", v_name="v_component_of_wind"),
    "10m_wind_speed": WindSpeed(
        u_name="10m_u_component_of_wind", v_name="10m_v_component_of_wind"),
    "divergence": WindDivergence(),
    "vorticity": WindVorticity(),
    "vertical_velocity": VerticalVelocity(),
    "eddy_kinetic_energy": EddyKineticEnergy(),
    "geostrophic_wind_speed": GeostrophicWindSpeed(),
    "u_component_of_geostrophic_wind": UComponentOfGeostrophicWind(),
    "v_component_of_geostrophic_wind": VComponentOfGeostrophicWind(),
    "ageostrophic_wind_speed": AgeostrophicWindSpeed(),
    "u_component_of_ageostrophic_wind": UComponentOfAgeostrophicWind(),
    "v_component_of_ageostrophic_wind": VComponentOfAgeostrophicWind(),
    "lapse_rate": LapseRate(),
    "total_column_vapor": TotalColumnWater(
        water_species_name="specific_humidity"),
    "total_column_liquid": TotalColumnWater(
        water_species_name="specific_cloud_liquid_water_content"),
    "total_column_ice": TotalColumnWater(
        water_species_name="specific_cloud_ice_water_content"),
    "integrated_vapor_transport": IntegratedWaterTransport(),
    "relative_humidity": RelativeHumidity(),
    "total_precipitation_6hr": PrecipitationAccumulation(
        total_precipitation_name="total_precipitation",
        accumulation_hours=6,
        lead_time_name="prediction_timedelta"),
    "total_precipitation_24hr": PrecipitationAccumulation(
        total_precipitation_name="total_precipitation",
        accumulation_hours=24,
        lead_time_name="prediction_timedelta"),
    "total_precipitation_24hr_from_6hr": AggregatePrecipitationAccumulation(
        accumulation_hours=24,
        lead_time_name="prediction_timedelta"),
    "total_precipitation_24hr_from_12hr": AggregatePrecipitationAccumulation(
        accumulation_hours=24,
        lead_time_name="prediction_timedelta",
        raw_accumulation_name="total_precipitation_12hr",
        raw_accumulation_hours=12),
}

"""The cells' input fields, made from the seed on the device.

Every field is a few low-wavenumber waves that drift with time, scaled to
the variable's realistic mean and amplitude (the configuration's
``fields``), plus small noise, so that shuffle and lz4 find in them roughly
what they find in reanalysis.  Forecasts are the truth's signal at the
valid time plus an error that grows with lead; ensemble members add a
spread that grows with lead; precipitation and humidity are floored at
zero (dry cells).  The climatology holds the mean signal's level (ACC),
SEEPS thresholds and dry fractions, or ``<var>_quantile`` fields.

Each variable of each store is drawn in one call per variable, all inits
at once, with a ``torch.Generator`` seeded from (seed, store, variable):
the store writer and the reference call the same functions with the same
arguments on the same device and get the same values bit for bit.  No
matrix product is used, so TF32 settings cannot change a value.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

HOUR = np.timedelta64(1, "h")
N_WAVES = 6
SEEPS_P1_EDGES = (0.1, 0.85)  # SEEPS masks dry fractions outside these


def sub_seed(seed: int, *names) -> int:
  """A 63-bit seed for one draw, stable across processes and machines."""
  text = "/".join([str(int(seed))] + [str(n) for n in names])
  return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                        "little") >> 1


def grid(config: dict):
  """(longitudes, latitudes) in degrees, both increasing."""
  g = config["grid"]
  n_lon, n_lat = g["longitudes"], g["latitudes"]
  lon = np.arange(n_lon) * (360.0 / n_lon)
  if g["poles"]:
    lat = np.linspace(-90.0, 90.0, n_lat)
  else:
    lat = (np.arange(n_lat) + 0.5) * (180.0 / n_lat) - 90.0
  return lon, lat


@dataclasses.dataclass
class Layout:
  """The coordinates of one cell's stores."""

  config: dict
  traffic: dict

  def __post_init__(self):
    c, t = self.config, self.traffic
    self.lon, self.lat = grid(c)
    self.levels = np.asarray(c["levels"], np.int64)
    self.vars_3d = list(c["variables_3d"])
    self.vars_2d = list(c["variables_2d"])
    self.variables = self.vars_3d + self.vars_2d
    self.members = c.get("members")
    first = np.datetime64(c["first_init"], "ns")
    n_init = t["inits_per_job"]
    self.inits = first + np.arange(n_init) * c["init_step_hours"] * HOUR
    self.leads = np.arange(c["leads"]["count"]) * (
        c["leads"]["step_hours"] * HOUR)
    last_valid = self.inits[-1] + self.leads[-1]
    step = c["truth_step_hours"] * HOUR
    n_truth = int((last_valid + 12 * HOUR - first) // step) + 1
    self.truth_times = first + np.arange(n_truth) * step
    self.clim_hours = np.arange(0, 24, c["climatology"]["hour_step"])
    self.doys = np.arange(1, 367)
    valid = (self.inits[:, None] + self.leads[None, :]).ravel()
    # the days of year any valid time falls on: the climatology chunks read
    self.read_doys = np.unique(day_of_year(valid))

  def is_3d(self, name: str) -> bool:
    return name in self.vars_3d

  def n_levels(self, name: str) -> int:
    return len(self.levels) if self.is_3d(name) else 1

  def hours(self, times) -> np.ndarray:
    """Hours since the first init (float64)."""
    return ((np.asarray(times) - self.inits[0]) / HOUR).astype(np.float64)


def day_of_year(times) -> np.ndarray:
  times = np.asarray(times, "datetime64[ns]")
  years = times.astype("datetime64[Y]")
  return ((times.astype("datetime64[D]") - years.astype("datetime64[D]"))
          .astype(np.int64) + 1)


def hour_of_day(times) -> np.ndarray:
  times = np.asarray(times, "datetime64[ns]")
  return ((times - times.astype("datetime64[D]")) // HOUR).astype(np.int64)


class Fields:
  """Draws a cell's fields from ``seed`` on ``device`` (float32)."""

  def __init__(self, layout: Layout, seed: int, device):
    self.lay = layout
    self.seed = int(seed)
    self.device = torch.device(device)
    lon = torch.tensor(np.deg2rad(layout.lon), dtype=torch.float32,
                       device=self.device)
    lat = torch.tensor(np.deg2rad(layout.lat), dtype=torch.float32,
                       device=self.device)
    self._lon, self._lat = lon[:, None], lat[None, :]  # (X, 1), (1, Y)

  # -- coefficients, on the host from the seed ------------------------------
  def _coeffs(self, name, *tag, n=N_WAVES):
    rng = np.random.default_rng(sub_seed(self.seed, name, *tag))
    return {"m": rng.integers(1, 7, n), "n": rng.integers(1, 5, n),
            "phase": rng.uniform(0, 2 * math.pi, n),
            "speed": rng.uniform(-0.06, 0.06, n),
            "weight": rng.standard_normal(n) / math.sqrt(n),
            "level": 1 + 0.2 * rng.standard_normal((len(self.lay.levels), n))}

  def _stats(self, name):
    spec = self.lay.config["fields"][name]
    n_lev = self.lay.n_levels(name)
    mean = np.broadcast_to(np.asarray(spec["mean"], np.float64), (n_lev,))
    amp = np.broadcast_to(np.asarray(spec["amp"], np.float64), (n_lev,))
    return mean, amp, spec.get("floor")

  def _waves(self, co, hours, n_lev, drift=True):
    """sum_k weight_k level_lk cos(m_k lon + phase_k + speed_k t) cos(n_k
    lat): (T, L, X, Y) for the hours ``hours`` (T,)."""
    t = torch.tensor(np.asarray(hours, np.float64), dtype=torch.float32,
                     device=self.device)
    out = torch.zeros((len(t), n_lev, len(self.lay.lon), len(self.lay.lat)),
                      dtype=torch.float32, device=self.device)
    for k in range(len(co["m"])):
      speed = float(co["speed"][k]) if drift else 0.0
      arg = (float(co["m"][k]) * self._lon + float(co["phase"][k]))
      arg = arg[None] + speed * t[:, None, None]  # (T, X, 1)
      basis = torch.cos(arg) * torch.cos(float(co["n"][k]) * self._lat)
      lev = torch.tensor(co["level"][:n_lev, k] * co["weight"][k],
                         dtype=torch.float32, device=self.device)
      out += lev[None, :, None, None] * basis[:, None]
    return out

  def _finish(self, name, x):
    """mean + amp * x per level, floored where the variable is."""
    mean, amp, floor = self._stats(name)
    shape = (len(mean),) + (1, 1)
    m = torch.tensor(mean, dtype=torch.float32, device=self.device)
    a = torch.tensor(amp, dtype=torch.float32, device=self.device)
    x = m.reshape(shape) + a.reshape(shape) * x
    if floor is not None:
      x = torch.clamp_min(x, float(floor))
    return x

  def _noise(self, shape, *tag):
    gen = torch.Generator(device=self.device)
    gen.manual_seed(sub_seed(self.seed, *tag))
    return torch.randn(shape, generator=gen, device=self.device,
                       dtype=torch.float32)

  def _signal(self, name, hours):
    return self._waves(self._coeffs(name, "signal"), hours,
                       self.lay.n_levels(name))

  # -- the stores' arrays ----------------------------------------------------
  def truth(self, name) -> torch.Tensor:
    """(time, level, lon, lat), or (time, lon, lat) for a 2-D variable."""
    lay = self.lay
    x = self._signal(name, lay.hours(lay.truth_times))
    x = x + 0.01 * self._noise(x.shape, "truth", name)
    x = self._finish(name, x)
    return x if lay.is_3d(name) else x[:, 0]

  def forecast(self, name) -> torch.Tensor:
    """(init, [member,] lead, [level,] lon, lat) for every init."""
    lay = self.lay
    n_lev = lay.n_levels(name)
    n_i, n_j = len(lay.inits), len(lay.leads)
    lead_h = (lay.leads / HOUR).astype(np.float64)
    valid_h = lay.hours(lay.inits)[:, None] + lead_h[None, :]
    x = self._signal(name, valid_h.ravel()).reshape(
        n_i, n_j, n_lev, len(lay.lon), len(lay.lat))
    grow = torch.tensor(0.05 + 0.5 * lead_h / 240.0, dtype=torch.float32,
                        device=self.device).reshape(1, n_j, 1, 1, 1)
    err = torch.stack([
        self._waves(self._coeffs(name, "error", i), [0.0], n_lev,
                    drift=False)[0] for i in range(n_i)])  # (I, L, X, Y)
    x = x + grow * err[:, None]
    members = lay.members
    if members:
      spread = torch.tensor(0.03 + 0.45 * lead_h / 240.0,
                            dtype=torch.float32, device=self.device)
      spread = spread.reshape(1, 1, n_j, 1, 1, 1)
      pert = torch.stack([
          torch.stack([self._waves(self._coeffs(name, "member", i, m),
                                   [0.0], n_lev, drift=False)[0]
                       for m in range(members)])
          for i in range(n_i)])  # (I, M, L, X, Y)
      x = x[:, None] + spread * pert[:, :, None]
    x = x + 0.01 * self._noise(x.shape, "forecast", name)
    x = self._finish(name, x.reshape((-1, n_lev) + x.shape[-2:]))
    shape = (n_i,) + ((members,) if members else ()) + (n_j,)
    shape += ((n_lev,) if lay.is_3d(name) else ()) + x.shape[-2:]
    return x.reshape(shape)

  def climatology(self, name, doys) -> torch.Tensor:
    """The mean of ``name`` at days ``doys`` x the climatology's hours:
    (doy, hour, [level,] lon, lat); a slow annual drift of the signal's
    level, with the variable's mean."""
    lay = self.lay
    n_lev = lay.n_levels(name)
    hours = ((np.asarray(doys)[:, None] - 1) * 24.0
             + lay.clim_hours[None, :]).ravel()
    co = self._coeffs(name, "climatology")
    x = 0.3 * self._waves(co, hours / 50.0, n_lev)
    x = self._finish(name, x).reshape(
        (len(doys), len(lay.clim_hours), n_lev) + x.shape[-2:])
    return x if lay.is_3d(name) else x[:, :, 0]

  def quantiles(self, name, doys, quantiles) -> torch.Tensor:
    """``<name>_quantile``: (quantile, doy, hour, [level,] lon, lat), the
    climatological mean plus its normal quantile times 0.7 amplitudes."""
    mean = self.climatology(name, doys)
    _, amp, _ = self._stats(name)
    lay = self.lay
    a = torch.tensor(amp, dtype=torch.float32, device=self.device)
    a = a.reshape((-1, 1, 1)) if lay.is_3d(name) else a[0]
    z = torch.tensor([_normal_ppf(q) for q in quantiles],
                     dtype=torch.float32, device=self.device)
    z = z.reshape((-1,) + (1,) * mean.ndim)
    noise = self._noise((len(quantiles),) + mean.shape, "quantile", name)
    return mean[None] + (0.7 * z + 0.02 * noise) * a

  def seeps_threshold(self, doys) -> torch.Tensor:
    """Wet thresholds [m]: (doy, hour, lon, lat)."""
    shape = (len(doys), len(self.lay.clim_hours), len(self.lay.lon),
             len(self.lay.lat))
    u = 0.5 + 0.5 * torch.erf(self._noise(shape, "seeps_threshold")
                              / math.sqrt(2))
    return 5e-4 + 2.5e-3 * u

  def dry_fraction(self) -> torch.Tensor:
    """The climatological dry fraction per cell, (lon, lat), the same at
    every day and hour; values within 1e-3 of SEEPS's p1 edges are moved
    off them, so that no cell's mask hangs on the rounding of a mean."""
    shape = (len(self.lay.lon), len(self.lay.lat))
    u = 0.5 + 0.5 * torch.erf(self._noise(shape, "dry_fraction")
                              / math.sqrt(2))
    for edge in SEEPS_P1_EDGES:
      near = (u - edge).abs() < 1e-3
      u = torch.where(near, u + 2e-3, u)
    return u.clamp(0.0, 0.999)

  def land_sea_mask(self) -> torch.Tensor:
    """(lon, lat) in [0, 1): a smooth land fraction."""
    co = self._coeffs("land_sea_mask", "mask")
    x = self._waves(co, [0.0], 1, drift=False)[0, 0]
    return torch.sigmoid(3.0 * x)


def _normal_ppf(q: float) -> float:
  """The standard normal quantile (bisection on erf; q in (0, 1))."""
  lo, hi = -10.0, 10.0
  for _ in range(100):
    mid = 0.5 * (lo + hi)
    if 0.5 * (1 + math.erf(mid / math.sqrt(2))) < q:
      lo = mid
    else:
      hi = mid
  return 0.5 * (lo + hi)

"""Plain reference for job kind ``evaluate``: WeatherBench 2's scores of the
cell's inputs, in float64, from the arrays the harness draws from the seed.

It never reads the stores and imports nothing of the program: it draws the
same fields again (``harness.fields``), block by block (one variable and
level at a time), and computes each eval config's results as WeatherBench
2 defines them (Rasp et al. 2024; ``weatherbench2/metrics.py``):

* area weights: the normalised cell areas of the latitude bands, times a
  region's box mask (bounds inclusive) or its land fraction; a regional
  mean is sum(w x) / sum(w), over non-NaN cells where a metric skips NaN;
* deterministic scores (MSE with the wind-vector error, ACC against the
  climatology at the valid time's day of year and hour, bias, MAE, SEEPS
  and the RMSE with its square root before the time mean) per init, then
  their mean over inits, or per init for ``deterministic_temporal``; the
  spatial ones per cell, their mean over inits;
* SEEPS's categories are decided in float32, the data's type (as NumPy and
  JAX compare float32 data with the 0.25 mm threshold), its score and mask
  in float64;
* ensemble scores: CRPS from the pairwise mean |X - X'| over members (not
  the sorted estimator), ensemble mean MSE and its debiased form, the
  variance (ddof 1); Brier scores and the ignorance score at the
  climatological quantiles of the valid time, an infinite cell making its
  region's mean infinite.

The results are NumPy arrays in the results files' dims, keyed by config
and variable, with the labels of their metric, region and quantile axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from harness.fields import Fields, day_of_year, hour_of_day

# WeatherBench 2's predefined regions (--regions=all): name, latitude
# intervals, longitude intervals (a wrapped interval has lo > hi), land
ET = [(-math.inf, -20), (20, math.inf)]
REGIONS = [
    ("global", None, None, False),
    ("tropics", [(-20, 20)], None, False),
    ("extra-tropics", ET, None, False),
    ("northern-hemisphere", [(20, math.inf)], None, False),
    ("southern-hemisphere", [(-math.inf, -20)], None, False),
    ("europe", [(35, 75)], [(360 - 12.5, math.inf), (0, 42.5)], False),
    ("north-america", [(25, 60)], [(360 - 120, 360 - 75)], False),
    ("north-atlantic", [(25, 65)], [(360 - 70, 360 - 10)], False),
    ("north-pacific", [(25, 60)], [(145, 360 - 130)], False),
    ("east-asia", [(25, 60)], [(102.5, 150)], False),
    ("ausnz", [(-45, -12.5)], [(120, 175)], False),
    ("arctic", [(60, math.inf)], None, False),
    ("antarctic", [(-math.inf, -60)], None, False),
    ("global_land", None, None, True),
    ("extra-tropics_land", ET, None, True),
    ("tropics_land", [(-20, 20)], None, True),
]
DRY_MM = 0.25  # SEEPS's dry threshold for 24-hour precipitation
P1_RANGE = (0.1, 0.85)
WIND = ("u_component_of_wind", "v_component_of_wind", "wind_vector")
DET_METRICS = ["mse", "acc", "bias", "mae", "seeps_24hr"]
TEMPORAL_METRICS = DET_METRICS + ["rmse_sqrt_before_time_avg"]
SPATIAL_METRICS = ["bias", "mse", "mae", "seeps_24hr"]
PROB_METRICS = ["crps", "crps_spread", "crps_skill", "ensemble_mean_mse",
                "debiased_ensemble_mean_mse", "ensemble_variance"]
BINARY_METRICS = ["brier_score", "debiased_brier_score", "ignorance_score"]
CELL_BLOCK = 8192  # cells a block of the pairwise member differences


def _in(values, intervals):
  if intervals is None:
    return np.ones(len(values), bool)
  mask = np.zeros(len(values), bool)
  for lo, hi in intervals:
    mask |= ((values >= lo) & (values <= hi)) if lo <= hi else (
        (values >= lo) | (values <= hi))
  return mask


def area_weights(lat_deg) -> np.ndarray:
  """Normalised cell areas of the latitude bands (their mean is 1)."""
  lat = np.deg2rad(np.asarray(lat_deg, np.float64))
  bounds = np.concatenate([[-np.pi / 2], (lat[:-1] + lat[1:]) / 2,
                           [np.pi / 2]])
  w = np.sin(bounds[1:]) - np.sin(bounds[:-1])
  return w / w.mean()


def region_weights(lay, land: np.ndarray) -> np.ndarray:
  """(region, lon * lat) weights, float64."""
  w_lat = area_weights(lay.lat)
  out = []
  for _, lats, lons, is_land in REGIONS:
    w = (_in(lay.lon, lons)[:, None] * (_in(lay.lat, lats) * w_lat)[None, :])
    if is_land:
      w = w * land
    out.append(w.reshape(-1))
  return np.stack(out)


class _Regions:
  """Regional means by one float64 matrix product."""

  def __init__(self, weights: torch.Tensor):
    self.w = weights  # (R, N)
    self.total = weights.sum(1)

  def mean(self, x: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., R); NaN nowhere, +inf cells make +inf means."""
    flat = x.reshape(-1, x.shape[-1])
    inf = torch.isinf(flat)
    if inf.any():
      hit = (inf.to(torch.float64) @ (self.w > 0).to(torch.float64).T) > 0
      out = torch.where(inf, 0.0, flat) @ self.w.T / self.total
      out = torch.where(hit, math.inf, out)
    else:
      out = flat @ self.w.T / self.total
    return out.reshape(x.shape[:-1] + (self.w.shape[0],))

  def mean_skipna(self, x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1, x.shape[-1])
    valid = ~torch.isnan(flat)
    num = torch.where(valid, flat, 0.0) @ self.w.T
    den = valid.to(torch.float64) @ self.w.T
    return (num / den).reshape(x.shape[:-1] + (self.w.shape[0],))


def _valid_index(lay):
  """(init, lead) -> index of the valid time in the truth store's times."""
  valid = lay.inits[:, None] + lay.leads[None, :]
  step = lay.truth_times[1] - lay.truth_times[0]
  idx = (valid - lay.truth_times[0]) // step
  if not np.array_equal(lay.truth_times[idx], valid):
    raise ValueError("valid times missing from the truth")
  return idx, valid


def _clim_index(lay, valid):
  """(init, lead) -> (day-of-year row among the days drawn, hour row)."""
  doy = day_of_year(valid.ravel()).reshape(valid.shape)
  hour = hour_of_day(valid.ravel()).reshape(valid.shape)
  d = doy - lay.read_doys[0]
  h = np.searchsorted(lay.clim_hours, hour)
  if not np.array_equal(lay.clim_hours[h], hour):
    raise ValueError("valid hours missing from the climatology")
  return d, h


class Reference:
  """Expected results of one job over a cell's inputs."""

  def __init__(self, layout, seed: int, device):
    self.lay = layout
    self.fields = Fields(layout, seed, device)
    self.device = torch.device(device)
    land = self.fields.land_sea_mask().double().cpu().numpy()
    self.regions = _Regions(torch.tensor(region_weights(layout, land),
                                         device=self.device))
    vidx, valid = _valid_index(layout)
    cd, ch = _clim_index(layout, valid)
    as_index = lambda a: torch.as_tensor(a, dtype=torch.long,
                                         device=self.device)
    self.vidx, self.cd, self.ch = as_index(vidx), as_index(cd), as_index(ch)
    self.region_names = [r[0] for r in REGIONS]

  def _level_blocks(self, name, array):
    """(level index or None, block) for each level of a variable."""
    if self.lay.is_3d(name):
      axis = array.ndim - 3
      for l in range(array.shape[axis]):
        yield l, array.select(axis, l)
    else:
      yield None, array

  def results(self) -> dict:
    configs = self.lay.config["eval_configs"]
    out = {}
    if any(c.startswith("deterministic") for c in configs):
      out.update(self._deterministic(configs))
    if any(c in ("probabilistic", "ensemble_binary") for c in configs):
      out.update(self._probabilistic(configs))
    unknown = set(configs) - set(out)
    if unknown:
      raise ValueError(f"no reference for eval configs {sorted(unknown)}")
    return out

  # -- deterministic ---------------------------------------------------------
  def _deterministic(self, configs):
    lay, fl, reg = self.lay, self.fields, self.regions
    n_i, n_j = self.vidx.shape
    n_cells = len(lay.lon) * len(lay.lat)
    flat = lambda x: x.reshape(n_i, n_j, n_cells)
    det, temporal, spatial = {}, {}, {}
    seeps_name = lay.config["climatology"].get("seeps")
    wind_sq = {}

    def put(store, name, metric, level, value):
      store.setdefault(name, {}).setdefault(metric, {})[level] = value

    for name in lay.variables:
      truth = fl.truth(name)
      forecast = fl.forecast(name)
      clim = fl.climatology(name, lay.read_doys)
      for level, f in self._level_blocks(name, forecast):
        t = truth[self.vidx] if level is None else truth[:, level][self.vidx]
        c = clim[self.cd, self.ch] if level is None else (
            clim[:, :, level][self.cd, self.ch])
        f64, t64, c64 = f.double(), t.double(), c.double()
        d = f64 - t64
        sq = d * d
        fa, ta = f64 - c64, t64 - c64
        per_init = {
            "mse": reg.mean(flat(sq)),
            "bias": reg.mean(flat(d)),
            "mae": reg.mean(flat(d.abs())),
            "acc": reg.mean(flat(fa * ta)) / torch.sqrt(
                reg.mean(flat(fa * fa)) * reg.mean(flat(ta * ta))),
        }
        per_init["rmse_sqrt_before_time_avg"] = torch.sqrt(per_init["mse"])
        cells = {"bias": d, "mse": sq, "mae": d.abs()}
        if name == seeps_name:
          score = self._seeps(f, t)
          per_init["seeps_24hr"] = reg.mean_skipna(flat(score))
          cells["seeps_24hr"] = score
        if name in WIND[:2]:
          wind_sq.setdefault(level, []).append(sq)
        for metric, v in per_init.items():
          put(temporal, name, metric, level, v)
          if metric != "rmse_sqrt_before_time_avg":
            put(det, name, metric, level, v.mean(0))
        for metric, v in cells.items():
          put(spatial, name, metric, level, v.mean(0))
    for level, (su, sv) in wind_sq.items():
      mse = reg.mean(flat(su + sv))
      put(temporal, WIND[2], "mse", level, mse)
      put(temporal, WIND[2], "rmse_sqrt_before_time_avg", level,
          torch.sqrt(mse))
      put(det, WIND[2], "mse", level, mse.mean(0))

    out = {}
    if "deterministic" in configs:
      # (metric, region, lead[, level]) from per-level (lead, region)
      out["deterministic"] = self._assemble(
          det, DET_METRICS, ("metric", "region", "lead_time"),
          lambda v: v.T)
    if "deterministic_temporal" in configs:
      out["deterministic_temporal"] = self._assemble(
          temporal, TEMPORAL_METRICS,
          ("metric", "region", "init_time", "lead_time"),
          lambda v: v.permute(2, 0, 1))
    if "deterministic_spatial" in configs:
      shape = (n_j, len(lay.lon), len(lay.lat))
      out["deterministic_spatial"] = self._assemble(
          spatial, SPATIAL_METRICS,
          ("metric", "lead_time", "longitude", "latitude"),
          lambda v: v.reshape(shape), level_axis=2, regions=False)
    return out

  def _seeps(self, f, t) -> torch.Tensor:
    """SEEPS per (init, lead, lon, lat), NaN outside the p1 mask."""
    fl = self.fields
    wet = fl.seeps_threshold(self.lay.read_doys)[self.cd, self.ch]
    p1 = fl.dry_fraction().double()  # the same at every day and hour
    dry = torch.tensor(DRY_MM / 1000.0, dtype=torch.float32,
                       device=self.device)

    def categories(x):  # float32 comparisons, as in the data's type
      return [(x < dry).double(), ((x > dry) & (x < wet)).double(),
              (x >= wet).double()]

    fd, fli, fh = categories(f)
    td, tli, th = categories(t)
    score = 0.5 * (fd * tli / (1 - p1) + fd * th * 4 / (1 - p1)
                   + fli * td / p1 + fli * th * 3 / (1 - p1)
                   + fh * td * (1 / p1 + 3 / (2 + p1))
                   + fh * tli * 3 / (2 + p1))
    keep = (p1 < P1_RANGE[1]) & (p1 > P1_RANGE[0])
    return torch.where(keep, score, math.nan)

  # -- probabilistic ---------------------------------------------------------
  def _probabilistic(self, configs):
    lay, fl, reg = self.lay, self.fields, self.regions
    n_i, n_j = self.vidx.shape
    n_cells = len(lay.lon) * len(lay.lat)
    quantiles = lay.config["climatology"].get("quantiles") or []
    prob, binary = {}, {}
    for name in lay.variables:
      truth = fl.truth(name)
      forecast = fl.forecast(name)  # (I, M, J, [L,] X, Y)
      q_all = (fl.quantiles(name, lay.read_doys, quantiles)
               if quantiles else None)
      for level, f in self._level_blocks(name, forecast):
        t = truth[self.vidx] if level is None else truth[:, level][self.vidx]
        scores = {m: [] for m in PROB_METRICS}
        bscores = {m: [] for m in BINARY_METRICS}
        for i in range(n_i):
          ens = f[i].reshape(f.shape[1], n_j, n_cells)  # (M, J, N) float32
          obs = t[i].reshape(n_j, n_cells)
          per = self._ensemble_fields(ens, obs)
          for m in PROB_METRICS:
            scores[m].append(reg.mean(per[m]))
          if q_all is not None:
            thr = q_all[:, self.cd[i], self.ch[i]]
            if level is not None:
              thr = thr[:, :, level]
            thr = thr.reshape(len(quantiles), n_j, n_cells)
            per_q = [self._binary_fields(ens, obs, thr[k])
                     for k in range(len(quantiles))]
            for m in BINARY_METRICS:
              bscores[m].append(torch.stack(
                  [reg.mean(p[m]) for p in per_q]))  # (Q, J, R)
        for m in PROB_METRICS:
          v = torch.stack(scores[m]).mean(0)  # (J, R)
          prob.setdefault(name, {}).setdefault(m, {})[level] = v
        if q_all is not None:
          for m in BINARY_METRICS:
            v = torch.stack(bscores[m]).mean(0)  # (Q, J, R)
            binary.setdefault(name, {}).setdefault(m, {})[level] = v
    out = {}
    if "probabilistic" in configs:
      out["probabilistic"] = self._assemble(
          prob, PROB_METRICS, ("metric", "region", "lead_time"),
          lambda v: v.T)
    if "ensemble_binary" in configs:
      out["ensemble_binary"] = self._assemble(
          binary, BINARY_METRICS,
          ("metric", "region", "quantile", "lead_time"),
          lambda v: v.permute(2, 0, 1), quantiles=quantiles)
    return out

  def _ensemble_fields(self, ens, obs) -> dict:
    """Per-cell ensemble scores, float64, (J, N) each."""
    m = ens.shape[0]
    e = ens.double()
    o = obs.double()
    mean = e.mean(0)
    var = ((e - mean) ** 2).sum(0) / (m - 1)
    skill = (e - o).abs().mean(0)
    spread = torch.empty_like(skill)
    flat_e = e.reshape(m, -1)
    flat_s = spread.reshape(-1)
    for start in range(0, flat_e.shape[1], CELL_BLOCK):
      blk = flat_e[:, start:start + CELL_BLOCK]
      pair = (blk[:, None, :] - blk[None, :, :]).abs().sum((0, 1))
      flat_s[start:start + CELL_BLOCK] = pair / (m * (m - 1))
    mse = (o - mean) ** 2
    return {"crps": skill - 0.5 * spread, "crps_spread": spread,
            "crps_skill": skill, "ensemble_mean_mse": mse,
            "debiased_ensemble_mean_mse": mse - var / m,
            "ensemble_variance": var}

  @staticmethod
  def _binary_fields(ens, obs, thr) -> dict:
    """Brier, debiased Brier and ignorance scores per cell, (J, N)."""
    m = ens.shape[0]
    above = (ens > thr[None]).double()  # float32 comparisons, exact
    truth = (obs > thr).double()
    p = above.mean(0)
    var = ((above - p) ** 2).sum(0) / (m - 1)
    brier = (p - truth) ** 2
    ign = -torch.where(truth > 0, torch.log(p), torch.log(1 - p))
    return {"brier_score": brier, "debiased_brier_score": brier - var / m,
            "ignorance_score": ign}

  # -- layout ------------------------------------------------------------------
  def _assemble(self, store, metrics, dims, arrange, level_axis=None,
                regions=True, quantiles=None):
    """{variable: (dims, labels, float64 array)}: per metric and level the
    ``arrange``d block, NaN for a metric the variable has not."""
    out = {}
    for name, by_metric in store.items():
      levels = sorted(next(iter(by_metric.values())))
      blocks = []
      for metric in metrics:
        per_level = by_metric.get(metric)
        if per_level is None:
          blocks.append(None)
          continue
        arr = [arrange(per_level[l]) for l in levels]
        if levels != [None]:
          axis = len(dims) - 1 if level_axis is None else level_axis - 1
          blocks.append(torch.stack(arr, axis))
        else:
          blocks.append(arr[0])
      like = next(b for b in blocks if b is not None)
      full = torch.stack([torch.full_like(like, math.nan) if b is None else b
                          for b in blocks])
      var_dims = list(dims)
      if levels != [None]:
        var_dims.insert(len(dims) if level_axis is None else level_axis,
                        "level")
      labels = {"metric": list(metrics)}
      if regions:
        labels["region"] = list(self.region_names)
      if quantiles:
        labels["quantile"] = [float(q) for q in quantiles]
      out[name] = (tuple(var_dims), labels, full.cpu().numpy())
    return out

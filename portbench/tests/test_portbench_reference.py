"""The reference against a float64 NumPy brute force at a tiny size.

The brute force selects each region's cells by label and weights them by
the cosine-integral cell areas, loops over inits, leads and members, and
takes CRPS's spread from the sorted (PWM) estimator: another route to the
same definitions than the reference's matrix products and pairwise sums.
"""
import copy
import json
import math
import pathlib

import numpy as np
import pytest

from harness import fields
from reference import evaluate as ref

BENCH = pathlib.Path(__file__).resolve().parents[1]


def _layout(config, traffic, inits):
  cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
  tr = copy.deepcopy(json.loads(
      (BENCH / "traffic" / f"{traffic}.json").read_text()))
  cfg["grid"] = {"longitudes": 24, "latitudes": 13, "poles": True}
  cfg["leads"] = {"count": 3, "step_hours": 12}
  if cfg.get("members"):
    cfg["members"] = 4
  tr["inits_per_job"] = inits
  return fields.Layout(cfg, tr)


def _weights(lay, land):
  lat = np.deg2rad(lay.lat)
  edges = [-math.pi / 2] + [(a + b) / 2 for a, b in zip(lat[:-1], lat[1:])]
  edges.append(math.pi / 2)
  area = np.array([math.sin(edges[i + 1]) - math.sin(edges[i])
                   for i in range(len(lat))])
  out = {}
  for name, lats, lons, is_land in ref.REGIONS:
    w = np.zeros((len(lay.lon), len(lay.lat)))
    for x, lo in enumerate(lay.lon):
      for y, la in enumerate(lay.lat):
        inside = all([
            lats is None or any(a <= la <= b for a, b in lats),
            lons is None or any((a <= lo <= b) if a <= b else
                                (lo >= a or lo <= b) for a, b in lons)])
        if inside:
          w[x, y] = area[y] * (land[x, y] if is_land else 1.0)
    out[name] = w
  return out


def _mean(x, w, skipna=False):
  keep = ~np.isnan(x) if skipna else np.ones(x.shape, bool)
  return (np.where(keep, x, 0) * w).sum() / (w * keep).sum()


def _series(lay, fl, name, level):
  t = fl.truth(name).numpy().astype(np.float64)
  f = fl.forecast(name).numpy().astype(np.float64)
  if level is not None:
    t = t[:, level]
    f = f[..., level, :, :]
  step = lay.truth_times[1] - lay.truth_times[0]
  idx = [[int((i + l - lay.truth_times[0]) // step) for l in lay.leads]
         for i in lay.inits]
  return f, t, np.asarray(idx)


def test_deterministic_matches_brute_force():
  lay = _layout("wb2-det-1.5deg", "raw-32inits", 2)
  fl = fields.Fields(lay, 77, "cpu")
  got = ref.Reference(lay, 77, "cpu").results()
  land = fl.land_sea_mask().numpy().astype(np.float64)
  w = _weights(lay, land)
  regions = [r[0] for r in ref.REGIONS]
  valid = lay.inits[:, None] + lay.leads[None, :]
  doy = fields.day_of_year(valid.ravel()).reshape(valid.shape)
  hour = fields.hour_of_day(valid.ravel()).reshape(valid.shape)
  for name, level in [("temperature", 1), ("2m_temperature", None),
                      ("total_precipitation_24hr", None)]:
    f, t, idx = _series(lay, fl, name, level)
    clim = fl.climatology(name, lay.read_doys).numpy().astype(np.float64)
    if level is not None:
      clim = clim[:, :, level]
    dims, labels, det = got["deterministic"][name]
    _, tlabels, tem = got["deterministic_temporal"][name]
    _, _, spa = got["deterministic_spatial"][name]
    pick = lambda a: a[..., level] if level is not None else a
    for r in ["global", "europe", "tropics_land", "arctic"]:
      ri = regions.index(r)
      for j in range(len(lay.leads)):
        per = {k: [] for k in ("mse", "acc", "bias", "mae")}
        for i in range(len(lay.inits)):
          d = f[i, j] - t[idx[i, j]]
          c = clim[doy[i, j] - lay.read_doys[0],
                   list(lay.clim_hours).index(hour[i, j])]
          fa, ta = f[i, j] - c, t[idx[i, j]] - c
          per["mse"].append(_mean(d * d, w[r]))
          per["bias"].append(_mean(d, w[r]))
          per["mae"].append(_mean(np.abs(d), w[r]))
          per["acc"].append(_mean(fa * ta, w[r]) / math.sqrt(
              _mean(fa * fa, w[r]) * _mean(ta * ta, w[r])))
          np.testing.assert_allclose(
              pick(tem[tlabels["metric"].index("rmse_sqrt_before_time_avg"),
                       ri, i, j]), math.sqrt(per["mse"][-1]), rtol=1e-12)
        for k, v in per.items():
          np.testing.assert_allclose(
              pick(det[labels["metric"].index(k), ri, j]), np.mean(v),
              rtol=1e-10, atol=1e-12)
    mse_cells = np.mean([(f[i] - t[idx[i]]) ** 2
                         for i in range(len(lay.inits))], axis=0)
    spatial_mse = spa[1] if level is None else spa[1][:, level]
    np.testing.assert_allclose(spatial_mse, mse_cells, rtol=1e-12)
  # SEEPS, global, from its scoring matrix
  f, t, idx = _series(lay, fl, "total_precipitation_24hr", None)
  p1 = fl.dry_fraction().numpy().astype(np.float64)
  wet_all = fl.seeps_threshold(lay.read_doys).numpy()
  _, labels, det = got["deterministic"]["total_precipitation_24hr"]
  f32 = fl.forecast("total_precipitation_24hr").numpy()
  t32 = fl.truth("total_precipitation_24hr").numpy()
  dry = np.float32(0.25 / 1000)
  for j in range(len(lay.leads)):
    vals = []
    for i in range(len(lay.inits)):
      wet = wet_all[doy[i, j] - lay.read_doys[0],
                    list(lay.clim_hours).index(hour[i, j])]
      cat = lambda x: np.where(x < dry, 0, np.where(x < wet, 1, 2))
      cf, ct = cat(f32[i, j]), cat(t32[idx[i, j]])
      light_edge = (f32[i, j] == dry) | (t32[idx[i, j]] == dry)
      assert not light_edge.any()
      score = np.zeros(p1.shape)
      table = {(0, 1): 1 / (1 - p1), (0, 2): 4 / (1 - p1), (1, 0): 1 / p1,
               (1, 2): 3 / (1 - p1), (2, 0): 1 / p1 + 3 / (2 + p1),
               (2, 1): 3 / (2 + p1)}
      for (a, b), v in table.items():
        score += np.where((cf == a) & (ct == b), 0.5 * v, 0.0)
      score = np.where((p1 > 0.1) & (p1 < 0.85), score, np.nan)
      vals.append(_mean(score, w["global"], skipna=True))
    np.testing.assert_allclose(
        det[labels["metric"].index("seeps_24hr"), 0, j], np.mean(vals),
        rtol=1e-10)


def test_probabilistic_matches_brute_force():
  lay = _layout("wb2-ens50-1.5deg", "raw-2inits", 1)
  fl = fields.Fields(lay, 78, "cpu")
  got = ref.Reference(lay, 78, "cpu").results()
  land = fl.land_sea_mask().numpy().astype(np.float64)
  w = _weights(lay, land)
  regions = [r[0] for r in ref.REGIONS]
  valid = lay.inits[:, None] + lay.leads[None, :]
  doy = fields.day_of_year(valid.ravel()).reshape(valid.shape)
  hour = fields.hour_of_day(valid.ravel()).reshape(valid.shape)
  qs = lay.config["climatology"]["quantiles"]
  name, level = "geopotential", 2
  f, t, idx = _series(lay, fl, name, level)
  q_all = fl.quantiles(name, lay.read_doys, qs).numpy()[:, :, :, level]
  _, labels, prob = got["probabilistic"][name]
  _, blabels, binary = got["ensemble_binary"][name]
  m = f.shape[1]
  for r in ["global", "tropics", "north-pacific"]:
    ri = regions.index(r)
    for j in range(len(lay.leads)):
      ens, obs = f[0, :, j], t[idx[0, j]]
      srt = np.sort(ens, axis=0)
      coef = (2 * np.arange(1, m + 1) - m - 1)[:, None, None]
      spread = 2 * (coef * srt).sum(0) / (m * (m - 1))
      skill = np.abs(ens - obs).mean(0)
      mean = ens.mean(0)
      var = ens.var(0, ddof=1)
      want = {"crps": skill - 0.5 * spread, "crps_spread": spread,
              "crps_skill": skill, "ensemble_variance": var,
              "ensemble_mean_mse": (obs - mean) ** 2,
              "debiased_ensemble_mean_mse": (obs - mean) ** 2 - var / m}
      for k, v in want.items():
        np.testing.assert_allclose(
            prob[labels["metric"].index(k), ri, j, level], _mean(v, w[r]),
            rtol=1e-9, atol=1e-9)
      for qi in range(len(qs)):
        thr = q_all[qi, doy[0, j] - lay.read_doys[0],
                    list(lay.clim_hours).index(hour[0, j])]
        above = (fl.forecast(name).numpy()[0, :, j, level] > thr)
        truth = fl.truth(name).numpy()[idx[0, j], level] > thr
        p = above.mean(0)
        brier = (p - truth) ** 2
        with np.errstate(divide="ignore"):
          ign = np.where(truth, -np.log(p), -np.log(1 - p))
        want = {"brier_score": _mean(brier, w[r]),
                "debiased_brier_score": _mean(
                    brier - above.var(0, ddof=1) / m, w[r])}
        inside = w[r] > 0
        want["ignorance_score"] = (math.inf if np.isinf(ign[inside]).any()
                                   else _mean(np.where(inside, ign, 0), w[r]))
        for k, v in want.items():
          np.testing.assert_allclose(
              binary[blabels["metric"].index(k), ri, qi, j, level], v,
              rtol=1e-9, atol=1e-12)


def test_regions_are_weatherbench2s_sixteen():
  assert len(ref.REGIONS) == 16
  assert [r[0] for r in ref.REGIONS][-3:] == [
      "global_land", "extra-tropics_land", "tropics_land"]


@pytest.mark.parametrize("lat", [[-90.0, 0.0, 90.0], [-60.0, -20.0, 20.0]])
def test_area_weights_mean_one(lat):
  assert np.isclose(ref.area_weights(lat).mean(), 1.0)

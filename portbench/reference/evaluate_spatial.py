"""Plain reference for job kind ``evaluate_spatial``: the per-cell configs
of WeatherBench 2's ensemble command, in float64, from the arrays the
harness draws from the seed.

It imports nothing of the program and reuses the kind ``evaluate``'s
reference (its fields, its valid-time index and its per-cell ensemble
scores), one variable and level at a time:

* ``probabilistic_spatial``: the six per-cell scores of
  ``Reference._ensemble_fields`` (CRPS from the pairwise mean |X - X'|,
  its spread and skill, the ensemble-mean MSE and its debiased form, the
  variance), averaged over inits: exact values, in the results' dims
  (metric, lead_time[, level], longitude, latitude);
* ``probabilistic_spatial_histograms``: the rank histogram of 51 bins
  (members + 1), which the program draws at random where members equal
  the truth.  For each init, lead and cell, ``below`` members lie under
  the truth and ``equal`` on it (compared in float32, the data's type),
  and the truth's rank is uniform over ``[below, below + equal]``.  The
  histogram is the mean over inits of the rank's one-hot, held as
  ``compare.Bounds``: ``low``, the share of inits whose rank is certainly
  the bin, ``high``, the share whose range holds it; its ``Sums`` over
  ``bins``, 1 in every cell; and a ``Statistic`` of the bin index, whose
  mean over a block (one variable and level) is ``below + equal / 2``
  averaged over its inits, leads and cells, with the sd
  ``sqrt(sum(((equal + 1)**2 - 1) / 12)) / n`` of ``n`` draws.

The counts run on the reference's device, one variable and level at a
time; the fields hold no NaN (the harness draws finite values), and a
non-finite truth or member is refused rather than ranked.
"""
from __future__ import annotations

import numpy as np
import torch

from harness import compare
from reference import evaluate

PROB_METRICS = evaluate.PROB_METRICS
HIST_METRIC = "rank_histogram"


class Reference(evaluate.Reference):
  """Expected results of one job of the per-cell configs."""

  def results(self) -> dict:
    configs = self.lay.config["eval_configs"]
    unknown = set(configs) - {"probabilistic_spatial",
                              "probabilistic_spatial_histograms"}
    if unknown:
      raise ValueError(f"no reference for eval configs {sorted(unknown)}")
    lay, fl = self.lay, self.fields
    n_i, n_j = self.vidx.shape
    n_x, n_y = len(lay.lon), len(lay.lat)
    n_cells = n_x * n_y
    spatial, hist = {}, {}
    for name in lay.variables:
      truth = fl.truth(name)
      forecast = fl.forecast(name)  # (I, M, J, [L,] X, Y)
      hists = _Histograms(n_i, (n_j, n_x, n_y, forecast.shape[1] + 1),
                          lay.n_levels(name) if lay.is_3d(name) else None)
      for level, f in self._level_blocks(name, forecast):
        t = truth[self.vidx] if level is None else truth[:, level][self.vidx]
        ens = f.reshape(n_i, f.shape[1], n_j, n_cells)  # float32
        obs = t.reshape(n_i, n_j, n_cells)
        if not (torch.isfinite(ens).all() and torch.isfinite(obs).all()):
          raise ValueError(f"{name} level {level}: non-finite values")
        if "probabilistic_spatial" in configs:
          scores = {m: 0.0 for m in PROB_METRICS}
          for i in range(n_i):
            per = self._ensemble_fields(ens[i], obs[i])
            for m in PROB_METRICS:
              scores[m] = scores[m] + per[m] / n_i
          for m, v in scores.items():
            spatial.setdefault(name, {}).setdefault(m, {})[level] = v
        if "probabilistic_spatial_histograms" in configs:
          hists.add(level, _rank_counts(ens, obs))
      if hists.stats:
        hist[name] = hists.entry()
    out = {}
    if "probabilistic_spatial" in configs:
      out["probabilistic_spatial"] = self._assemble(
          spatial, PROB_METRICS,
          ("metric", "lead_time", "longitude", "latitude"),
          lambda v: v.reshape(n_j, n_x, n_y), level_axis=2, regions=False)
    if "probabilistic_spatial_histograms" in configs:
      out["probabilistic_spatial_histograms"] = hist
    return out


def _rank_counts(ens, obs):
  """One variable-level's counts over inits, (J, N, bins) int16 each: of
  inits whose rank is certainly the bin, and of inits whose range holds
  it; and its statistic's mean and sd.  ``ens`` (I, M, J, N) and ``obs``
  (I, J, N), float32."""
  n_bins = ens.shape[1] + 1
  below = (ens < obs[:, None]).sum(1)  # (I, J, N)
  equal = (ens == obs[:, None]).sum(1)
  # sure: the one-hot of the rank where there is no tie; can: 1 over
  # [below, below + equal], as +1 at below and -1 past its end, summed
  sure = torch.zeros(below.shape[1:] + (n_bins,), dtype=torch.int32,
                     device=ens.device)
  can = torch.zeros(below.shape[1:] + (n_bins + 1,), dtype=torch.int32,
                    device=ens.device)
  for i in range(below.shape[0]):
    sure.scatter_add_(-1, below[i, ..., None],
                      (equal[i] == 0).int()[..., None])
    can.scatter_add_(-1, below[i, ..., None],
                     torch.ones_like(sure[..., :1]))
    can.scatter_add_(-1, (below[i] + equal[i] + 1)[..., None],
                     -torch.ones_like(sure[..., :1]))
  can = can.cumsum(-1)[..., :n_bins]
  n = below.numel()
  mean = (below.double() + equal.double() / 2).sum() / n
  var = (((equal.double() + 1) ** 2 - 1) / 12).sum()
  return (sure.to(torch.int16).cpu().numpy(),
          can.to(torch.int16).cpu().numpy(), float(mean),
          float(torch.sqrt(var)) / n)


class _Histograms:
  """A variable's bounds filled level by level: the counts over inits as
  shares of the ``n_inits`` (exactly as the program's mean of its one-hot
  over inits), in the results' dims."""

  def __init__(self, n_inits, shape, n_levels):
    self.n_inits = n_inits
    self.levels = n_levels  # None for a 2-D variable
    full = (1,) + shape[:1] + ((n_levels,) if n_levels else ()) + shape[1:]
    self.low = np.empty(full)
    self.high = np.empty(full)
    self.stats = []

  def add(self, level, counts) -> None:
    sure, can, mean, sd = counts
    at = (0, slice(None)) + ((level,) if self.levels else ())
    shape = self.low[at].shape
    np.divide(sure.reshape(shape), self.n_inits, out=self.low[at])
    np.divide(can.reshape(shape), self.n_inits, out=self.high[at])
    self.stats.append((mean, sd))

  def entry(self):
    """The variable's (dims, labels, ``compare.Bounds``) over (metric,
    lead_time[, level], longitude, latitude, bins)."""
    dims = ("metric", "lead_time") + (("level",) if self.levels else ()) + (
        "longitude", "latitude", "bins")
    n_bins = self.low.shape[-1]
    mean, sd = (np.array([[x[k] for x in self.stats]] if self.levels
                         else [self.stats[0][k]]) for k in (0, 1))
    bounds = compare.Bounds(
        self.low, self.high,
        compare.Sums("bins", np.ones(self.low.shape[:-1])),
        compare.Statistic("bins", np.arange(n_bins, dtype=np.float64), mean,
                          sd))
    return dims, {"metric": [HIST_METRIC]}, bounds

"""The probabilistic modules of the port against the JAX package, on the CPU.

Small chunks made from seeds with numpy (5 members, 3 inits x 2 leads, a
2-level and a surface variable, 12 x 7 cells, float32, NaN members and NaN
truth cells) go through the JAX package's function and its counterpart in
the port:

  * the labeled operations the metrics reach (std/var with ddof and skipna,
    isnull/notnull, cumsum, swap_dims, where, zeros_like, concat along a new
    dim, nearest selection with a tolerance) and the thresholds;
  * every probabilistic metric's ``compute_chunk``, on host arrays and on
    tensors, without and with a region, in both ``skipna`` modes;
  * what feeds kernel 2: each pointwise-fused metric's fields, and the
    probabilistic plan's member pass and region means;
  * the tier routing, ``convert`` of the seeded rank histogram and of the
    thresholds, ``central_reliability``.

Tolerance, as in ``tests/test_torch_evaluation.py``: ``rtol=1e-5`` plus
``atol=1e-5 x max|reference|`` per variable (the port's indicators and
member statistics are float32 on tensors, the JAX package's float64 here
under x64); NaN and inf in the same places; rank histograms equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import regions as jregions
from weatherbench2_tpu import thresholds as jthresholds
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.parallel import streaming as jstreaming
from weatherbench2_torch import convert
from weatherbench2_torch import metrics
from weatherbench2_torch import regions
from weatherbench2_torch import thresholds
from weatherbench2_torch import xds
from weatherbench2_torch.parallel import streaming

RTOL = 1e-5
ENS = "realization"
LAT = np.linspace(-90, 90, 7)
LON = np.linspace(0, 360, 12, endpoint=False)
INIT = np.datetime64("2020-02-27", "ns") + np.arange(3) * np.timedelta64(
    12, "h")
LEAD = (np.arange(2) * np.timedelta64(12, "h")).astype("timedelta64[ns]")
QUANTILES = (0.25, 0.75)


def _coords(with_members):
  coords = {"init_time": INIT, "lead_time": LEAD, "level": np.array([500, 850]),
            "longitude": LON, "latitude": LAT,
            "valid_time": (("init_time", "lead_time"),
                           INIT[:, None] + LEAD[None, :])}
  if with_members:
    coords[ENS] = np.arange(5)
  return coords


def _both(arrays, coords):
  """(JAX package's Dataset, port's Dataset) of {name: (dims, array)}."""
  jcoords = {k: (jxds.Variable(*v) if isinstance(v, tuple) else v)
             for k, v in coords.items()}
  return (jxds.Dataset(arrays, coords=jcoords),
          convert.dataset_from_arrays(arrays, coords))


def _chunk(seed, ties=False, nans=True):
  """{"jax": (forecast, truth), "port": (...)} of an ensemble chunk."""
  rs = np.random.RandomState(seed)
  other = ("init_time", "lead_time")
  shapes = {"z": (other + ("level", "longitude", "latitude"), (3, 2, 2, 12, 7)),
            "t2m": (other + ("longitude", "latitude"), (3, 2, 12, 7))}
  fc, tr = {}, {}
  for name, (dims, shape) in shapes.items():
    f = rs.randn(5, *shape).astype(np.float32)
    t = rs.randn(*shape).astype(np.float32)
    if ties:
      f, t = np.round(2 * f) / 2, np.round(2 * t) / 2
    if nans:
      f[rs.rand(*f.shape) < 0.04] = np.nan
      t[rs.rand(*t.shape) < 0.04] = np.nan
    fc[name] = ((ENS,) + dims, f)
    tr[name] = (dims, t)
  jf, pf = _both(fc, _coords(True))
  jt, pt = _both(tr, _coords(False))
  return {"jax": (jf, jt), "port": (pf, pt)}


def _gaussian_chunk(seed):
  rs = np.random.RandomState(seed)
  pair = _chunk(seed + 1)
  fc = {}
  for name in ("z", "t2m"):
    dims = pair["jax"][1][name].dims
    mean = rs.randn(*pair["jax"][1][name].shape).astype(np.float32)
    fc[name] = (dims, mean)
    fc[f"{name}_std"] = (dims, (np.abs(mean) + 0.5).astype(np.float32))
  jf, pf = _both(fc, _coords(False))
  return {"jax": (jf, pair["jax"][1]), "port": (pf, pair["port"][1])}


def _threshold_datasets(seed):
  """One threshold Dataset per quantile, near ±0.6 (whole ensembles fall on
  one side: infinite ignorance scores)."""
  rs = np.random.RandomState(seed)
  out = {"jax": [], "port": []}
  for sign in (-1, 1):
    arrays = {
        "z": (("init_time", "lead_time", "level", "longitude", "latitude"),
              sign * 0.6 + 0.1 * rs.randn(3, 2, 2, 12, 7)),
        "t2m": (("init_time", "lead_time", "longitude", "latitude"),
                sign * 0.6 + 0.1 * rs.randn(3, 2, 12, 7))}
    j, p = _both(arrays, _coords(False))
    out["jax"].append(j)
    out["port"].append(p)
  return out


def _as_dataset(result):
  return result if hasattr(result, "keys") else result.to_dataset(name="v")


def assert_close(got, want, what, exact=False):
  got, want = _as_dataset(got), _as_dataset(want)
  assert sorted(got.keys()) == sorted(want.keys()), what
  for k in want.keys():
    assert set(got[k].dims) == set(want[k].dims), f"{what}/{k}"
    g = np.asarray(got[k].transpose(*want[k].dims).values, np.float64)
    w = np.asarray(want[k].values, np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                  err_msg=f"{what}/{k} NaN")
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w),
                                  err_msg=f"{what}/{k} inf")
    if exact:
      np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")
    elif np.isfinite(w).any():
      np.testing.assert_allclose(
          g, w, rtol=RTOL, atol=RTOL * np.abs(w[np.isfinite(w)]).max(),
          err_msg=f"{what}/{k}")


def _tensors(pair):
  return tuple(xds.to_device(ds, torch.device("cpu")) for ds in pair)


# -- the labeled layer and the thresholds --------------------------------------


@pytest.mark.parametrize("skipna", [False, True])
@pytest.mark.parametrize("op", ["std0", "var0", "std1", "var1", "cumsum",
                                "isnull", "notnull", "zeros_like"])
def test_labeled_operations_match(op, skipna):
  pair = _chunk(1)
  fns = {
      "std0": lambda f: f.std(ENS, ddof=0, skipna=skipna),
      "var0": lambda f: f.var(ENS, ddof=0, skipna=skipna),
      "std1": lambda f: f.std(ENS, ddof=1, skipna=skipna),
      "var1": lambda f: f.var(ENS, ddof=1, skipna=skipna),
      "cumsum": lambda f: f.cumsum(ENS, skipna=skipna),
      "isnull": lambda f: f.isnull(),
      "notnull": lambda f: f.notnull(),
  }
  want = (jxds.zeros_like(pair["jax"][0]) if op == "zeros_like"
          else fns[op](pair["jax"][0]))
  for tag, f in (("host", pair["port"][0]),
                 ("tensor", _tensors(pair["port"])[0])):
    got = xds.zeros_like(f) if op == "zeros_like" else fns[op](f)
    assert_close(got, want, f"{op} {tag}")
    assert all(_is(v.data, tag) for v in got.variables_dict().values())


def _is(data, tag):
  return isinstance(data, torch.Tensor) == (tag == "tensor")


def test_nanvar_with_fewer_valid_values_than_ddof_is_nan():
  x = torch.tensor([[1.0, np.nan, np.nan], [np.nan] * 3, [1.0, 2.0, 4.0]])
  got = xds.DataArray(x, dims=("a", "m")).var("m", ddof=1, skipna=True)
  np.testing.assert_array_equal(np.isnan(got.values), [True, True, False])
  np.testing.assert_allclose(got.values[2], np.var([1.0, 2.0, 4.0], ddof=1))


def test_where_swap_dims_concat_and_nearest_selection():
  pair = _chunk(2)
  (jf, jt), (pf, pt) = pair["jax"], pair["port"]
  for tag, f, t in (("host", pf, pt), ("tensor", *_tensors(pair["port"]))):
    assert_close(xds.where(f.isnull(), np.nan, f > t),
                 jxds.where(jf.isnull(), np.nan, jf > jt), f"where {tag}")
    assert_close(xds.where(t["z"] > 0, 1.0, t["z"]),
                 jxds.where(jt["z"] > 0, 1.0, jt["z"]), f"where da {tag}")
    assert_close(xds.concat([t, t * 2], dim="quantile"),
                 jxds.concat([jt, jt * 2], dim="quantile"), f"concat {tag}")
  swapped = pt.assign_coords(day=xds.Variable(("init_time",),
                                              np.array([7, 8, 9])))
  out = swapped.swap_dims({"init_time": "day"})
  assert out["z"].dims[0] == "day"
  assert out.coords_dict()["init_time"].dims == ("day",)
  with pytest.raises(KeyError):
    pt.swap_dims({"init_time": "nothing"})
  q = convert.dataset_from_arrays(
      {"x": (("quantile",), np.array([1.0, 2.0, 3.0]))},
      {"quantile": np.array([0.1, 0.5, 0.9])})
  assert float(q.sel(quantile=0.505, method="nearest",
                     tolerance=0.01)["x"].values) == 2.0
  with pytest.raises(KeyError):
    q.sel(quantile=0.3, method="nearest", tolerance=0.01)


def _quantile_climatology(seed, hourly=True):
  rs = np.random.RandomState(seed)
  dims = ("quantile", "dayofyear") + (("hour",) if hourly else ()) + (
      "level", "longitude", "latitude")
  shape = (2, 366) + ((2,) if hourly else ()) + (2, 12, 7)
  coords = {"quantile": np.array(QUANTILES), "dayofyear": 1 + np.arange(366),
            "level": np.array([500, 700, 850])[[0, 2]], "longitude": LON,
            "latitude": LAT}
  if hourly:
    coords["hour"] = np.array([0, 12])
  arrays = {"z_quantile": (dims, rs.randn(*shape).astype(np.float32)),
            "z": (dims[1:], rs.randn(*shape[1:]).astype(np.float32)),
            "z_std": (dims[1:], rs.rand(*shape[1:]).astype(np.float32))}
  return _both(arrays, coords)


@pytest.mark.parametrize("hourly", [True, False])
@pytest.mark.parametrize("method", ["quantile", "gaussian_quantile"])
@pytest.mark.parametrize("truth_form", ["by_init", "unique_times"])
def test_thresholds_match(method, hourly, truth_form):
  jclim, pclim = _quantile_climatology(3, hourly)
  pair = _chunk(4)
  jt, pt = pair["jax"][1][["z"]], pair["port"][1][["z"]]
  if truth_form == "unique_times":
    # the compact truth of a streaming chunk: a 1-d time axis (the leap day
    # among its days)
    times = np.unique(INIT[:, None] + LEAD[None, :])
    arrays = {"z": (("time", "level", "longitude", "latitude"),
                    np.zeros((len(times), 2, 12, 7), np.float32))}
    coords = {"time": times, "level": np.array([500, 850]),
              "longitude": LON, "latitude": LAT}
    jt, pt = _both(arrays, coords)
  for q in QUANTILES:
    want = jthresholds.get_threshold_cls(method)(jclim, q).compute(jt)
    got = thresholds.get_threshold_cls(method)(pclim, q).compute(pt)
    assert_close(got, want, f"{method} {q}", exact=True)
  with pytest.raises(NotImplementedError):
    thresholds.get_threshold_cls("other")
  with pytest.raises(KeyError, match="no climatology quantile within"):
    thresholds.QuantileThreshold(pclim, 0.5).compute(pt)


# -- the metrics -----------------------------------------------------------------


def _thr(mod):
  """Thresholds that carry their quantile labels; the tests hand their
  values over as prepared datasets."""
  lib = jthresholds if mod is jmetrics else thresholds
  return [lib.QuantileThreshold(climatology=None, quantile=q)
          for q in QUANTILES]


ENSEMBLE_METRICS = [
    "CRPS", "CRPSSpread", "CRPSSkill", "SpatialCRPS", "SpatialCRPSSpread",
    "SpatialCRPSSkill", "EnsembleStddevSqrtBeforeTimeAvg", "EnsembleVariance",
    "SpatialEnsembleVariance", "EnsembleMeanRMSESqrtBeforeTimeAvg",
    "EnsembleMeanMSE", "DebiasedEnsembleMeanMSE", "SpatialEnsembleMeanMSE",
    "DebiasedSpatialEnsembleMeanMSE", "EnergyScore", "EnergyScoreSpread",
    "EnergyScoreSkill"]
THRESHOLD_METRICS = [
    "EnsembleBrierScore", "SpatialEnsembleBrierScore",
    "DebiasedEnsembleBrierScore", "SpatialDebiasedEnsembleBrierScore",
    "EnsembleIgnoranceScore", "SpatialEnsembleIgnoranceScore", "EnsembleRPS",
    "SpatialEnsembleRPS"]
GAUSSIAN_METRICS = ["GaussianCRPS", "GaussianVariance"]
GAUSSIAN_THRESHOLD_METRICS = ["GaussianBrierScore", "GaussianIgnoranceScore",
                              "GaussianRPS"]


def _metric(mod, name):
  cls = getattr(mod, name)
  if name in THRESHOLD_METRICS:
    return cls(thresholds=_thr(mod), ensemble_dim=ENS)
  if name in GAUSSIAN_THRESHOLD_METRICS:
    return cls(thresholds=_thr(mod))
  if name in GAUSSIAN_METRICS:
    return cls()
  return cls(ensemble_dim=ENS)


def _inputs(name, seed):
  gaussian = name.startswith("Gaussian")
  pair = _gaussian_chunk(seed) if gaussian else _chunk(seed)
  thr = (_threshold_datasets(seed + 7)
         if name in THRESHOLD_METRICS + GAUSSIAN_THRESHOLD_METRICS else None)
  return pair, thr


def _region_pair():
  return (jregions.SliceRegion(lat_slice=slice(-60, 60)),
          regions.SliceRegion(lat_slice=slice(-60, 60)))


@pytest.mark.parametrize("skipna", [False, True])
@pytest.mark.parametrize("name", ENSEMBLE_METRICS + THRESHOLD_METRICS
                         + GAUSSIAN_METRICS + GAUSSIAN_THRESHOLD_METRICS)
def test_compute_chunk_matches(name, skipna):
  pair, thr = _inputs(name, 10)
  jm, pm = _metric(jmetrics, name), _metric(metrics, name)
  jregion, pregion = _region_pair()
  for jr, pr in ((None, None), (jregion, pregion)):
    if thr is None:
      want = jm.compute_chunk(*pair["jax"], region=jr, skipna=skipna)
    else:
      want = jm.compute_chunk_prepared(*pair["jax"], thr["jax"], region=jr,
                                       skipna=skipna)
    for tag, inputs in (("host", pair["port"]),
                        ("tensor", _tensors(pair["port"]))):
      metrics.clear_caches()
      if thr is None:
        got = pm.compute_chunk(*inputs, region=pr, skipna=skipna)
      else:
        got = pm.compute_chunk_prepared(*inputs, thr["port"], region=pr,
                                        skipna=skipna)
      assert_close(got, want, f"{name} {tag} region={pr is not None}")
      assert got.attrs == _as_dataset(want).attrs


@pytest.mark.parametrize("num_bins", [None, 3, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_rank_histogram_counts_equal(ties, num_bins):
  pair = _chunk(20, ties=ties)
  jm = jmetrics.RankHistogram(ensemble_dim=ENS, num_bins=num_bins, seed=771)
  pm = metrics.RankHistogram(ensemble_dim=ENS, num_bins=num_bins, seed=771)
  want = jm.compute_chunk(*pair["jax"])
  for tag, inputs in (("host", pair["port"]),
                      ("tensor", _tensors(pair["port"]))):
    got = pm.compute_chunk(*inputs)
    assert_close(got, want, f"rank histogram {tag}", exact=True)
  # the draws of one chunk: a fresh generator from the seed, variables in
  # truth's order, the forecast's dims without the member dim, float32
  draws = pm.prepare_chunk(*pair["port"])
  rng = np.random.default_rng(771)
  for name in ("z", "t2m"):
    np.testing.assert_array_equal(
        draws[name].values,
        rng.uniform(size=draws[name].shape).astype(np.float32))
    assert draws[name].dims == tuple(
        d for d in pair["port"][0][name].dims if d != ENS)
  with pytest.raises(ValueError, match="Cannot bin"):
    metrics.RankHistogram(ensemble_dim=ENS, num_bins=4).compute_chunk(
        *pair["port"])


def test_rank_histogram_draws_stay_below_one(monkeypatch):
  """A float64 draw within 2**-25 of 1 is 1.0 in float32: kept, it would
  rank the truth a bin too high with no tie at all (the JAX package does)."""
  pair = _chunk(23, nans=False)

  class NearOne:
    def __init__(self, seed):
      del seed

    def uniform(self, size):
      return np.full(size, 1 - 2.0**-30)

  monkeypatch.setattr(np.random, "default_rng", NearOne)
  got = metrics.RankHistogram(ensemble_dim=ENS, seed=1).compute_chunk(
      *pair["port"])
  want = metrics.RankHistogram(ensemble_dim=ENS, break_ties_randomly=False
                               ).compute_chunk(*pair["port"])
  assert_close(got, want, "draws below one", exact=True)
  jgot = jmetrics.RankHistogram(ensemble_dim=ENS, seed=1).compute_chunk(
      *pair["jax"])
  assert not np.array_equal(jgot["z"].values, want["z"].values)


def test_ensemble_size_attribute_and_one_member():
  pair = _chunk(21)
  one = tuple(ds.isel({ENS: slice(0, 1)}) if ENS in ds.sizes else ds
              for ds in pair["port"])
  jone = tuple(ds.isel({ENS: slice(0, 1)}) if ENS in ds.sizes else ds
               for ds in pair["jax"])
  for name in ("EnsembleVariance", "EnsembleStddevSqrtBeforeTimeAvg",
               "SpatialEnsembleVariance", "EnergyScoreSpread", "CRPSSpread"):
    want = _metric(jmetrics, name).compute(*jone)
    got = _metric(metrics, name).compute(*one)
    assert_close(got, want, f"{name}, one member")
    assert got.attrs["ensemble_size"] == 1
  with pytest.raises(ValueError, match="not found"):
    metrics.CRPS(ensemble_dim="number").compute_chunk(*pair["port"])


def test_pwm_spread_sorts_nan_last():
  """The single-sort spread equals the JAX package's rank form on host
  arrays, NaN members included, in both modes."""
  pair = _chunk(22)
  for skipna in (False, True):
    want = jmetrics._pointwise_crps_spread(pair["jax"][0], ENS, skipna)
    got = metrics._pointwise_crps_spread(_tensors(pair["port"])[0], ENS,
                                         skipna)
    assert_close(got, want, f"spread skipna={skipna}")
  x = torch.tensor([[3.0, np.nan, 1.0, 2.0]])
  assert torch.isnan(x.sort(dim=-1).values[0, -1])


# -- what feeds kernel 2 ------------------------------------------------------------


POINTWISE = [n for n in THRESHOLD_METRICS + GAUSSIAN_METRICS
             + GAUSSIAN_THRESHOLD_METRICS + ENSEMBLE_METRICS
             if getattr(jmetrics, n).supports_pointwise_fused]


def test_pointwise_fused_flags_match():
  for name in (ENSEMBLE_METRICS + THRESHOLD_METRICS + GAUSSIAN_METRICS
               + GAUSSIAN_THRESHOLD_METRICS + ["RankHistogram"]):
    assert (getattr(metrics, name).supports_pointwise_fused
            == getattr(jmetrics, name).supports_pointwise_fused), name
  assert len(POINTWISE) == 12


@pytest.mark.parametrize("skipna", [False, True])
@pytest.mark.parametrize("name", POINTWISE)
def test_pointwise_fields_match(name, skipna):
  pair, thr = _inputs(name, 30)
  jm, pm = _metric(jmetrics, name), _metric(metrics, name)
  want = jm.pointwise_chunk(*pair["jax"], thr and thr["jax"], skipna)
  got = pm.pointwise_chunk(*_tensors(pair["port"]), thr and thr["port"],
                           skipna)
  assert_close(got, want, name)
  for v in got.variables_dict().values():
    assert not torch.isinf(v.data).any()  # inf never reaches the kernel
  if name == "EnsembleIgnoranceScore":
    assert any(float(v.data.sum()) > 0 for k, v in
               got.variables_dict().items() if k.endswith("__pinf"))
  means = jm.finalize_fused(want.mean(["longitude", "latitude"]), skipna)
  got_means = pm.finalize_fused(got.mean(["longitude", "latitude"]), skipna)
  assert_close(got_means, means, f"{name} finalize")


def _prob_suite(mod):
  return {
      "crps": mod.CRPS(ENS), "spread": mod.CRPSSpread(ENS),
      "skill": mod.CRPSSkill(ENS), "meansq": mod.EnsembleMeanMSE(ENS),
      "debiased": mod.DebiasedEnsembleMeanMSE(ENS),
      "var": mod.EnsembleVariance(ENS),
      "rmse": mod.EnsembleMeanRMSESqrtBeforeTimeAvg(ENS),
      "stddev": mod.EnsembleStddevSqrtBeforeTimeAvg(ENS)}


@pytest.mark.parametrize("skipna", [False, True])
def test_member_pass_and_region_means_match(skipna):
  pair = _chunk(40)
  jregs = {"global": jregions.SliceRegion(),
           "tropics": jregions.SliceRegion(lat_slice=slice(-20, 20)),
           "north": jregions.SliceRegion(lat_slice=slice(20, None))}
  pregs = convert.from_reference(jregs)
  jplan = jstreaming._build_prob_fused_plan(_prob_suite(jmetrics), jregs,
                                            pair["jax"][0], skipna)
  plans = streaming._partition_fused(_prob_suite(metrics), pregs,
                                     pair["port"][0])
  plan = plans[1]
  assert plans[0] is None and plans[2] is None and not plans[3]
  assert plan["fields"] == jplan["fields"]
  assert plan["stat_of"] == jplan["stat_of"]
  jplan["use_pallas"] = False
  plan["region_w_dev"] = torch.as_tensor(plan["region_w"])
  want = jstreaming._fused_prob_chunk_results(jplan, *pair["jax"], skipna)
  got = streaming._fused_prob_chunk_results(plan, *_tensors(pair["port"]),
                                            skipna)
  for name in want:
    w = {k: jxds.DataArray(np.asarray(v.data), dims=v.dims)
         for k, v in want[name].variables_dict().items()}
    assert_close(got[name], jxds.Dataset(w), f"plan {name}")
  # the same statistics by the generic per-metric × region path
  for name, metric in _prob_suite(metrics).items():
    for i, region in enumerate(pregs.values()):
      generic = metric.compute_chunk(*_tensors(pair["port"]), region=region,
                                     skipna=skipna)
      assert_close(got[name].isel(region=i, drop=True), generic,
                   f"plan vs generic {name}")


def test_member_fields_are_the_cell_statistics():
  """``member_fields`` on a (M, B, L) tensor, against torch's own sort,
  mean and variance."""
  f3 = torch.randn(7, 4, 30, dtype=torch.float64)
  t2 = torch.randn(4, 30, dtype=torch.float64)
  out = streaming.member_fields(
      f3, t2, ["debiased", "meansq", "skill", "spread", "var"], False)
  pairs = (f3[:, None] - f3[None]).abs().mean(dim=(0, 1)) * 7 / 6
  torch.testing.assert_close(out["spread"], pairs)
  torch.testing.assert_close(out["skill"], (f3 - t2).abs().mean(0))
  torch.testing.assert_close(out["var"], f3.var(0))
  torch.testing.assert_close(out["meansq"], (f3.mean(0) - t2) ** 2)
  torch.testing.assert_close(out["debiased"],
                             out["meansq"] - out["var"] / 7)


def test_tier_routing():
  pair = _chunk(41)
  regs = {"global": regions.SliceRegion()}

  @dataclasses.dataclass
  class MyCRPS(metrics.CRPS):
    pass

  suite = {"crps": metrics.CRPS(ENS), "mine": MyCRPS(ENS),
           "brier": metrics.EnsembleBrierScore(thresholds=_thr(metrics),
                                               ensemble_dim=ENS),
           "hist": metrics.RankHistogram(ENS),
           "spatial": metrics.SpatialCRPS(ENS), "mse": metrics.MSE()}
  det, prob, pw, rest = streaming._partition_fused(suite, regs,
                                                   pair["port"][0])
  assert det["stat_of"] == {"mse": "mse"}
  assert prob["stat_of"] == {"crps": "crps"}  # the exact type only
  assert pw["names"] == ["brier"]
  assert list(rest) == ["mine", "hist", "spatial"]
  # one member, or two member dims: the generic loop
  one = pair["port"][0].isel({ENS: slice(0, 1)})
  assert streaming._partition_fused({"crps": metrics.CRPS(ENS)}, regs,
                                    one)[1] is None
  two = {"a": metrics.CRPS(ENS), "b": metrics.CRPSSkill("number")}
  assert streaming._partition_fused(two, regs, pair["port"][0])[1] is None
  assert streaming._partition_fused(suite, {None: None},
                                    pair["port"][0])[:3] == (None,) * 3


# -- convert, central_reliability ------------------------------------------------------


def test_convert_carries_the_rank_histogram_and_thresholds():
  jclim, _ = _quantile_climatology(50)
  got = convert.from_reference(jmetrics.RankHistogram(
      ensemble_dim="number", num_bins=3, break_ties_randomly=False, seed=9))
  assert isinstance(got, metrics.RankHistogram)
  assert (got.ensemble_dim, got.num_bins, got._break_ties_randomly,
          got._seed) == ("number", 3, False, 9)
  brier = convert.from_reference(jmetrics.EnsembleBrierScore(
      thresholds=[jthresholds.QuantileThreshold(jclim, 0.25),
                  jthresholds.GaussianQuantileThreshold(jclim, 0.75)],
      ensemble_dim="number"))
  assert [type(t).__name__ for t in brier.thresholds] == [
      "QuantileThreshold", "GaussianQuantileThreshold"]
  assert isinstance(brier.thresholds[0].climatology, xds.Dataset)
  assert brier.thresholds[1].quantile == 0.75


@pytest.mark.parametrize("n_members", [4, 5])
def test_central_reliability_matches(n_members):
  pair = _chunk(60, nans=False)
  sub = tuple(ds.isel({ENS: slice(0, n_members)}) if ENS in ds.sizes else ds
              for ds in pair["jax"])
  psub = tuple(ds.isel({ENS: slice(0, n_members)}) if ENS in ds.sizes else ds
               for ds in pair["port"])
  want = jmetrics.central_reliability(
      jmetrics.RankHistogram(ENS, seed=1).compute(*sub))
  got = metrics.central_reliability(
      metrics.RankHistogram(ENS, seed=1).compute(*_tensors(psub)))
  assert_close(got, want, "central reliability")
  np.testing.assert_array_equal(
      np.asarray(got.coords_dict()["desired_prob"].data),
      np.asarray(want.coords_dict()["desired_prob"].data))
  with pytest.raises(ValueError, match="Too few bins"):
    metrics.central_reliability(got.isel(desired_prob=slice(0, 2)).rename(
        {"desired_prob": "bins"}))


# -- what the engine shares, and the Gaussian tails --------------------------------


def test_thresholds_are_computed_once_per_truth_chunk(monkeypatch):
  jclim, pclim = _quantile_climatology(70)
  threshold = thresholds.QuantileThreshold(pclim, 0.25)
  calls = []
  real = thresholds.QuantileThreshold.compute
  monkeypatch.setattr(thresholds.QuantileThreshold, "compute",
                      lambda self, t: calls.append(1) or real(self, t))
  truth = _chunk(71)["port"][1][["z"]]
  brier = metrics.EnsembleBrierScore(thresholds=[threshold], ensemble_dim=ENS)
  rps = metrics.EnsembleRPS(thresholds=[threshold], ensemble_dim=ENS)
  a = brier.prepare_chunk(None, truth)
  b = rps.prepare_chunk(None, truth)
  assert a[0] is b[0] and len(calls) == 1
  other = _chunk(72)["port"][1][["z"]]
  assert brier.prepare_chunk(None, other)[0] is not a[0]
  assert len(calls) == 2
  want = jthresholds.QuantileThreshold(jclim, 0.25).compute(
      _chunk(72)["jax"][1][["z"]])
  assert_close(threshold.compute_cached(other), want, "cached", exact=True)


def test_a_payload_shared_by_metrics_crosses_once():
  pair = _chunk(73)
  thr = [pair["port"][1]]
  prepared = {"brier": thr, "rps": list(thr), "ignorance": thr}
  counter = {}
  moved = xds.to_device((pair["port"][1], prepared), torch.device("cpu"),
                        counter=counter)
  once = sum(v.data.nbytes for v in pair["port"][1].variables_dict().values())
  assert counter["h2d_bytes"] == once
  assert moved[1]["rps"][0]["z"].data is moved[0]["z"].data


def test_gaussian_tails_stay_finite_in_float32_inputs():
  """Six sigma out the float32 cdf is 1 and its ignorance +inf; the port
  computes the cdf in float64 on tensors, as the JAX package's x64 run,
  and the upper tail as cdf(-z) (no 1 - cdf): at 6.5 sigma the JAX
  package's cancellation costs it 3e-6 of the log, within the tolerance;
  at 30 sigma its ignorance is +inf, the port's the log of 5e-198."""
  dims = ("x",)
  f = {"v": (dims, np.array([0.0, 0.0], np.float32)),
       "v_std": (dims, np.array([1.0, 1.0], np.float32))}
  t = {"v": (dims, np.array([7.0, -7.0], np.float32))}
  thr = {"v": (dims, np.array([6.5, -6.5], np.float32))}
  coords = {"x": np.arange(2)}
  jf, pf = _both(f, coords)
  jt, pt = _both(t, coords)
  jthr, pthr = _both(thr, coords)
  want = jmetrics._compute_gaussian_ignorance_score(jf, jt, jthr)
  got = metrics._compute_gaussian_ignorance_score(
      *_tensors((pf, pt)), xds.to_device(pthr, torch.device("cpu")))
  assert np.isfinite(got["v"].values).all()
  assert_close(got, want, "gaussian tails")
  assert got["v"].data.dtype == torch.float64
  far = [xds.to_device(convert.dataset_from_arrays(
      {"v": (dims, np.array([x, -x], np.float32))}, coords),
      torch.device("cpu")) for x in (31.0, 30.0)]
  # truth beyond +30 sigma above, and below -30 sigma under the forecast:
  # both observed categories have probability sf(30)
  got = metrics._compute_gaussian_ignorance_score(_tensors((pf, pt))[0],
                                                  *far)
  np.testing.assert_allclose(got["v"].values, 0.5 * 30.0**2 + np.log(
      30.0 * np.sqrt(2 * np.pi)), rtol=1e-3)  # -log(sf(30)), asymptotically


def test_a_broadcast_host_view_crosses_as_its_distinct_values():
  """Latitude weights broadcast against member-sized data: the tensor is
  an expanded view of the (lat,) values, equal to the full array."""
  from weatherbench2_torch.xds import _xp

  w = np.broadcast_to(np.linspace(0.5, 1.5, 7), (5, 3, 12, 7))
  t = _xp.TORCH.asarray(w, torch.zeros(1))
  assert t.stride() == (0, 0, 0, 1)
  np.testing.assert_array_equal(t.numpy(), w)
  pair = _chunk(74)
  got = metrics.EnergyScoreSkill(ENS).compute_chunk(*_tensors(pair["port"]))
  want = jmetrics.EnergyScoreSkill(ENS).compute_chunk(*pair["jax"])
  assert_close(got, want, "energy skill over expanded weights")


def test_merge_reindexes_quantile_sets_onto_their_union():
  """Ensemble and Gaussian thresholds in one config emit their own
  ``quantile`` labels: each metric's rows go onto the union, NaN-filled."""
  from weatherbench2_tpu import evaluation as jevaluation
  from weatherbench2_torch import evaluation

  def results(mod_xds, make):
    a = make({"v": (("metric", "quantile", "x"), np.arange(4.0).reshape(
        1, 2, 2))}, {"metric": np.array(["brier"], dtype=object),
                     "quantile": np.array([0.25, 0.75]), "x": np.arange(2)})
    b = make({"v": (("metric", "quantile", "x"), np.ones((1, 1, 2)))},
             {"metric": np.array(["gauss"], dtype=object),
              "quantile": np.array([0.5], np.float32), "x": np.arange(2)})
    return [a, b]

  want = jevaluation.merge_metric_results(results(jxds, lambda v, c: _both(
      v, c)[0]))
  got = evaluation.merge_metric_results(results(xds, lambda v, c: _both(
      v, c)[1]))
  np.testing.assert_array_equal(got.coords_dict()["quantile"].data,
                                [0.25, 0.75, 0.5])
  assert_close(got, want, "merge", exact=True)
  assert np.isnan(got["v"].values[0, 2]).all()

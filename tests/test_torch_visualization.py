"""The port's visualization layer and test helpers against the JAX package.

Counterpart of ``tests/test_visualization.py``: every function of
``weatherbench2_tpu/visualization.py`` runs in both packages on the same
results (the port's NetCDF3 and Zarr files, or datasets passed whole), and
the numbers each computes, and the lines and images each plots, must be
equal.  The plots run headless (``Agg``).  Also: a NetCDF4 results file is
refused with an error that names the format, a missing matplotlib gives an
``ImportError`` that names it while the computing functions still run, and
``config.Viz``/``Panel``, ``test_utils`` and ``utils.open_nc``/``random_like``
match their JAX counterparts.  Exact equality (float64 numpy arithmetic in
the same order in both packages) except where stated.
"""
import builtins
import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from weatherbench2_tpu import config as jconfig  # noqa: E402
from weatherbench2_tpu import schema as jschema  # noqa: E402
from weatherbench2_tpu import test_utils as jtest_utils  # noqa: E402
from weatherbench2_tpu import utils as jutils  # noqa: E402
from weatherbench2_tpu import visualization as jviz  # noqa: E402
from weatherbench2_tpu import xds as jxds  # noqa: E402
from weatherbench2_torch import config  # noqa: E402
from weatherbench2_torch import schema  # noqa: E402
from weatherbench2_torch import test_utils  # noqa: E402
from weatherbench2_torch import utils  # noqa: E402
from weatherbench2_torch import visualization  # noqa: E402
from weatherbench2_torch import xds  # noqa: E402


def _results(pkg, seed=0, ensemble=False):
  """The JAX test's results dataset, in package ``pkg``'s xds; with
  ``ensemble`` the metrics are the spread/skill pair."""
  rs = np.random.RandomState(seed)
  lead = np.arange(1, 6).astype("timedelta64[D]").astype("timedelta64[ns]")
  names = (["ensemble_stddev", "ensemble_mean_rmse"] if ensemble
           else ["rmse", "acc"])
  coords = {"metric": np.array(names, dtype=object),
            "region": np.array(["global"], dtype=object),
            "lead_time": lead, "level": np.array([500, 850])}
  return pkg.Dataset({
      "geopotential": (("metric", "region", "lead_time", "level"),
                       np.abs(rs.rand(2, 1, 5, 2)) + 0.1),
      "2m_temperature": (("metric", "region", "lead_time"),
                         np.abs(rs.rand(2, 1, 5)) + 0.1)}, coords=coords)


def _assert_same(got, want):
  assert list(got.keys()) == list(want.keys())
  for k in want.keys():
    assert got[k].dims == want[k].dims, k
    np.testing.assert_array_equal(np.asarray(got[k].values),
                                  np.asarray(want[k].values), err_msg=k)
  for name, c in want.coords_dict().items():
    np.testing.assert_array_equal(np.asarray(got.coords_dict()[name].data),
                                  np.asarray(c.data), err_msg=name)


@pytest.mark.parametrize("form", ["netcdf", "zarr", "dataset"])
def test_load_results_inserts_perfect_t0(tmp_path, form):
  """The port's results files (NetCDF3, Zarr) or a dataset passed whole:
  the perfect scores at lead 0 where a file lacks it, as the JAX package
  inserts them reading the same file."""
  ds = _results(xds)
  path = str(tmp_path / ("res.zarr" if form == "zarr" else "res.nc"))
  if form == "netcdf":
    xds.to_netcdf(ds, path)
  elif form == "zarr":
    xds.to_zarr(ds, path)
  arg = ds if form == "dataset" else path
  got = visualization.load_results({"model": arg})["model"]
  want = jviz.load_results(
      {"model": _results(jxds) if form == "dataset" else path})["model"]
  _assert_same(got, want)
  if form != "dataset":
    lead = np.asarray(got.coords_dict()["lead_time"].data)
    assert lead[0] == np.timedelta64(0, "ns")
    zero = got["geopotential"].isel(lead_time=0)
    np.testing.assert_array_equal(zero.sel(metric="rmse").values, 0.0)
    np.testing.assert_array_equal(zero.sel(metric="acc").values, 1.0)


def test_load_results_refuses_netcdf4_by_name(tmp_path):
  """What the JAX package writes by default (HDF5) is refused, never read
  as garbage."""
  path = str(tmp_path / "jax.nc")
  jxds.to_netcdf(_results(jxds), path)
  with open(path, "rb") as f:
    assert f.read(4) == b"\x89HDF"
  with pytest.raises(ValueError, match="NetCDF4/HDF5"):
    visualization.load_results({"model": path})
  with pytest.raises(ValueError, match="NetCDF4/HDF5"):
    utils.open_nc(path)


@pytest.mark.parametrize("metric", ["rmse", "acc"])
def test_compute_relative_metrics(metric):
  """Percent change against a baseline (ACC's against its distance to 1),
  NaN at lead 0, equal to the JAX package's."""
  got = visualization.compute_relative_metrics(
      {"base": _results(xds, 0), "model": _results(xds, 1)}, "base", metric)
  want = jviz.compute_relative_metrics(
      {"base": _results(jxds, 0), "model": _results(jxds, 1)}, "base",
      metric)
  assert list(got) == ["model"]
  _assert_same(got["model"], want["model"])
  a = _results(xds, 0)["2m_temperature"].sel(metric=metric).values
  b = _results(xds, 1)["2m_temperature"].sel(metric=metric).values
  base = 1 - a if metric == "acc" else a
  np.testing.assert_allclose(
      got["model"]["2m_temperature"].sel(metric=metric).values,
      (b - a) / base * 100, rtol=1e-12)


def test_compute_spread_skill_ratio():
  """Spread over skill, NaN where the lead is not positive."""
  for lead0 in (False, True):
    ds, jds = _results(xds, 2, True), _results(jxds, 2, True)
    if lead0:
      ds = visualization.load_results({"m": ds})["m"]
      jds = jviz.load_results({"m": jds})["m"]
      ds = ds.assign_coords(lead_time=np.asarray(
          ds.coords_dict()["lead_time"].data) - np.timedelta64(1, "D"))
      jds = jds.assign_coords(lead_time=np.asarray(
          jds.coords_dict()["lead_time"].data) - np.timedelta64(1, "D"))
    got = visualization.compute_spread_skill_ratio(ds["geopotential"])
    want = jviz.compute_spread_skill_ratio(jds["geopotential"])
    assert got.dims == want.dims
    np.testing.assert_array_equal(got.values, want.values)
    lead = np.asarray(got.coords["lead_time"].data)
    nan = np.isnan(got.transpose("lead_time", "region", "level").values)
    np.testing.assert_array_equal(nan.all(axis=(1, 2)),
                                  lead <= np.timedelta64(0, "ns"))
    assert nan.any() == lead0


def _lines(ax):
  return [(line.get_label(), np.asarray(line.get_xdata()),
           np.asarray(line.get_ydata())) for line in ax.lines]


def _assert_same_axes(got, want):
  assert got.get_title() == want.get_title()
  assert got.get_ylabel() == want.get_ylabel()
  assert len(got.lines) == len(want.lines)
  for (gl, gx, gy), (wl, wx, wy) in zip(_lines(got), _lines(want)):
    assert gl == wl
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("metric,relative,n_lines", [
    ("rmse", None, 2), ("rmse", "a", 1), ("spread&skill", None, 4),
    ("spread/skill", None, 4)])
def test_plot_timeseries_and_panels(tmp_path, metric, relative, n_lines):
  """One panel of each kind in both packages: the same lines (a dashed
  spread beside each skill; the ratio's line at 1 once per result), title
  and label; then the grid of panels, saved, as the JAX test does."""
  ensemble = "skill" in metric
  results = {"a": _results(xds, 0, ensemble), "b": _results(xds, 1, ensemble)}
  jresults = {"a": _results(jxds, 0, ensemble),
              "b": _results(jxds, 1, ensemble)}
  kw = dict(metric=metric, variable="geopotential", level=500,
            region="global", relative=relative)
  got = visualization.plot_timeseries(results, **kw)
  want = jviz.plot_timeseries(jresults, **kw)
  _assert_same_axes(got, want)
  assert len(got.lines) == n_lines
  plt.close("all")

  viz = config.Viz(results=results,
                   save_kwargs={"fname": str(tmp_path / "panels.png")})
  jviz_config = jconfig.Viz(results=jresults)
  panels = [config.Panel(metric="rmse", variable="geopotential", level=500,
                         region="global"),
            config.Panel(metric="acc", variable="2m_temperature",
                         region="global", relative="a")]
  jpanels = [jconfig.Panel(**vars(p)) for p in panels]
  if ensemble:
    panels, jpanels = panels[:1], jpanels[:1]
    panels[0].metric = jpanels[0].metric = metric
  fig = visualization.visualize_timeseries(viz, panels)
  jfig = jviz.visualize_timeseries(jviz_config, jpanels)
  assert (tmp_path / "panels.png").exists()
  for g, w in zip(fig.axes, jfig.axes):
    _assert_same_axes(g, w)
  plt.close("all")


def test_visualize_scorecard(tmp_path):
  """The scorecard's matrix, rows and saved image, as the JAX package's."""
  def card(pkg, viz_pkg, cfg_pkg, fname):
    viz = cfg_pkg.Viz(results={"base": _results(pkg, 0),
                               "model": _results(pkg, 1)},
                      save_kwargs={"fname": str(tmp_path / fname)})
    return viz_pkg.visualize_scorecard(
        viz, baseline="base", forecast="model", metric="rmse",
        variables=["geopotential", "2m_temperature"], region="global")

  fig = card(xds, visualization, config, "scorecard.png")
  jfig = card(jxds, jviz, jconfig, "jax_scorecard.png")
  assert (tmp_path / "scorecard.png").exists()
  got, want = fig.axes[0], jfig.axes[0]
  np.testing.assert_array_equal(got.images[0].get_array(),
                                want.images[0].get_array())
  assert ([t.get_text() for t in got.get_yticklabels()]
          == [t.get_text() for t in want.get_yticklabels()]
          == ["Z500", "Z850", "T2M"])
  plt.close("all")


def test_plotting_without_matplotlib_names_it(monkeypatch):
  """Without matplotlib (the card's machine) each plotting function raises
  an ImportError naming it; the computing functions run."""
  real_import = builtins.__import__

  def no_matplotlib(name, *args, **kwargs):
    if name.split(".")[0] == "matplotlib":
      raise ImportError(f"No module named {name!r}")
    return real_import(name, *args, **kwargs)

  monkeypatch.setattr(builtins, "__import__", no_matplotlib)
  results = {"a": _results(xds, 0), "b": _results(xds, 1)}
  viz = config.Viz(results=results)
  calls = [
      visualization.set_wb2_style,
      lambda: visualization.plot_timeseries(results, "rmse", "geopotential"),
      lambda: visualization.visualize_timeseries(
          viz, [config.Panel(metric="rmse", variable="geopotential")]),
      lambda: visualization.visualize_scorecard(
          viz, "a", "b", "rmse", ["geopotential"])]
  for call in calls:
    with pytest.raises(ImportError, match="need matplotlib"):
      call()
  rel = visualization.compute_relative_metrics(results, "a", "rmse")
  assert np.isfinite(rel["b"]["geopotential"].values).all()


def test_viz_and_panel_configs_have_the_jax_fields():
  for port_cls, jax_cls in ((config.Viz, jconfig.Viz),
                            (config.Panel, jconfig.Panel)):
    got = {f.name: f.default for f in port_cls.__dataclass_fields__.values()}
    want = {f.name: f.default for f in jax_cls.__dataclass_fields__.values()}
    assert got == want
  assert config.Viz(results={}).save_kwargs == {}


def test_test_utils_match_the_jax_package():
  """insert_nan draws the same cells from the same seed (float32 kept);
  the asserts accept and refuse the same arrays, numpy or tensor."""
  import torch

  kw = dict(variables_3d=["geopotential"], variables_2d=["2m_temperature"],
            time_start="2020-01-01", time_stop="2020-01-03",
            spatial_resolution_in_degrees=30.0)
  ds = utils.random_like(schema.mock_truth_data(**kw), seed=3)
  jds = jutils.random_like(jschema.mock_truth_data(**kw), seed=3)
  ds = ds.copy(data={k: np.asarray(v.data, np.float32)
                     for k, v in ds.variables_dict().items()})
  jds = jds.copy(data={k: np.asarray(v.data, np.float32)
                       for k, v in jds.variables_dict().items()})
  for seed in (802701, 5):
    got = test_utils.insert_nan(ds, frac_nan=0.3, seed=seed)
    want = jtest_utils.insert_nan(jds, frac_nan=0.3, seed=seed)
    for k in want.keys():
      assert got[k].values.dtype == np.float32
      np.testing.assert_array_equal(got[k].values, want[k].values)
  up = np.arange(4.0)
  for x in (up, torch.as_tensor(up), xds.DataArray(up, dims=("x",))):
    test_utils.assert_strictly_increasing(x)
    test_utils.assert_positive(x + 1)
    test_utils.assert_negative(-x - 1)
    test_utils.assert_strictly_decreasing(-x)
    for check, arg in ((test_utils.assert_strictly_decreasing, x),
                       (test_utils.assert_positive, x),
                       (test_utils.assert_negative, x),
                       (test_utils.assert_strictly_increasing, -x)):
      with pytest.raises(AssertionError):
        check(arg)


def test_open_nc_and_random_like_match_the_jax_package(tmp_path):
  kw = dict(variables_3d=["geopotential"], variables_2d=["2m_temperature"],
            time_start="2020-01-01", time_stop="2020-01-02",
            spatial_resolution_in_degrees=30.0)
  got = utils.random_like(schema.mock_truth_data(**kw), seed=7)
  want = jutils.random_like(jschema.mock_truth_data(**kw), seed=7)
  for k in want.keys():
    assert got[k].values.dtype == np.float64
    np.testing.assert_array_equal(got[k].values, want[k].values)
  path = str(tmp_path / "r.nc")
  xds.to_netcdf(got, path)
  back = utils.open_nc(path)
  jback = jutils.open_nc(path)
  for k in want.keys():
    np.testing.assert_array_equal(back[k].values, jback[k].values)
  assert os.path.getsize(path) > 0

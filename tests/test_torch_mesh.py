"""Multi-rank evaluation of the port over ``torch.distributed``, on the CPU.

Each multi-rank test spawns one gloo world (``parallel.mesh.run_ranks``:
spawned processes that meet on a file store in a temporary directory, so
workers that run tests side by side never share a port; every world has a
timeout, so a hung rank fails its test).  Several cases run inside one
world.  The ranks write results as a single-device run does (rank 0 only);
the JAX package runs the same stores over its ``make_mesh`` meshes of the
tests' 8 virtual CPU devices (``tests/conftest.py``), as
``tests/test_evaluation.py::test_streaming_with_mesh_matches_unsharded``
does, and the port's results are held to them within ``rtol=1e-5`` plus
``atol=1e-5 x max|reference|`` per variable (float32 sums on the port's
side, float64 under the tests' x64 on the JAX side, in another order).

Here: the mesh itself, and W = 2 and 4 batch worlds (MSE, Bias and ACC
with regions and a ``Spatial*`` metric; per-time results; the
probabilistic plan).  ``tests/test_torch_mesh_spatial.py`` holds the
batch x spatial world, ``tests/test_torch_mesh_resume.py`` kill and resume
across world sizes and ``tests/test_torch_mesh_cli.py`` the CLI's
``--n_devices``.
"""
import os
import time

import pytest
import torch
import torch.distributed as dist

from tests.test_torch_official_configs import assert_results_close
from weatherbench2_tpu import config as jconfig
from weatherbench2_tpu import evaluation as jevaluation
from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import utils as jutils
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.parallel import make_mesh as jmake_mesh
from weatherbench2_tpu.regions import ExtraTropicalRegion, SliceRegion
from weatherbench2_torch import convert
from weatherbench2_torch import evaluation
from weatherbench2_torch.parallel import mesh as mesh_lib

# seconds a spawned world may take (imports of torch, JAX and the package
# in every rank included) before its test fails
WORLD_TIMEOUT = 240
CHUNK = 3  # inits: rounded up to 4 on meshes of 2 and 4, as in JAX
CASES = ("det", "per_time", "prob")


def build_stores(tmp, resolution=20.0):
  """Uncompressed stores: 10 daily inits x 3 leads of z at two levels and
  t2m, a 4-member ensemble, daily truth, a 6-hourly climatology; at 20
  degrees 18 x 10 cells (the latitudes split in two bands), at 30 degrees
  12 x 7 (they do not)."""
  kw = dict(variables_3d=["geopotential"], variables_2d=["2m_temperature"],
            levels=(500, 850), time_start="2020-01-01",
            spatial_resolution_in_degrees=resolution)
  data = {
      "truth": jschema.mock_truth_data(time_stop="2020-01-15", **kw),
      "forecast": jschema.mock_forecast_data(lead_stop="2 days",
                                             time_stop="2020-01-11", **kw),
      "ensemble": jschema.mock_forecast_data(lead_stop="2 days",
                                             time_stop="2020-01-11",
                                             ensemble_size=4, **kw),
      "climatology": jschema.mock_hourly_climatology_data(
          variables_3d=["geopotential"], variables_2d=["2m_temperature"],
          levels=(500, 850), spatial_resolution_in_degrees=resolution,
          hour_interval=6)}
  paths = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    for seed, (name, ds) in enumerate(data.items()):
      paths[name] = os.path.join(str(tmp), f"{name}.zarr")
      jxds.to_zarr(jutils.random_like(ds, seed=seed), paths[name])
  return paths


def jax_configs(paths, case):
  """The reference package's configs of a case."""
  regions = {"global": SliceRegion(),
             "tropics": SliceRegion(lat_slice=slice(-20, 20)),
             "extra-tropics": ExtraTropicalRegion()}
  if case == "prob":
    return {"prob": jconfig.Eval(
        metrics={"crps": jmetrics.CRPS(),
                 "ensemble_mean_mse": jmetrics.EnsembleMeanMSE(),
                 "ensemble_variance": jmetrics.EnsembleVariance()},
        regions=regions)}
  if case == "per_time":
    return {"per_time": jconfig.Eval(
        metrics={"mse": jmetrics.MSE(), "bias": jmetrics.Bias()},
        regions=regions, temporal_mean=False)}
  clim = jxds.open_zarr(paths["climatology"])
  return {"det": jconfig.Eval(
      metrics={"mse": jmetrics.MSE(), "bias": jmetrics.Bias(),
               "acc": jmetrics.ACC(climatology=clim),
               "spatial_mse": jmetrics.SpatialMSE()},
      regions=regions)}


def jax_data_config(paths, case, out_dir, stop="2020-01-10"):
  return jconfig.Data(
      selection=jconfig.Selection(
          variables=["geopotential", "2m_temperature"], levels=[500, 850],
          time_slice=slice("2020-01-01", stop)),
      paths=jconfig.Paths(
          forecast=paths["ensemble" if case == "prob" else "forecast"],
          obs=paths["truth"], climatology=paths["climatology"],
          output_dir=str(out_dir)),
      by_init=True)


def run_cases(paths, root, cases, axis_names=("batch",), axis_sizes=None,
              **kw):
  """In every rank: a mesh over the world, then each case through
  ``evaluate_with_mesh``; rank 0 returns {case: counts} and every rank's
  view of the mesh."""
  world = dist.get_world_size()
  mesh = mesh_lib.make_mesh(axis_names=axis_names, devices=["cpu"] * world,
                            axis_sizes=axis_sizes)
  view = {"axis_sizes": mesh.axis_sizes, "device": str(mesh.device),
          "coordinates": {a: mesh.coordinate(a) for a in mesh.axis_names},
          "group_ranks": {a: dist.get_process_group_ranks(mesh.group(a))
                          for a in mesh.axis_names}}
  views = [None] * world
  dist.all_gather_object(views, view)
  out = {"views": views}
  for case in cases:
    out[case] = evaluation.evaluate_with_mesh(
        convert.from_reference(jax_data_config(
            paths, case, os.path.join(root, case))),
        convert.eval_configs_from_reference(jax_configs(paths, case)),
        input_chunks={"init_time": CHUNK}, mesh=mesh, **kw)
  return out


def run_jax(paths, root, case, mesh):
  jevaluation.evaluate_with_mesh(
      jax_data_config(paths, case, root), jax_configs(paths, case),
      input_chunks={"init_time": CHUNK}, mesh=mesh)
  return open_results(root, case)


def open_results(root, case):
  """A case's results: its one config is named as the case."""
  return {case: jxds.open_netcdf(os.path.join(str(root), f"{case}.nc"))}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_mesh")
  return tmp, build_stores(tmp)


@pytest.fixture(scope="module")
def batch_worlds(stores):
  """W = 2 and 4 batch worlds, every case in each; the JAX package over
  meshes of 2 and 4 devices."""
  tmp, paths = stores
  out = {}
  for w in (2, 4):
    root = str(tmp / f"w{w}")
    out[w] = mesh_lib.run_ranks(run_cases, w, devices=["cpu"] * w,
                                args=(paths, root, CASES),
                                timeout=WORLD_TIMEOUT)
    mesh = jmake_mesh(n_devices=w)
    for case in CASES:
      out[(w, case)] = (open_results(os.path.join(root, case), case),
                        run_jax(paths, tmp / f"jax_w{w}_{case}", case, mesh))
  return out


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_batch_world_matches_the_jax_mesh(batch_worlds, w, case):
  got, want = batch_worlds[(w, case)]
  for name in want:
    assert_results_close(got[name], want[name], f"W={w} {case}/{name}")


@pytest.mark.parametrize("w", [2, 4])
def test_batch_world_counts(batch_worlds, w):
  """Every rank reads and moves its share of every chunk: 3 chunks of 4
  inits (10 of them), each rank's rows of each, about 1/W of the bytes."""
  stats = batch_worlds[w]["det"]
  assert stats["chunks"] == 3
  assert len(stats["ranks"]) == w
  assert stats["h2d_bytes"] == sum(r["h2d_bytes"] for r in stats["ranks"])
  assert stats["read_bytes"] == sum(r["read_bytes"] for r in stats["ranks"])
  assert stats["wait_host_s"] == max(r["wait_host_s"]
                                     for r in stats["ranks"])
  moved = [r["h2d_bytes"] for r in stats["ranks"]]
  assert max(moved) == min(moved) > 0  # padded rows are moved too
  assert all(r["gathered_bytes"] == 0 for r in stats["ranks"])


@pytest.mark.parametrize("w", [2, 4])
def test_mesh_views(batch_worlds, w):
  views = batch_worlds[w]["views"]
  for rank, view in enumerate(views):
    assert view == {"axis_sizes": {"batch": w}, "device": "cpu",
                    "coordinates": {"batch": rank},
                    "group_ranks": {"batch": list(range(w))}}


@pytest.mark.parametrize("total", [1, 2, 4, 6, 8])
def test_2d_mesh_axis_sizes(total):
  """The default split of a 2-D mesh is the JAX package's
  (``tests/test_spatial_sharding.py::test_2d_mesh_axis_sizes``)."""
  jmesh = jmake_mesh(n_devices=total, axis_names=("batch", "spatial"))
  assert mesh_lib.split_axis_sizes(total, 2) == list(jmesh.devices.shape)
  assert mesh_lib.split_axis_sizes(total, 1) == [total]
  assert mesh_lib.split_axis_sizes(8, 3) == [2, 1, 4]


def test_backend_and_devices():
  """NCCL only where every rank has its own card; no fallback to the CPU
  when cards are missing; a mesh needs a world."""
  assert mesh_lib.backend_for(["cuda:0", "cuda:1"]) == "nccl"
  assert mesh_lib.backend_for(["cuda:0", "cuda:0"]) == "gloo"
  assert mesh_lib.backend_for(["cpu", "cpu"]) == "gloo"
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices, "
                       "but 0 are available"):
      mesh_lib.default_devices(2)
  assert not dist.is_initialized()
  with pytest.raises(RuntimeError, match="initialised torch.distributed"):
    mesh_lib.make_mesh(2, devices=["cpu", "cpu"])


def _fail_on_rank_1():
  if dist.get_rank() == 1:
    raise KeyError("rank 1 fails")
  dist.barrier()  # rank 0 waits here until the world is torn down


def _hang():
  time.sleep(600)


def test_a_world_past_its_timeout_is_ended():
  t0 = time.monotonic()
  with pytest.raises(TimeoutError, match="still ran after 3 s"):
    mesh_lib.run_ranks(_hang, 2, devices=["cpu", "cpu"], timeout=3)
  assert time.monotonic() - t0 < WORLD_TIMEOUT


def test_a_failed_rank_ends_the_world_with_its_traceback():
  with pytest.raises(RuntimeError, match="rank 1 fails"):
    mesh_lib.run_ranks(_fail_on_rank_1, 2, devices=["cpu", "cpu"],
                       timeout=WORLD_TIMEOUT)

"""A batch x spatial world of the port (2 x 2 gloo ranks on the CPU).

Each spatial rank reads its latitude band; the region kernels' band sums
add over the spatial axis before any division; whole fields are gathered
for what is neither a per-cell map nor a cell sum (a ``Spatial*`` metric,
a metric that runs on the host, a derived variable that differentiates
over latitude).  Held to the JAX package's 2-D mesh of 2 x 2 devices
(``tests/test_spatial_sharding.py`` is the pattern) where the JAX streaming
engine runs the same configs, and to the port's one-device run where it
cannot (host metrics and lazily read derived variables: ROADMAP C), within
``rtol=1e-5`` plus ``atol=1e-5 x max|reference|`` per variable.  A
latitude count that the spatial axis does not divide is refused, in both
packages, with the same message.
"""
import dataclasses
import os

import pytest
import torch.distributed as dist

from tests.test_torch_mesh import (CHUNK, WORLD_TIMEOUT, build_stores,
                                   jax_configs, jax_data_config,
                                   open_results, run_cases, run_jax)
from tests.test_torch_official_configs import assert_results_close
from weatherbench2_tpu.parallel import make_mesh as jmake_mesh
from weatherbench2_torch import config
from weatherbench2_torch import convert
from weatherbench2_torch import evaluation
from weatherbench2_torch import metrics
from weatherbench2_torch.derived_variables import DERIVED_VARIABLE_DICT
from weatherbench2_torch.parallel import mesh as mesh_lib
from weatherbench2_torch.regions import ExtraTropicalRegion, SliceRegion

AXES = ("batch", "spatial")
CASES = ("det", "per_time", "prob")
GEOSTROPHIC = "u_component_of_geostrophic_wind"


@dataclasses.dataclass
class HostMSE(metrics.MSE):
  """MSE on the host's numpy chunks (``supports_jit = False``)."""

  supports_jit = False


def _port_only_configs():
  """A host metric beside kernel metrics, and a derived variable that
  differentiates over latitude (infinite at the poles of this grid)."""
  regions = {"global": SliceRegion(),
             "extra-tropics": ExtraTropicalRegion()}
  return {
      "host": config.Eval(metrics={"host_mse": HostMSE(),
                                   "mse": metrics.MSE()}, regions=regions),
      "derived": config.Eval(
          metrics={"mse": metrics.MSE(), "bias": metrics.Bias()},
          regions=regions,
          derived_variables={GEOSTROPHIC: DERIVED_VARIABLE_DICT[GEOSTROPHIC]}),
  }


def _port_only(paths, root, mesh=None):
  dc = convert.from_reference(jax_data_config(paths, "det", root))
  return evaluation.evaluate_with_mesh(
      dc, _port_only_configs(), input_chunks={"init_time": CHUNK},
      mesh=mesh, device=None if mesh else "cpu")


def _spatial_world(paths, indivisible_paths, root):
  """In every rank of the 2 x 2 world: the cases, the port-only configs,
  and the refusal of 7 latitudes."""
  out = run_cases(paths, os.path.join(root, "cases"), CASES, AXES, [2, 2])
  mesh = mesh_lib.make_mesh(axis_names=AXES, devices=["cpu"] * 4,
                            axis_sizes=[2, 2])
  out["port_only"] = _port_only(paths, os.path.join(root, "port_only"), mesh)
  with pytest.raises(ValueError) as refused:
    evaluation.evaluate_with_mesh(
        convert.from_reference(jax_data_config(
            indivisible_paths, "det", os.path.join(root, "refused"))),
        convert.eval_configs_from_reference(
            jax_configs(indivisible_paths, "det")),
        input_chunks={"init_time": CHUNK}, mesh=mesh)
  out["refusal"] = str(refused.value)
  dist.barrier()
  return out


@pytest.fixture(scope="module")
def spatial_world(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_mesh_spatial")
  paths = build_stores(tmp / "grid20")
  odd = build_stores(tmp / "grid30", resolution=30.0)
  root = str(tmp / "world")
  out = mesh_lib.run_ranks(_spatial_world, 4, devices=["cpu"] * 4,
                           args=(paths, odd, root), timeout=WORLD_TIMEOUT)
  jmesh = jmake_mesh(n_devices=4, axis_names=AXES, axis_sizes=[2, 2])
  for case in CASES:
    out[("results", case)] = (
        open_results(os.path.join(root, "cases", case), case),
        run_jax(paths, tmp / f"jax_{case}", case, jmesh))
  with pytest.raises(ValueError) as refused:
    run_jax(odd, tmp / "jax_refused", "det", jmesh)
  out["jax_refusal"] = str(refused.value)
  one = tmp / "one_device"
  _port_only(paths, str(one))
  out["port_only_results"] = {
      name: (open_results(os.path.join(root, "port_only"), name)[name],
             open_results(one, name)[name])
      for name in _port_only_configs()}
  return out


@pytest.mark.parametrize("case", CASES)
def test_spatial_world_matches_the_jax_2d_mesh(spatial_world, case):
  got, want = spatial_world[("results", case)]
  assert_results_close(got[case], want[case], f"2 x 2 {case}")


@pytest.mark.parametrize("name", ["host", "derived"])
def test_spatial_world_matches_one_device(spatial_world, name):
  got, want = spatial_world["port_only_results"][name]
  assert_results_close(got, want, f"2 x 2 {name}")


def test_spatial_world_ranks_and_gathered_bytes(spatial_world):
  """The ranks of the 2 x 2 mesh, and the bytes they gather: for the
  Spatial* metric of ``det``, none for the probabilistic plan (the kernel
  tiers add band sums)."""
  stats = spatial_world["det"]
  ranks = spatial_world["views"]
  assert [v["coordinates"] for v in ranks] == [
      {"batch": b, "spatial": s} for b in (0, 1) for s in (0, 1)]
  assert [v["group_ranks"] for v in ranks[:2]] == [
      {"batch": [0, 2], "spatial": [0, 1]},
      {"batch": [1, 3], "spatial": [0, 1]}]
  assert len(stats["ranks"]) == 4
  assert all(r["gathered_bytes"] > 0 for r in stats["ranks"])
  assert all(r["gathered_bytes"] == 0
             for r in spatial_world["prob"]["ranks"])


def test_indivisible_latitude_is_refused_as_in_jax(spatial_world):
  assert "does not divide the latitude size 7" in spatial_world["refusal"]
  assert spatial_world["refusal"] == spatial_world["jax_refusal"]

"""Kill and resume across world sizes, on gloo worlds of the CPU.

A W = 2 gloo world on the CPU streams ``det`` of ``tests/test_torch_mesh.py``
(MSE, Bias, ACC with three regions and the per-cell ``SpatialMSE``) in
chunks of 2 inits with a state file after every chunk; rank 0 dies right
after the second state is in place (``os._exit``, no clean-up), which ends
the world.  The state is the batch sums of the first two chunks, saved by
rank 0 in the one-device format.  Resumed by a W = 2 world it must give the
uninterrupted W = 2 run's results bit for bit (each chunk's sums are added
over the ranks before they join the accumulators, so the accumulators are
formed in the same order); resumed by a world of one, whose chunk sums are
formed in another order, the same within ``rtol=1e-5`` plus
``atol=1e-5 x max|reference|`` per variable.
"""
import os
import shutil

import numpy as np
import pytest
import torch.distributed as dist

from tests.test_torch_mesh import (WORLD_TIMEOUT, build_stores, jax_configs,
                                   jax_data_config)
from weatherbench2_torch import convert
from weatherbench2_torch import evaluation
from weatherbench2_torch import xds
from weatherbench2_torch.parallel import mesh as mesh_lib
from weatherbench2_torch.parallel import streaming

CHUNKS = {"init_time": 2}


def _run_det(paths, out_dir, cpath=None):
  world = dist.get_world_size()
  mesh = mesh_lib.make_mesh(devices=["cpu"] * world)
  return evaluation.evaluate_with_mesh(
      convert.from_reference(jax_data_config(paths, "det", out_dir)),
      convert.eval_configs_from_reference(jax_configs(paths, "det")),
      input_chunks=CHUNKS, mesh=mesh, checkpoint_path=cpath,
      checkpoint_every=1 if cpath else 0)


def _killed_after_two_states(paths, out_dir, cpath):
  if dist.get_rank() == 0:
    real, states = os.replace, []

    def replace(src, dst):
      real(src, dst)
      if dst == cpath + ".det":
        states.append(dst)
        if len(states) == 2:
          os._exit(9)  # the process dies here, with no clean-up at all

    streaming.os.replace = replace
  _run_det(paths, out_dir, cpath)


def _whole_then_resumed(paths, root, cpath):
  return (_run_det(paths, os.path.join(root, "whole")),
          _run_det(paths, os.path.join(root, "resumed2"), cpath))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_mesh_resume")
  paths = build_stores(tmp)
  cpath = str(tmp / "state")
  with pytest.raises(RuntimeError, match="rank 0: exit code 9"):
    mesh_lib.run_ranks(_killed_after_two_states, 2, devices=["cpu"] * 2,
                       args=(paths, str(tmp / "killed"), cpath),
                       timeout=WORLD_TIMEOUT)
  state = streaming.StreamingState.load(cpath + ".det")
  shutil.copy(cpath + ".det", str(tmp / "state1.det"))
  whole, resumed2 = mesh_lib.run_ranks(
      _whole_then_resumed, 2, devices=["cpu"] * 2,
      args=(paths, str(tmp), cpath), timeout=WORLD_TIMEOUT)
  resumed1 = mesh_lib.run_ranks(
      _run_det, 1, devices=["cpu"],
      args=(paths, str(tmp / "resumed1"), str(tmp / "state1")),
      timeout=WORLD_TIMEOUT)
  return {"tmp": tmp, "state": state, "killed_wrote": os.path.exists(
      tmp / "killed" / "det.nc"), "whole": whole, "resumed2": resumed2,
          "resumed1": resumed1}


def test_the_killed_world_left_the_state_of_two_chunks(runs):
  state = runs["state"]
  assert not runs["killed_wrote"]
  assert (state.chunk_index, state.chunk_size, state.total) == (2, 2, 10)
  assert set(state.configs) == {"det"}
  assert state.sums is not None  # the version-1 fields of one config


@pytest.mark.parametrize("world", [1, 2])
def test_resumed_world_equals_the_uninterrupted_one(runs, world):
  tmp = runs["tmp"]
  assert runs["whole"]["chunks"] == 5
  assert runs[f"resumed{world}"]["chunks"] == 3
  got = xds.open_netcdf(str(tmp / f"resumed{world}" / "det.nc"))
  want = xds.open_netcdf(str(tmp / "whole" / "det.nc"))
  assert list(got.keys()) == list(want.keys())
  for k in want.keys():
    g, w = got[k].values, want[k].values
    if world == 2:
      np.testing.assert_array_equal(g, w, err_msg=k)
    else:
      np.testing.assert_allclose(g, w, rtol=1e-5,
                                 atol=1e-5 * np.nanmax(np.abs(w)), err_msg=k)

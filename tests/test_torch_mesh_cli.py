"""The CLI's ``--n_devices`` on gloo worlds of the CPU.

``--use_mesh --n_devices=2 --device=cpu`` through ``cli.evaluate.main``
runs two ranks, spawned by the CLI or joined as ``torchrun`` starts them
(``WORLD_SIZE`` and ``RANK`` in the environment), and returns rank 0's
counts.  The spawned world's results are held to ``scripts/evaluate.py``
with ``--n_devices=2`` (a JAX mesh of 2 of the 8 virtual CPU devices) on
the stores of ``tests/test_torch_cli.py``, on the reference's regions,
within ``rtol=1e-5`` plus ``atol=1e-5 x max|reference|`` per variable; the
torchrun world's to the spawned one's, bit for bit.
"""
import multiprocessing
import os
import pickle
import socket

import numpy as np
import pytest
from absl.testing import flagsaver

from tests.test_torch_cli import (_common_regions, _port_args,
                                  _reference_flags, build_stores as cli_stores,
                                  reference_cli)
from tests.test_torch_mesh import WORLD_TIMEOUT
from tests.test_torch_official_configs import (assert_results_close,
                                               open_result)
from weatherbench2_torch.cli import evaluate as cli


def _as_torchrun_rank(rank, port, argv, out):
  """A process as ``torchrun`` starts it: the world in the environment."""
  os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                    LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
  stats = cli.main(argv)
  with open(f"{out}.rank{rank}", "wb") as f:
    pickle.dump(stats, f)


def test_cli_n_devices_joins_a_torchrun_world(tmp_path):
  """Under ``torchrun`` (``WORLD_SIZE`` and ``RANK`` in the environment)
  the CLI joins the world as its rank instead of spawning one, and gives
  the spawned world's results bit for bit; a world of another size is
  refused by name."""
  paths = cli_stores(str(tmp_path))
  argv = lambda out, n: _port_args(  # noqa: E731
      paths, tmp_path / out, "--eval_configs=deterministic", "--regions=all",
      "--input_chunks=init_time=4", "--use_mesh", f"--n_devices={n}")
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
  ctx = multiprocessing.get_context("spawn")
  procs = [ctx.Process(target=_as_torchrun_rank,
                       args=(r, port, argv("torchrun", 2),
                             str(tmp_path / "stats")))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(WORLD_TIMEOUT)
  for p in procs:
    if p.is_alive():
      p.kill()
  assert [p.exitcode for p in procs] == [0, 0]
  with open(tmp_path / "stats.rank0", "rb") as f:
    stats = pickle.load(f)
  assert stats["chunks"] == 4 and len(stats["ranks"]) == 2
  spawned = cli.main(argv("spawned", 2))
  assert spawned["h2d_bytes"] == stats["h2d_bytes"]
  got = open_result(tmp_path / "torchrun", "deterministic")
  want = open_result(tmp_path / "spawned", "deterministic")
  for k in want.keys():
    np.testing.assert_array_equal(got[k].values, want[k].values, err_msg=k)
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="--n_devices=2, but this world "
                       "has 3 ranks"):
      cli.main(argv("refused", 2))


def test_cli_n_devices_on_the_cpu_matches_the_reference_cli(tmp_path):
  paths = cli_stores(str(tmp_path))
  more = dict(eval_configs="deterministic", regions=["all"],
              compute_seeps=True, use_mesh=True,
              input_chunks={"init_time": 4})
  with flagsaver.flagsaver(**_reference_flags(paths, tmp_path / "ref",
                                              n_devices=2, **more)):
    reference_cli.main([])
  stats = cli.main(_port_args(
      paths, tmp_path / "port", "--eval_configs=deterministic",
      "--regions=all", "--compute_seeps", "--input_chunks=init_time=4",
      "--use_mesh", "--n_devices=2"))
  assert stats["chunks"] == 4 and len(stats["ranks"]) == 2
  assert all(r["h2d_bytes"] > 0 for r in stats["ranks"])
  want = open_result(tmp_path / "ref", "deterministic")
  # the reference finds no land-sea mask here (ROADMAP C): its 13 regions
  assert_results_close(
      _common_regions(open_result(tmp_path / "port", "deterministic"), want),
      want, "--n_devices=2")


@pytest.mark.parametrize("env, flag, message", [
    ({}, "--device=cuda:1", "--device=cuda:1 with --n_devices"),
    ({"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "1", "RANK": "1"},
     "--device=cpu", "this world of 2 ranks spans hosts"),
])
def test_cli_n_devices_refuses_one_named_card_and_worlds_across_hosts(
    tmp_path, monkeypatch, env, flag, message):
  """A single card named with ``--n_devices`` is refused instead of being
  replaced by ``cuda:r``, and so is a ``torchrun`` world over several hosts
  (the ranks would look for cards by their global rank), before any rank
  joins a world."""
  for k, v in env.items():
    monkeypatch.setenv(k, v)
  with pytest.raises(ValueError, match=message):
    cli.main([f"--forecast_path={tmp_path}/f.zarr",
              f"--obs_path={tmp_path}/o.zarr",
              f"--output_dir={tmp_path}/out", "--use_mesh", "--n_devices=2",
              flag])

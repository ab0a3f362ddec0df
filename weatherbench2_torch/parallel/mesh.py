"""Meshes of ranks over ``torch.distributed``.

Counterpart of ``weatherbench2_tpu/parallel/mesh.py``.  The JAX package
runs one program over a ``jax.sharding.Mesh`` of devices; the port runs one
process per rank, PyTorch's idiom for the same data parallelism:

  * a 1-D ``("batch",)`` mesh gives each rank its share of the rows of
    every (init_)time chunk; the (sum, count) accumulators are time sums,
    so they add across ranks;
  * a 2-D ``("batch", "spatial")`` mesh also gives each rank of the
    ``spatial`` axis a latitude band; the region kernels' band sums add
    across that axis.

A mesh wraps ``torch.distributed.device_mesh.DeviceMesh`` (one process
group per axis) with the ``torch.device`` of this rank: rank r runs on
``cuda:r`` unless the caller names the devices.  Each rank on its own card
talks over NCCL; ranks on the CPU, or several ranks on one card (which NCCL
refuses), talk over gloo.  ``run_ranks`` starts a world of spawned
processes on one host; ``init_world`` joins one that a launcher such as
``torchrun`` started.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

BATCH = "batch"
SPATIAL = "spatial"


@dataclasses.dataclass(frozen=True)
class Mesh:
  """This rank's view of a mesh of ranks: the axes, its coordinates, its
  device and the process group of each axis."""

  device_mesh: Any  # torch.distributed.device_mesh.DeviceMesh
  device: torch.device

  @property
  def axis_names(self) -> tuple:
    return tuple(self.device_mesh.mesh_dim_names)

  @property
  def axis_sizes(self) -> dict:
    """{axis: size}, as ``dict(zip(mesh.axis_names, mesh.devices.shape))``
    of a jax mesh."""
    return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

  @property
  def rank(self) -> int:
    return dist.get_rank()

  def size(self, axis: str) -> int:
    """The size of ``axis``; 1 for an axis the mesh does not have."""
    return self.axis_sizes.get(axis, 1)

  def coordinate(self, axis: str) -> int:
    """This rank's position along ``axis``; 0 for an axis the mesh does not
    have."""
    if axis not in self.axis_names:
      return 0
    return self.device_mesh.get_local_rank(axis)

  def group(self, axis: str):
    """The process group of the ranks that differ from this one along
    ``axis`` only."""
    return self.device_mesh.get_group(axis)


def split_axis_sizes(total: int, n_axes: int) -> list:
  """The JAX package's default split of ``total`` devices over ``n_axes``
  axes: the last axis gets the largest power-of-two factor that does not
  exceed the rest, the first axis the rest, the axes between 1."""
  if n_axes == 1:
    return [total]
  last = 1
  while last * 2 <= total and total % (last * 2) == 0 and last < (
      total // last):
    last *= 2
  return [total // last] + [1] * (n_axes - 2) + [last]


def default_devices(n: int) -> list:
  """``cuda:0`` .. ``cuda:n-1``; raises when the host has fewer cards."""
  found = torch.cuda.device_count() if torch.cuda.is_available() else 0
  if found < n:
    raise RuntimeError(
        f"{n} ranks need {n} CUDA devices, but {found} are available; name "
        "the devices (several ranks may share one card over gloo) or run "
        "on the CPU")
  return [torch.device("cuda", r) for r in range(n)]


def backend_for(devices: Sequence) -> str:
  """NCCL when every rank has a card of its own, else gloo."""
  devices = [torch.device(d) for d in devices]
  if any(d.type != "cuda" for d in devices):
    return "gloo"
  if len({(d.type, d.index) for d in devices}) < len(devices):
    return "gloo"  # NCCL refuses two ranks on one GPU
  return "nccl"


def _rank_device(devices, rank: int) -> torch.device:
  dev = torch.device(devices[rank])
  if dev.type == "cuda":
    if dev.index is None:
      dev = torch.device("cuda", 0)
    if not torch.cuda.is_available() or dev.index >= torch.cuda.device_count():
      raise RuntimeError(
          f"rank {rank} is to run on {dev}, but "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
          "CUDA devices are available")
    torch.cuda.set_device(dev)
  return dev


def init_world(rank: int, world_size: int, devices: Optional[Sequence] = None,
               init_method: str = "env://") -> None:
  """Join the process group of a world of ``world_size`` ranks as ``rank``
  on ``devices[rank]`` (default ``cuda:rank``), over the backend that
  ``backend_for`` picks.  ``init_method`` is torch.distributed's
  (``env://`` under ``torchrun``; ``file://<path>``; ``tcp://host:port``).
  """
  devices = list(devices) if devices is not None else default_devices(
      world_size)
  if len(devices) != world_size:
    raise ValueError(f"{len(devices)} devices for {world_size} ranks")
  _rank_device(devices, rank)
  dist.init_process_group(backend_for(devices), init_method=init_method,
                          rank=rank, world_size=world_size)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (BATCH,),
    devices: Optional[Sequence] = None,
    axis_sizes: Optional[Sequence[int]] = None,
) -> Mesh:
  """A mesh over the initialised ``torch.distributed`` world.

  ``n_devices`` (default: the world size) must be the world size: every
  rank is one device of the mesh.  ``devices`` names each rank's device
  (default ``cuda:rank``: with fewer cards than ranks this raises; it never
  drops to the CPU).  A 2-D ``("batch", "spatial")`` mesh splits the ranks
  as the JAX package does unless ``axis_sizes`` says otherwise.
  """
  from torch.distributed.device_mesh import init_device_mesh

  if not dist.is_initialized():
    raise RuntimeError(
        "make_mesh needs an initialised torch.distributed world: start the "
        "ranks with parallel.mesh.run_ranks, or under torchrun call "
        "parallel.mesh.init_world first")
  world = dist.get_world_size()
  n = world if n_devices is None else int(n_devices)
  if n != world:
    raise ValueError(
        f"a mesh of {n} devices needs a world of {n} ranks; this world has "
        f"{world}")
  devices = (list(devices)[:n] if devices is not None
             else default_devices(n))
  if len(devices) != n:
    raise ValueError(f"{len(devices)} devices for a mesh of {n} ranks")
  rank = dist.get_rank()
  dev = _rank_device(devices, rank)
  backend = dist.get_backend()
  if backend == "nccl" and backend_for(devices) != "nccl":
    raise ValueError(
        f"devices {[str(d) for d in devices]} need the gloo backend (NCCL "
        "takes one rank per card and no CPU ranks); this world runs nccl")
  axis_names = tuple(axis_names)
  sizes = (list(axis_sizes) if axis_sizes is not None
           else split_axis_sizes(n, len(axis_names)))
  if len(sizes) != len(axis_names) or int(torch.tensor(sizes).prod()) != n:
    raise ValueError(f"axis sizes {sizes} do not cover {n} ranks over the "
                     f"axes {axis_names}")
  device_mesh = init_device_mesh(dev.type, tuple(sizes),
                                 mesh_dim_names=axis_names)
  return Mesh(device_mesh, dev)


def _rank_entry(rank, fn, world_size, devices, tmp, args):
  """One spawned rank: join the world, run ``fn(*args)``, leave it; rank
  0's return value is pickled to ``tmp``'s ``rank0``.  A rank whose ``fn``
  raises writes its traceback to ``tmp``'s ``failed.<time>.<rank>`` before
  it leaves the world, so before any rank that fails because it left: the
  names sort in the order the ranks failed."""
  init_world(rank, world_size, devices, f"file://{os.path.join(tmp, 'store')}")
  try:
    out = fn(*args)
  except BaseException:
    failed = f"failed.{time.monotonic_ns():020d}.{rank}"
    with open(os.path.join(tmp, failed), "w") as f:
      f.write(traceback.format_exc())
    raise
  finally:
    dist.destroy_process_group()
  if rank == 0:
    with open(os.path.join(tmp, "rank0"), "wb") as f:
      pickle.dump(out, f)


def _world_failure(tmp, world_size, rank, reported) -> str:
  """A failed world's message: every rank's recorded failure, the earliest
  first, after the failure torch reported where that rank recorded none
  (it was killed, or failed to join)."""
  failures = []
  for name in sorted(os.listdir(tmp)):
    if name.startswith("failed."):
      with open(os.path.join(tmp, name)) as f:
        failures.append((int(name.rsplit(".", 1)[1]), f.read()))
  if rank not in {r for r, _ in failures}:
    failures.insert(0, (rank, reported))
  return f"a world of {world_size} ranks failed: " + "; then ".join(
      f"rank {r}: {text}" for r, text in failures)


def run_ranks(fn: Callable, world_size: int,
              devices: Optional[Sequence] = None, args: Sequence = (),
              timeout: Optional[float] = None):
  """Run ``fn(*args)`` in a world of ``world_size`` processes on this host
  (``torch.multiprocessing``, spawned), rank r on ``devices[r]`` (default
  ``cuda:r``), and return rank 0's return value.

  ``fn`` and ``args`` must pickle (``fn`` by its import path).  The ranks
  meet on a file store in a temporary directory, so concurrent worlds never
  share a port.  A rank that fails ends the world: the others are
  terminated and this raises with the failed ranks' tracebacks, the first
  to fail first, or the exit code of a rank that died; so does a world
  still running after ``timeout`` seconds.
  """
  import torch.multiprocessing as mp

  devices = ([str(d) for d in devices] if devices is not None
             else [str(d) for d in default_devices(world_size)])
  with tempfile.TemporaryDirectory(prefix="wb2_ranks_") as tmp:
    ranks = mp.start_processes(
        _rank_entry, args=(fn, world_size, devices, tmp, tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    failed = None
    try:
      while not ranks.join(None if deadline is None else max(
          0.0, deadline - time.monotonic()), grace_period=5):
        if deadline is not None and time.monotonic() >= deadline:
          raise TimeoutError(
              f"a world of {world_size} ranks still ran after {timeout} s")
    except mp.ProcessExitedException as err:
      failed = (err.error_index, f"exit code {err.exit_code}")
    except mp.ProcessRaisedException as err:
      failed = (err.error_index, str(err))
    finally:
      for p in ranks.processes:
        if p.is_alive():
          p.kill()
        p.join()
    if failed is not None:
      raise RuntimeError(_world_failure(tmp, world_size, *failed)) from None
    with open(os.path.join(tmp, "rank0"), "rb") as f:
      return pickle.load(f)

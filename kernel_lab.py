#!/usr/bin/env python3
"""Measurements of the reduction kernels' design choices, on the card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 kernel_lab.py [MODE ...]

with modes chain, blocks, profile and stream (all when none is named),
at the official 0.25-degree shape (126, 1 038 240) with thirteen regions:

  chain    builds csrc/reductions.cu with WB2_CHAIN_STAGES = 1, 2, 4, 16
           and 4096 (stages of 32 cells whose MMAs run into one tensor-core
           accumulator before it is added to the fp32 sum; 1 is what
           ships) and prints each build's time and its error against
           float64 sums, beside the plain float32 version's error;
  blocks   times the shipped build at several numbers of blocks for the
           tensor-core core (the splits of the cell axis follow from it);
  profile  device time of each launch of a call (torch.profiler);
  stream   what the card's memory gives plain streaming reads of the same
           arrays (torch.sum of one and of three arrays, float32), as a
           measured ceiling beside the data-sheet rate.

Each line is one JSON object; the first names the card and its power limit.
The package itself has one build and one plan: the variants are built and
launched here, through the same C entry points.
"""
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from weatherbench2_torch import metrics
from weatherbench2_torch.ops import _build
from weatherbench2_torch.ops import reductions as red
from weatherbench2_torch.regions import SliceRegion

ROWS, GRID, N_REGIONS = 126, (1440, 721), 13


def emit(**fields):
  print(json.dumps(fields), flush=True)


def region_weights(n_lon, n_lat, n_regions):
  lat = np.linspace(-90, 90, n_lat)
  lon = np.linspace(0, 360, n_lon, endpoint=False)
  w = metrics._cell_area_from_latitude(np.deg2rad(lat))
  w = (w / w.mean()).astype(np.float32)
  regions = [SliceRegion()]
  for i in range(n_regions - 1):
    lo = -80 + 11 * i
    regions.append(SliceRegion(lat_slice=slice(lo, lo + 30),
                               lon_slice=slice(25 * i, 25 * i + 150)))
  return red.make_region_weight_matrix(
      w, [r.mask_weights(lat, lon) for r in regions], n_lon)


def build_variant(define):
  """csrc/reductions.cu compiled with -D`define`, loaded and typed."""
  path = _build.BUILD_DIR / f"libwb2kernels_{define.replace('=', '_')}.so"
  os.makedirs(_build.BUILD_DIR, exist_ok=True)
  subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-D{define}", "-o",
                  str(path), str(_build.SOURCE)], check=True)
  return _build.bind(path)


def launch(lib, arrays, w, core, target_blocks=None):
  """One launch of `lib`'s `core`: kernel 1 on (f, t, c) or (f, t, None),
  kernel 2 on (x,).  `target_blocks` replaces the plan's number of blocks
  (a one-wave grid of them).  Returns the outputs and the grid."""
  rows, cols = arrays[0].shape
  kind = (red.KIND_REGION if len(arrays) == 1 else
          red.KIND_DET if arrays[2] is None else red.KIND_DET_CLIM)
  plan = red.launch_plan(kind, rows, cols, w.shape[0], core=core)
  n_splits, split_len = plan.n_splits, plan.split_len
  if target_blocks is not None:
    n_splits, split_len = red.split_plan(
        rows, cols, plan.rows_per_block, target_blocks, one_wave=True)
  stream = torch.cuda.current_stream().cuda_stream
  partial = torch.empty((n_splits,) + plan.out_shape, device="cuda")
  out = torch.empty(plan.out_shape, device="cuda")
  counters = torch.zeros(plan.n_counters, dtype=torch.int32,
                         device="cuda")
  ptrs = [None if x is None else x.data_ptr() for x in arrays]
  tail = (rows, cols, w.shape[0], core, n_splits, split_len,
          partial.data_ptr(), counters.data_ptr(), out.data_ptr(), stream)
  if kind == red.KIND_REGION:
    err = lib.wb2_fused_region_sums(ptrs[0], w.data_ptr(), *tail)
  else:
    err = lib.wb2_fused_deterministic_sums(*ptrs, w.data_ptr(), *tail)
  _build.check(err, "kernel_lab launch")
  return out, (-(-rows // plan.rows_per_block), n_splits)


def weather_like(gen):
  """Geopotential-like rows: ~5e4 with forecast errors of ~1e2."""
  cols = GRID[0] * GRID[1]
  t = 5e4 + 3e3 * torch.randn(ROWS, cols, generator=gen, device="cuda")
  f = t + 1e2 * torch.randn(ROWS, cols, generator=gen, device="cuda")
  c = t + 5e2 * torch.randn(ROWS, cols, generator=gen, device="cuda")
  f[3] = float("nan")
  f[torch.rand(ROWS, cols, generator=gen, device="cuda") < 0.01] = float("nan")
  return f, t, c


def time_ms(fn, n=15):
  fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    fn()
    end.record()
    times.append((start, end))
  torch.cuda.synchronize()
  return statistics.median(s.elapsed_time(e) for s, e in times)


def rel_err(got, want64, scale64):
  """max |got - want| / sum|W.stat| per output, against float64."""
  return float(((got.double() - want64).abs() / scale64.clamp_min(1e-30))
               .max())


def float64_sums(f, t, c, w):
  """Kernel 1's outputs and their sum|W.stat| scales in float64."""
  nan = torch.isnan(f) | torch.isnan(t) | torch.isnan(c)
  w64 = w.double().T
  outs, scales = [], []
  f0, t0, c0 = (torch.where(nan, 0.0, x).double() for x in (f, t, c))
  for s in (f0 - t0, (f0 - t0) ** 2, (f0 - t0).abs(), (f0 - c0) * (t0 - c0),
            (f0 - c0) ** 2, (t0 - c0) ** 2, (~nan).double()):
    outs.append((s @ w64).T)
    scales.append((s.abs() @ w64.abs()).T)
    del s
  return torch.stack(outs), torch.stack(scales)


def chain(f, t, c, w):
  want, scale = float64_sums(f, t, c, w)
  plain = red.fused_deterministic_sums_plain(f, t, c, w)
  plain = torch.cat([plain[0], plain[1][None]])
  emit(what="plain float32 matmuls",
       err_over_scale=[rel_err(plain[k], want[k], scale[k])
                       for k in range(7)])
  for stages in (1, 2, 4, 16, 4096):
    lib = build_variant(f"WB2_CHAIN_STAGES={stages}")
    got = launch(lib, (f, t, c), w, red.CORE_MMA)[0]
    emit(what="3xTF32 kernel 1, mma core", chain_stages=stages,
         mmas_per_chain=12 * stages,
         err_over_scale=[rel_err(got[k], want[k], scale[k])
                         for k in range(7)],
         kernel_ms=time_ms(lambda: launch(lib, (f, t, c), w, red.CORE_MMA)),
         region_ms=time_ms(lambda: launch(lib, (f,), w, red.CORE_MMA)))


def blocks(f, t, c, w):
  lib = _build.library()
  for target in (66, 132, 132 * 2):
    emit(target_blocks=target,
         det_grid=launch(lib, (f, t, c), w, red.CORE_MMA, target)[1],
         region_grid=launch(lib, (f,), w, red.CORE_MMA, target)[1],
         det_clim_ms=time_ms(
             lambda: launch(lib, (f, t, c), w, red.CORE_MMA, target)),
         det_ms=time_ms(
             lambda: launch(lib, (f, t, None), w, red.CORE_MMA, target)),
         region_ms=time_ms(
             lambda: launch(lib, (f,), w, red.CORE_MMA, target)))


def profile(f, t, c, w):
  from torch.profiler import ProfilerActivity, profile as prof

  red.launch_deterministic_sums(f, t, c, w)
  red.launch_region_sums(f, w)
  torch.cuda.synchronize()
  with prof(activities=[ProfilerActivity.CUDA]) as p:
    for _ in range(5):
      red.launch_deterministic_sums(f, t, c, w)
      red.launch_region_sums(f, w)
    torch.cuda.synchronize()
  emit(device_ms_per_launch={
      e.key.replace("(anonymous namespace)::", "")[:24]:
      e.self_device_time_total / e.count / 1e3
      for e in p.key_averages() if e.self_device_time_total})


def stream(f, t, c, w):
  """Bytes a second of PyTorch's own streaming reductions over the inputs."""
  f = torch.nan_to_num(f)
  one = time_ms(lambda: f.sum())
  three = time_ms(lambda: (f.sum(), t.sum(), c.sum()))
  nbytes = f.numel() * 4
  emit(what="torch.sum over (126, 1038240) float32",
       one_array_ms=one, one_array_tb_s=nbytes / one / 1e9,
       three_arrays_ms=three, three_arrays_tb_s=3 * nbytes / three / 1e9)


def main(argv):
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  emit(card=smi, shape=[ROWS, GRID[0] * GRID[1]], regions=N_REGIONS)
  gen = torch.Generator(device="cuda")
  gen.manual_seed(7)
  f, t, c = weather_like(gen)
  w = torch.as_tensor(region_weights(*GRID, N_REGIONS), device="cuda")
  modes = {"chain": chain, "blocks": blocks, "profile": profile,
           "stream": stream}
  for mode in argv or modes:
    modes[mode](f, t, c, w)


if __name__ == "__main__":
  main(sys.argv[1:])

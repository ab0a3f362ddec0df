#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold it to its references.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits non-zero without the final line):

  device   the card as nvidia-smi and torch report it, torch/CUDA versions;
  build    nvcc build of csrc/reductions.cu (ptxas register report on
           stderr);
  kernels  each CUDA kernel against its plain PyTorch version on the card:
           timed at the main path's shapes (three regions), at the
           240x121 shapes with the thirteen official regions and at the
           official 0.25-degree shape, without and with NaNs, with
           CUDA-event medians of the kernel, of each core of the library
           where it can run, of the plain version and of one torch.matmul
           yardstick, beside the bound; two launches must give the same
           bits; the 0.25-degree cases also print the kernel's and the
           plain version's error against float64 sums.  The bound's
           operations are counted by type: the statistics at the fp32 rate,
           the weighted sums at the rate of the unit the planned core runs
           them on (TF32 tensor cores or fp32).  Then untimed cases through
           every code path: each core forced, odd lengths, bases off
           16-byte alignment, rows that fill no tile, R = 1..16, with and
           without NaNs and a climatology, and infinite inputs; and the
           tensor-core core against its CPU emulation, bit for bit;
  e2e      the bench suite (MSE/RMSE/Bias/ACC of z500/700/850 and t2m, three
           regions, by init) through evaluation.evaluate_with_mesh at
           240x121 over January 2020 (62 inits x 21 leads), with the
           kernels' launch counters read around the run, then the first 16
           inits on the card and on the CPU, compared;
  e2e13    the same suite and stores with the thirteen official regions,
           first 16 inits on the card and on the CPU, compared;
  e2e025   MSE/RMSE/MAE/Bias of z500/700/850 and t2m with the thirteen
           regions at 1440x721, 4 inits x 21 leads, one init a chunk; the
           first init's results are held against the plain versions run on
           the card on the same stores.

The last lines are the kernel summary, the nvidia-smi name and power
limit, and {"ok": true, "device": {...}}.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12   # H100 SXM data sheet, fp32 outside tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM data sheet, dense TF32 on tensor cores
RTOL = 1e-5
TIMED_LAUNCHES = 25
SEED = 20200101
SOURCE = "weatherbench2_torch/csrc/reductions.cu"
WIDE_RESOLUTION = 0.25  # degrees: the 1440x721 grid of the e2e025 phase
TOLERANCE = (f"|kernel-plain| <= {RTOL}*(|plain| + sum|W*stat|): float32 "
             "(the kernel's tensor-core path: 3xTF32) summed in another order")
E2E_TOLERANCE = (f"rtol={RTOL} + atol={RTOL}*max|reference| per variable: "
                 "float32 sums in another order")


def emit(phase, **fields):
  print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


# -- kernels ------------------------------------------------------------------


def official_regions():
  """The thirteen predefined regions of the official evaluation."""
  from weatherbench2_torch.regions import SliceRegion

  return {
      "global": SliceRegion(),
      "tropics": SliceRegion(lat_slice=slice(-20, 20)),
      "extra-tropics": SliceRegion(
          lat_slice=[slice(None, -20), slice(20, None)]),
      "northern-hemisphere": SliceRegion(lat_slice=slice(20, None)),
      "southern-hemisphere": SliceRegion(lat_slice=slice(None, -20)),
      "europe": SliceRegion(
          lat_slice=slice(35, 75),
          lon_slice=[slice(360 - 12.5, None), slice(0, 42.5)]),
      "north-america": SliceRegion(
          lat_slice=slice(25, 60), lon_slice=slice(360 - 120, 360 - 75)),
      "north-atlantic": SliceRegion(
          lat_slice=slice(25, 65), lon_slice=slice(360 - 70, 360 - 10)),
      "north-pacific": SliceRegion(
          lat_slice=slice(25, 60), lon_slice=slice(145, 360 - 130)),
      "east-asia": SliceRegion(
          lat_slice=slice(25, 60), lon_slice=slice(102.5, 150)),
      "ausnz": SliceRegion(
          lat_slice=slice(-45, -12.5), lon_slice=slice(120, 175)),
      "arctic": SliceRegion(lat_slice=slice(60, 90)),
      "antarctic": SliceRegion(lat_slice=slice(-90, -60)),
  }


def region_weights(n_lon, n_lat, n_regions):
  """(R, n_lon*n_lat) weights: global, tropics, extra-tropics, then boxes."""
  from weatherbench2_torch import metrics, ops
  from weatherbench2_torch.regions import ExtraTropicalRegion, SliceRegion

  lat = np.linspace(-90, 90, n_lat)
  lon = np.linspace(0, 360, n_lon, endpoint=False)
  w = metrics._cell_area_from_latitude(np.deg2rad(lat))
  w = (w / w.mean()).astype(np.float32)
  regions = [SliceRegion(), SliceRegion(lat_slice=slice(-20, 20)),
             ExtraTropicalRegion()]
  for i in range(n_regions - 3):
    lo = -75 + 14 * i
    regions.append(SliceRegion(lat_slice=slice(lo, lo + 30),
                               lon_slice=slice(27 * i, 27 * i + 120)))
  return ops.make_region_weight_matrix(
      w, [r.mask_weights(lat, lon) for r in regions[:n_regions]], n_lon)


def cuda_time_ms(fn, arg_sets):
  """Median ms of single launches on alternating input sets (CUDA events).

  A device sleep ahead of each start event lets the host enqueue the call
  before the device reaches it, so host launch overhead is not timed.
  """
  import torch

  for args in arg_sets:
    fn(*args)
  torch.cuda.synchronize()
  times = []
  for i in range(TIMED_LAUNCHES):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    fn(*arg_sets[i % len(arg_sets)])
    end.record()
    times.append((start, end))
  torch.cuda.synchronize()
  return statistics.median(s.elapsed_time(e) for s, e in times)


def at_offset(x, offset):
  """A contiguous copy of x that starts `offset` elements into a buffer."""
  import torch

  if x is None or not offset:
    return x
  buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
  view = buf[offset:].view(x.shape)
  view.copy_(x)
  return view


def det_inputs(b, l, gen, nans):
  import torch

  f = torch.randn(b, l, generator=gen, device="cuda")
  t = torch.randn(b, l, generator=gen, device="cuda")
  c = 0.3 * torch.randn(b, l, generator=gen, device="cuda")
  if nans:
    f[b // 3] = float("nan")  # whole NaN rows
    t[b // 2] = float("nan")
    for x, p in ((f, 0.01), (t, 0.01), (c, 0.005)):
      x[torch.rand(b, l, generator=gen, device="cuda") < p] = float("nan")
  return f, t, c


def region_inputs(n, l, gen, nans):
  import torch

  x = torch.randn(n, l, generator=gen, device="cuda")
  if nans:
    x[0] = float("nan")
    x[torch.rand(n, l, generator=gen, device="cuda") < 0.01] = float("nan")
  return (x,)


def det_stats(f, t, c, dtype):
  """The six NaN-masked statistics, the valid mask and the NaN mask."""
  import torch

  nan = torch.isnan(f) | torch.isnan(t)
  if c is not None:
    nan |= torch.isnan(c)
  f0 = torch.where(nan, 0.0, f).to(dtype)
  t0 = torch.where(nan, 0.0, t).to(dtype)
  c0 = torch.zeros_like(f0) if c is None else torch.where(nan, 0.0, c).to(
      dtype)
  return [f0 - t0, (f0 - t0) ** 2, (f0 - t0).abs(), (f0 - c0) * (t0 - c0),
          (f0 - c0) ** 2, (t0 - c0) ** 2], (~nan).to(dtype), nan.to(dtype)


def det_scale(f, t, c, w):
  """Σ_l |W·stat| of each output: the magnitude the error is held to."""
  import torch

  stats, _, _ = det_stats(f, t, c, torch.float32)
  aw = w.abs().T
  sums = torch.stack([s.abs() @ aw for s in stats]).permute(0, 2, 1)
  ones = torch.ones_like(f)
  return sums, (ones @ aw).T, (ones @ (w > 0).float().T).T


def region_scale(x, w):
  import torch

  x0 = torch.nan_to_num(x.abs())
  ones = torch.ones_like(x0)
  return (x0 @ w.abs().T).T, (ones @ w.abs().T).T, (ones @ (w > 0).float().T).T


def float64_outputs(name, args, w):
  """(sums, wsum_valid) of a kernel's function in float64, on the card."""
  import torch

  w64 = w.double().T
  if name == "fused_deterministic_sums":
    stats, valid, _ = det_stats(*args, torch.float64)
    sums = torch.stack([(s @ w64).T for s in stats])
  else:
    nan = torch.isnan(args[0])
    valid = (~nan).double()
    sums = (torch.where(nan, 0.0, args[0]).double() @ w64).T
  return sums, (valid @ w64).T


def compare(got, want, scale, names):
  """Max abs / rel error per output; raises past rtol·(|want| + scale)."""
  report = {}
  for g, p, s, name in zip(got, want, scale, names):
    err = (g.double() - p.double()).abs()
    bound = RTOL * (p.double().abs() + s.double())
    bad = int((err > bound).sum())
    report[name] = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / p.double().abs().clamp_min(1e-30)).max()),
        "max_err_over_bound": float((err / bound.clamp_min(1e-30)).max()),
    }
    if bad:
      raise AssertionError(f"{name}: {bad} values outside the tolerance "
                           f"{report[name]}")
  return report


NAMES = ("sums", "wsum_valid", "nan_w")
CORES = {"scalar": 0, "vec4": 1, "mma": 2}


def kernel_functions(name, w):
  """(wrapper, plain version, launch with a forced core, scale) of a kernel."""
  from weatherbench2_torch import ops
  from weatherbench2_torch.ops import reductions

  if name == "fused_deterministic_sums":
    return (lambda f, t, c: ops.fused_deterministic_sums(f, t, c, w),
            lambda f, t, c: ops.fused_deterministic_sums_plain(f, t, c, w),
            lambda core: lambda f, t, c: reductions.launch_deterministic_sums(
                f, t, c, w, core),
            lambda f, t, c: det_scale(f, t, c, w))
  return (lambda x: ops.fused_region_sums(x, w),
          lambda x: ops.fused_region_sums_plain(x, w),
          lambda core: lambda x: reductions.launch_region_sums(x, w, core),
          lambda x: region_scale(x, w))


def check_nan_rows(name, got, args):
  """Whole-NaN rows have no valid weight at all: exactly zero."""
  import torch

  rows = torch.isnan(args[0]).all(dim=1)
  if name == "fused_deterministic_sums":
    rows |= torch.isnan(args[1]).all(dim=1)
  if not rows.any():
    raise AssertionError("the NaN case has no whole-NaN row")
  if not bool((got[1][:, rows] == 0).all()):
    raise AssertionError(f"{name}: wsum_valid of a whole-NaN row is not 0")
  if not bool((got[2][:, rows] > 0).any()):
    raise AssertionError(f"{name}: nan_w of a whole-NaN row is 0 everywhere")


def kernel_case(name, shape, n_regions, grid, nans, with_clim, gen,
                float64=False):
  """One kernel at one shape against its plain version; timings."""
  import torch

  from weatherbench2_torch.ops import reductions

  rows, cols = shape
  w = torch.as_tensor(region_weights(*grid, n_regions), device="cuda")
  assert w.shape == (n_regions, cols)
  kernel, plain, forced, scale_of = kernel_functions(name, w)
  if name == "fused_deterministic_sums":
    sets = [det_inputs(rows, cols, gen, nans) for _ in range(2)]
    if not with_clim:
      sets = [(f, t, None) for f, t, _ in sets]
    n_in = 3 if with_clim else 2
    stat_rows = 8
    stat_flops_per_cell = 12
    kind = reductions.KIND_DET_CLIM if with_clim else reductions.KIND_DET
    library_call = ("torch.matmul(f, W.T), fp32, TF32 off: no single PyTorch "
                    "call computes this function; one matmul = 1/8 of the "
                    "sums")
  else:
    sets = [region_inputs(rows, cols, gen, nans) for _ in range(2)]
    n_in = 1
    stat_rows = 3
    stat_flops_per_cell = 3
    kind = reductions.KIND_REGION
    library_call = ("torch.matmul(x, W.T), fp32, TF32 off: the `sums` output "
                    "only (1 of 3), a yardstick")
  library = lambda *args: torch.matmul(args[0], w.T)
  plan = reductions.launch_plan(kind, rows, cols, n_regions)
  got = kernel(*sets[0])
  torch.cuda.synchronize()
  want = plain(*sets[0])
  report = compare(got, want, scale_of(*sets[0]), NAMES)
  again = kernel(*sets[0])
  if not all(torch.equal(g, a) for g, a in zip(got, again)):
    raise AssertionError(f"{name} {shape}: two launches differ in their bits")
  if nans:
    check_nan_rows(name, got, sets[0])
  nbytes = 4 * (n_in * rows * cols + n_regions * cols
                + stat_rows * n_regions * rows)
  # operations by type: the statistics are fp32 on the CUDA cores in every
  # core; the weighted sums (a multiply-add per statistic, region and cell)
  # run where the planned core puts them
  stat_flops = rows * cols * stat_flops_per_cell
  sum_flops = rows * cols * 2 * stat_rows * n_regions
  on_tensor_cores = plan.core == CORES["mma"]
  sum_rate = TF32_FLOPS_PER_S if on_tensor_cores else FP32_FLOPS_PER_S
  bytes_s = nbytes / HBM_BYTES_PER_S
  ops_s = stat_flops / FP32_FLOPS_PER_S + sum_flops / sum_rate
  bound_ms = max(bytes_s, ops_s) * 1e3
  result = {
      "kernel": name, "shape": list(shape), "regions": n_regions,
      "nans": nans, "clim": with_clim if n_in != 1 else None,
      "core": [k for k, v in CORES.items() if v == plan.core][0],
      "grid": list(plan.grid), "errors": report, "tolerance": TOLERANCE,
      "bit_identical_relaunch": True,
      "kernel_ms": cuda_time_ms(kernel, sets),
      # each 16-byte core forced on the same inputs, in the same process:
      # vec4 (up to four regions) is the core that the tensor-core core
      # must not lose to where the wrapper plans it
      "core_ms": {k: cuda_time_ms(forced(CORES[k]), sets)
                  for k in ("vec4", "mma") if k == "mma" or n_regions <= 4},
      "plain_ms": cuda_time_ms(plain, sets),
      "library_ms": cuda_time_ms(library, sets),
      "library_call": library_call,
      "bound_ms": bound_ms,
      "bound_by": "bytes" if bytes_s >= ops_s else "operations",
      "bytes_ms": bytes_s * 1e3, "operations_ms": ops_s * 1e3,
      "bound_basis": f"{nbytes} bytes at {HBM_BYTES_PER_S:.3g} B/s; "
                     f"{stat_flops} flop of statistics at "
                     f"{FP32_FLOPS_PER_S:.3g} flop/s plus {sum_flops} flop "
                     f"of weighted sums at {sum_rate:.3g} flop/s "
                     f"({'TF32 tensor cores' if on_tensor_cores else 'fp32'}"
                     "; H100 SXM data sheet)",
  }
  if float64:
    sums64, wsum64 = float64_outputs(name, sets[0], w)
    scale = scale_of(*sets[0])
    result["error_vs_float64_over_scale"] = {
        who: {"sums": float(((out[0].double() - sums64).abs()
                             / scale[0].double().clamp_min(1e-30)).max()),
              "wsum_valid": float(((out[1].double() - wsum64).abs()
                                   / scale[1].double().clamp_min(1e-30)).max())}
        for who, out in (("kernel", got), ("plain", want))}
    del sums64, wsum64
  emit("kernels", **result)
  del sets, got, want, again
  torch.cuda.empty_cache()
  return result


def path_cases(gen):
  """Untimed cases through every code path of the library.

  Layouts: 64x33 = 2112 cells (16-byte cores), 65x31 = 2015 cells (odd
  length), and 2112 cells starting one element into a buffer (base off
  16-byte alignment); the last two must plan the one-cell-a-step core.
  On the first layout every core is forced in turn (the CUDA-core 16-byte
  core up to four regions, which is all it is built for).  70 and 130 rows
  fill no tile of any core (8 rows, 64 and 128 rows).
  """
  import torch

  from weatherbench2_torch.ops import reductions

  layouts = (("aligned", (64, 33), 0), ("odd", (65, 31), 0),
             ("offset", (64, 33), 1))
  count = 0
  worst = 0.0
  cores_seen = set()
  for n_regions in (1, 4, 5, 8, 9, 13, 16):
    for layout, grid, offset in layouts:
      cols = grid[0] * grid[1]
      w = at_offset(torch.as_tensor(region_weights(*grid, n_regions),
                                    device="cuda"), offset)
      for nans in (False, True):
        cases = [("fused_region_sums", None,
                  region_inputs(130, cols, gen, nans))]
        f, t, c = det_inputs(70, cols, gen, nans)
        cases += [("fused_deterministic_sums", True, (f, t, c)),
                  ("fused_deterministic_sums", False, (f, t, None))]
        for name, with_clim, args in cases:
          args = tuple(at_offset(x, offset) for x in args)
          kernel, plain, forced, scale_of = kernel_functions(name, w)
          want = plain(*args)
          scale = scale_of(*args)
          kind = (reductions.KIND_REGION if with_clim is None else
                  reductions.KIND_DET_CLIM if with_clim else
                  reductions.KIND_DET)
          plan = reductions.launch_plan(
              kind, args[0].shape[0], cols, n_regions,
              reductions._is_aligned(*args, w))
          if (plan.core == CORES["scalar"]) != (layout != "aligned"):
            raise AssertionError(f"{layout} layout planned core {plan.core}")
          runs = [("planned", kernel)]
          if layout == "aligned":
            runs += [(k, forced(v)) for k, v in CORES.items()
                     if k != "vec4" or n_regions <= 4]
          for which, fn in runs:
            got = fn(*args)
            torch.cuda.synchronize()
            try:
              report = compare(got, want, scale, NAMES)
            except AssertionError as err:
              raise AssertionError(
                  f"{name} R={n_regions} {layout} nans={nans} "
                  f"clim={with_clim} core={which}: {err}") from err
            if nans:
              check_nan_rows(name, got, args)
            if not all(torch.equal(g, a) for g, a in zip(got, fn(*args))):
              raise AssertionError(f"{name} R={n_regions} {layout} "
                                   f"core={which}: two launches differ")
            worst = max(worst, max(v["max_err_over_bound"]
                                   for v in report.values()))
            cores_seen.add(plan.core if which == "planned" else CORES[which])
            count += 1
  if cores_seen != set(CORES.values()):
    raise AssertionError(f"cores launched: {cores_seen}")
  emit("kernels", path_cases=count, worst_err_over_bound=worst,
       regions=[1, 4, 5, 8, 9, 13, 16], tolerance=TOLERANCE,
       layouts=[name for name, _, _ in layouts])


def infinite_cases(gen):
  """Infinite inputs and squares that overflow, through every core.

  Every core and the plain version must agree on which outputs are not
  finite (an infinity times a zero weight is NaN in all of them; the
  tensor-core core may give NaN where the others give an infinity) and,
  within the tolerance, on the rest: the rows without such values.
  """
  import torch

  grid = (64, 33)
  cols = grid[0] * grid[1]
  count = 0
  for n_regions in (3, 13):
    w = torch.as_tensor(region_weights(*grid, n_regions), device="cuda")
    f, t, c = det_inputs(70, cols, gen, False)
    f[5, 100] = float("inf")
    t[7, 200] = float("-inf")
    f[9, 300] = 3e19  # finite, its square is not
    (x,) = region_inputs(130, cols, gen, False)
    x[5, 100] = float("inf")
    x[77, 2000] = float("-inf")
    for name, args in (("fused_deterministic_sums", (f, t, c)),
                       ("fused_deterministic_sums", (f, t, None)),
                       ("fused_region_sums", (x,))):
      kernel, plain, forced, scale_of = kernel_functions(name, w)
      want = plain(*args)
      scale = scale_of(*args)
      if all(bool(torch.isfinite(p).all()) for p in want):
        raise AssertionError(f"{name}: the infinite case is finite")
      runs = [("planned", kernel)] + [
          (k, forced(v)) for k, v in CORES.items()
          if k != "vec4" or n_regions <= 4]
      for which, fn in runs:
        got = fn(*args)
        for g, p, sc, out in zip(got, want, scale, NAMES):
          finite = torch.isfinite(p)
          if not torch.equal(torch.isfinite(g), finite):
            raise AssertionError(
                f"{name} R={n_regions} core={which}: {out} is finite "
                "where the plain version is not, or the reverse")
          zero = torch.zeros_like(p)
          compare([torch.where(finite, g, zero)],
                  [torch.where(finite, p, zero)],
                  [torch.where(finite, sc, zero)], [out])
        count += 1
  emit("kernels", infinite_cases=count, regions=[3, 13],
       check="outputs not finite exactly where the plain version's are not; "
             "the others within the tolerance")


def emulation_cases(gen):
  """The tensor-core core against its CPU emulation, bit for bit.

  ops.reductions.tf32_split_sums_emulation repeats pass1_mma's arithmetic
  in torch (the split, the order of the MMAs, the tensor core's adder, the
  fp32 sums of chains and splits), and the CPU tests hold that emulation
  against float64.  Here the kernel is held to it, so that neither can
  drift from the other: weather-like magnitudes, NaN rows and scattered
  NaNs, 2112 cells.
  """
  import torch

  from weatherbench2_torch.ops import reductions

  grid = (64, 33)
  cols = grid[0] * grid[1]
  mma = CORES["mma"]
  count = 0
  for n_regions in (3, 13):
    w = torch.as_tensor(region_weights(*grid, n_regions), device="cuda")
    f, t, c = det_inputs(70, cols, gen, True)
    t = 5e4 + 3e3 * t
    f = t + 1e2 * f
    c = t + 5e2 * c
    (x,) = region_inputs(130, cols, gen, True)
    x = 5e4 + 3e3 * x
    cpu = lambda *tensors: [None if v is None else v.cpu() for v in tensors]
    cases = (
        ("fused_deterministic_sums, climatology",
         reductions.launch_deterministic_sums(f, t, c, w, mma),
         reductions.fused_deterministic_sums_tf32_emulation(*cpu(f, t, c, w))),
        ("fused_deterministic_sums",
         reductions.launch_deterministic_sums(f, t, None, w, mma),
         reductions.fused_deterministic_sums_tf32_emulation(
             *cpu(f, t, None, w))),
        ("fused_region_sums", reductions.launch_region_sums(x, w, mma),
         reductions.fused_region_sums_tf32_emulation(*cpu(x, w))))
    for what, got, want in cases:
      for g, e, out in zip(got, want, NAMES):
        if not torch.equal(g.cpu(), e):
          differ = g.cpu() != e
          raise AssertionError(
              f"{what} R={n_regions}: {out} of the tensor-core core differs "
              f"from its emulation in {int(differ.sum())} of {e.numel()} "
              f"values, by at most {float((g.cpu() - e).abs().max())}")
        count += 1
  emit("kernels", emulation_outputs_bit_identical=count, regions=[3, 13],
       shapes=[[70, cols], [130, cols]])


def kernels_phase():
  import torch

  from weatherbench2_torch import ops

  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED)
  before = (ops.fused_deterministic_sums.launches,
            ops.fused_region_sums.launches)
  cases = {}
  bench = (240, 121)
  official = (1440, 721)
  for nans in (False, True):
    for with_clim in (False, True):
      cases[("det", "main", nans, with_clim)] = kernel_case(
          "fused_deterministic_sums", (1008, 240 * 121), 3, bench, nans,
          with_clim, gen)
    cases[("det", "official", nans)] = kernel_case(
        "fused_deterministic_sums", (126, 1440 * 721), 13, official, nans,
        True, gen, float64=True)
    cases[("region", "main", nans)] = kernel_case(
        "fused_region_sums", (4032, 240 * 121), 3, bench, nans, None, gen)
    cases[("region", "official", nans)] = kernel_case(
        "fused_region_sums", (126, 1440 * 721), 13, official, nans, None,
        gen, float64=True)
  # the 240x121 shapes with the thirteen official regions, and the
  # 0.25-degree deterministic tier as the e2e025 phase runs it (no
  # climatology, the 63 rows of one init's z500/700/850)
  cases[("det", "official13_240")] = kernel_case(
      "fused_deterministic_sums", (1008, 240 * 121), 13, bench, False, False,
      gen)
  cases[("region", "official13_240")] = kernel_case(
      "fused_region_sums", (4032, 240 * 121), 13, bench, False, None, gen)
  cases[("det", "e2e025")] = kernel_case(
      "fused_deterministic_sums", (63, 1440 * 721), 13, official, False,
      False, gen)
  path_cases(gen)
  infinite_cases(gen)
  emulation_cases(gen)
  after = (ops.fused_deterministic_sums.launches,
           ops.fused_region_sums.launches)
  emit("kernels", launches_while_comparing={
      "fused_deterministic_sums": after[0] - before[0],
      "fused_region_sums": after[1] - before[1]})
  return cases


# -- e2e ----------------------------------------------------------------------


def write_stores(root, resolution=1.5, forecast_stop="2020-02-01",
                 truth_stop="2020-02-11", with_climatology=True,
                 blocks=(124, 16, 92)):
  """Random stores from the seed, written block by block: 6-hourly truth,
  12-hourly inits with 21 leads to 10 days, 6-hourly hourly climatology.

  Only coordinates and stub variables are built for a whole store; the
  values exist one block (`blocks` entries of time, init, dayofyear) at a
  time.
  """
  from weatherbench2_torch import schema, xds

  specs = dict(variables_3d=["geopotential"], variables_2d=["2m_temperature"],
               levels=(500, 700, 850),
               spatial_resolution_in_degrees=resolution)
  truth = schema.mock_truth_data(time_start="2020-01-01",
                                 time_stop=truth_stop,
                                 time_resolution="6 hours", **specs)
  forecast = schema.mock_forecast_data(
      time_start="2020-01-01", time_stop=forecast_stop,
      time_resolution="12 hours", lead_start="0 days", lead_stop="10 days",
      lead_resolution="12 hours", **specs)
  stores = [("truth", truth, "time", blocks[0], {"time": blocks[0]}),
            ("forecast", forecast, "time", blocks[1],
             {"time": blocks[1], "prediction_timedelta": -1})]
  if with_climatology:
    clim = schema.mock_hourly_climatology_data(hour_interval=6, **specs)
    stores.append(("climatology", clim, "dayofyear", blocks[2],
                   {"dayofyear": blocks[2]}))
  rng = np.random.default_rng(SEED)
  paths = {}
  for name, ds, dim, block, chunks in stores:
    path = os.path.join(root, f"{name}.zarr")
    template = xds.Dataset(
        {k: xds.stub_variable(v.dims, v.sizes, np.float32)
         for k, v in ds.variables_dict().items()},
        coords=dict(ds.coords_dict()))
    writer = xds.RegionWriter(path, template, chunks=chunks)
    n = ds.sizes[dim]
    for start in range(0, n, block):
      sl = slice(start, min(start + block, n))
      for vname, v in ds.variables_dict().items():
        shape = [sl.stop - sl.start if d == dim else v.sizes[d]
                 for d in v.dims]
        writer.write_array(
            vname, tuple(sl if d == dim else slice(None) for d in v.dims),
            rng.standard_normal(shape, dtype=np.float32))
    writer.finish()
    paths[name] = path
  return paths


def store_gib(paths):
  return sum(os.path.getsize(os.path.join(d, f))
             for p in paths.values() for d, _, fs in os.walk(p)
             for f in fs) / 2**30


def three_regions():
  from weatherbench2_torch.regions import ExtraTropicalRegion, SliceRegion

  return {"global": SliceRegion(),
          "tropics": SliceRegion(lat_slice=slice(-20, 20)),
          "extra-tropics": ExtraTropicalRegion()}


def bench_suite(paths, out_dir, time_slice, regions=None):
  """MSE/RMSE/Bias/ACC by init; without a climatology store MSE/RMSE/MAE/
  Bias (the deterministic tier alone)."""
  from weatherbench2_torch import config, metrics, xds

  data_config = config.Data(
      selection=config.Selection(
          variables=["geopotential", "2m_temperature"],
          levels=[500, 700, 850], time_slice=time_slice),
      paths=config.Paths(forecast=paths["forecast"], obs=paths["truth"],
                         climatology=paths.get("climatology"),
                         output_dir=out_dir),
      by_init=True)
  suite = {"mse": metrics.MSE(), "rmse": metrics.RMSESqrtBeforeTimeAvg()}
  if "climatology" in paths:
    suite["bias"] = metrics.Bias()
    suite["acc"] = metrics.ACC(climatology=xds.open_zarr(paths["climatology"]))
  else:
    suite["mae"] = metrics.MAE()
    suite["bias"] = metrics.Bias()
  eval_configs = {"deterministic": config.Eval(
      metrics=suite, regions=regions or three_regions())}
  return data_config, eval_configs


def check_results(path, n_leads, n_regions=3):
  from weatherbench2_torch import xds

  ds = xds.open_netcdf(path)
  shapes = {k: tuple(ds[k].shape) for k in ds.keys()}
  want = {"geopotential": (4, n_regions, n_leads, 3),
          "2m_temperature": (4, n_regions, n_leads)}
  if shapes != want:
    raise AssertionError(f"results shapes {shapes}, expected {want}")
  for k in ds.keys():
    if not np.isfinite(ds[k].values).all():
      raise AssertionError(f"non-finite results in {k}")
  return ds


def reset_launches():
  from weatherbench2_torch import ops

  ops.fused_deterministic_sums.launches = 0
  ops.fused_region_sums.launches = 0


def read_launches(chunks, det_per_chunk, region_per_chunk):
  """The launch counters after a run; raises unless they are as planned."""
  from weatherbench2_torch import ops

  launches = {"fused_deterministic_sums":
              ops.fused_deterministic_sums.launches,
              "fused_region_sums": ops.fused_region_sums.launches}
  if launches != {"fused_deterministic_sums": det_per_chunk * chunks,
                  "fused_region_sums": region_per_chunk * chunks}:
    raise AssertionError(
        f"launches {launches} for {chunks} chunks: expected "
        f"{det_per_chunk} and {region_per_chunk} per chunk")
  return launches


def profiled_run(paths, root, time_slice, regions=None, chunk=16):
  """The same run under torch.profiler: device time by kind, and the
  device's busy share of the wall (kernels and copies on either stream)."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  from weatherbench2_torch import evaluation

  dc, cfgs = bench_suite(paths, os.path.join(root, "profiled"), time_slice,
                         regions)
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    stats = evaluation.evaluate_with_mesh(dc, cfgs,
                                          input_chunks={"init_time": chunk})
    torch.cuda.synchronize()
  by_name = {}
  for e in prof.key_averages():
    us = getattr(e, "self_device_time_total", 0) or 0
    if us > 0:
      by_name[e.key] = us
  copy_us = sum(v for k, v in by_name.items() if k.lower().startswith(
      ("memcpy", "memset")))
  kernel_us = sum(by_name.values()) - copy_us
  own_us = sum(v for k, v in by_name.items() if "pass1_" in k or "pass2" in k)
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
  return {
      "wall_s": stats["wall_s"],
      "device_kernel_s": kernel_us / 1e6,
      "device_copy_s": copy_us / 1e6,
      "reduction_kernels_s": own_us / 1e6,
      "kernel_busy_share": kernel_us / 1e6 / stats["wall_s"],
      "top_device_ops_ms": {k[-70:]: v / 1e3 for k, v in top},
  }


def card_vs_cpu(paths, root, tag, time_slice, regions, det_per_chunk,
                region_per_chunk):
  """The same inits on the card and on the CPU; walls, launches, errors."""
  from weatherbench2_torch import evaluation

  n_regions = len(regions or three_regions())
  walls = {}
  results = {}
  launches = None
  for dev in ("cuda", "cpu"):
    dcx, cfgx = bench_suite(paths, os.path.join(root, f"{tag}_{dev}"),
                            time_slice, regions)
    reset_launches()
    s = evaluation.evaluate_with_mesh(dcx, cfgx, device=dev,
                                      input_chunks={"init_time": 16})
    if dev == "cuda":
      launches = read_launches(s["chunks"], det_per_chunk, region_per_chunk)
    else:
      read_launches(s["chunks"], 0, 0)
    walls[dev] = s["wall_s"]
    results[dev] = check_results(
        os.path.join(root, f"{tag}_{dev}", "deterministic.nc"), 21, n_regions)
  errs = {}
  for k in results["cpu"].keys():
    want = np.asarray(results["cpu"][k].values, np.float64)
    got = np.asarray(results["cuda"][k].transpose(
        *results["cpu"][k].dims).values, np.float64)
    errs[k] = hold(got, want, f"card vs CPU results, {k}")
  return {"wall_s": walls, "launches": launches, "errors": errs,
          "regions": n_regions, "tolerance": E2E_TOLERANCE}


def hold(got, want, what):
  """Errors of got against want; raises past E2E_TOLERANCE."""
  err = np.abs(got - want)
  bound = RTOL * np.abs(want) + RTOL * np.abs(want).max()
  report = {"max_abs_err": float(err.max()),
            "max_err_over_bound": float((err / bound).max())}
  if not (err <= bound).all():
    raise AssertionError(f"{what} differ: {report}")
  return report


def e2e_phase():
  import torch

  from weatherbench2_torch import evaluation, xds

  out = {}
  with tempfile.TemporaryDirectory(prefix="wb2_chip_smoke_") as root:
    t0 = time.perf_counter()
    paths = write_stores(root)
    out["write_stores_s"] = time.perf_counter() - t0
    out["store_gib"] = store_gib(paths)
    january = slice("2020-01-01", "2020-01-31")
    dc, cfgs = bench_suite(paths, os.path.join(root, "gpu"), january)

    # the main path: counters read just around it
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = evaluation.evaluate_with_mesh(dc, cfgs,
                                          input_chunks={"init_time": 16})
    chunks = stats["chunks"]
    launches = read_launches(chunks, 2, 1)
    check_results(os.path.join(root, "gpu", "deterministic.nc"), 21)
    clim = xds.open_zarr(paths["climatology"], lazy=True)
    out.update(
        wall_s=stats["wall_s"], chunks=chunks,
        h2d_gib=stats["h2d_bytes"] / 2**30,
        climatology_upload_gib=sum(
            v.size * 4 for v in clim.variables_dict().values()) / 2**30,
        wait_host_s=stats["wait_host_s"],
        wait_device_s=stats["wait_device_s"], launches=launches,
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30)

    # steady state: the same run again (stores in page cache, kernels built)
    dc2, cfgs2 = bench_suite(paths, os.path.join(root, "gpu2"), january)
    stats2 = evaluation.evaluate_with_mesh(dc2, cfgs2,
                                           input_chunks={"init_time": 16})
    out["second_run"] = {k: stats2[k] for k in
                         ("wall_s", "wait_host_s", "wait_device_s")}
    out["profiled_run"] = profiled_run(paths, root, january)

    # the first 16 inits, on the card and on the CPU: three regions, then
    # the thirteen official ones on the same stores
    first16 = slice("2020-01-01", "2020-01-08")
    out["first16"] = card_vs_cpu(paths, root, "first16", first16, None, 2, 1)
    emit("e2e", **out)
    out13 = card_vs_cpu(paths, root, "official13", first16,
                        official_regions(), 2, 1)
    emit("e2e13", **out13)
  return out, out13


def plain_first_init(paths, regions, device="cuda"):
  """MSE/RMSE/MAE/Bias of the first init by the plain versions on the card:
  {variable: (metric, region, lead[, level])} in the suite's metric order."""
  import torch

  from weatherbench2_torch import metrics, ops, xds

  forecast = xds.open_zarr(paths["forecast"], lazy=True)
  truth = xds.open_zarr(paths["truth"], lazy=True)
  lat = np.asarray(forecast.coords_dict()["latitude"].data)
  lon = np.asarray(forecast.coords_dict()["longitude"].data)
  w = metrics._cell_area_from_latitude(np.deg2rad(lat))
  w = (w / w.mean()).astype(np.float32)
  region_w = torch.as_tensor(ops.make_region_weight_matrix(
      w, [r.mask_weights(lat, lon) for r in regions.values()], len(lon)),
      device=device)
  init = np.asarray(forecast.coords_dict()["time"].data)[0]
  leads = np.asarray(forecast.coords_dict()["prediction_timedelta"].data)
  f0 = forecast.isel(time=0)
  t0 = truth.sel(time=init + leads)
  out = {}
  for v in ("geopotential", "2m_temperature"):
    fv = f0[v].transpose(*[d for d in f0[v].dims
                           if d not in ("longitude", "latitude")],
                         "longitude", "latitude")
    tv = t0[v].transpose(*[d for d in t0[v].dims
                           if d not in ("longitude", "latitude")],
                         "longitude", "latitude")
    if [d.replace("time", "prediction_timedelta") for d in tv.dims] != list(
        fv.dims):
      raise AssertionError(f"dims {fv.dims} vs {tv.dims}")
    other = tuple(fv.shape[:-2])
    f = torch.as_tensor(np.asarray(fv.values), device=device).reshape(
        int(np.prod(other)), -1)
    t = torch.as_tensor(np.asarray(tv.values), device=device).reshape(
        int(np.prod(other)), -1)
    sums, wsum, nanw = ops.fused_deterministic_sums_plain(f, t, None,
                                                          region_w)
    means = torch.where(nanw[None] > 0, torch.nan, sums / wsum[None])
    stack = torch.stack([means[1], torch.sqrt(means[1]), means[2], means[0]])
    out[v] = stack.reshape((4, len(regions)) + other).cpu().numpy()
    out[v + "_dims"] = ("metric", "region") + tuple(fv.dims[:-2])
  return out


def e2e025_phase():
  """The deterministic tier at full width: 1440x721, thirteen regions."""
  import torch

  from weatherbench2_torch import evaluation, xds

  regions = official_regions()
  out = {"resolution_degrees": WIDE_RESOLUTION, "inits": 4, "leads": 21,
         "regions": 13,
         "metrics": ["mse", "rmse", "mae", "bias"],
         "cut": "4 inits and no ACC (its hourly climatology store would be "
                "24 GB at this width); the width is the official one"}
  with tempfile.TemporaryDirectory(prefix="wb2_chip_smoke_025_") as root:
    t0 = time.perf_counter()
    paths = write_stores(root, resolution=WIDE_RESOLUTION,
                         forecast_stop="2020-01-03", truth_stop="2020-01-12T18",
                         with_climatology=False, blocks=(4, 1, 0))
    out["write_stores_s"] = time.perf_counter() - t0
    out["store_gib"] = store_gib(paths)
    span = slice("2020-01-01", "2020-01-02T12")

    dc, cfgs = bench_suite(paths, os.path.join(root, "gpu"), span, regions)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = evaluation.evaluate_with_mesh(dc, cfgs,
                                          input_chunks={"init_time": 1})
    chunks = stats["chunks"]
    if chunks != 4:
      raise AssertionError(f"{chunks} chunks, expected 4 inits of one chunk")
    # one launch per variable and chunk, and no ACC: kernel 2 is not run
    launches = read_launches(chunks, 2, 0)
    check_results(os.path.join(root, "gpu", "deterministic.nc"), 21, 13)
    out.update(
        wall_s=stats["wall_s"], chunks=chunks,
        h2d_gib=stats["h2d_bytes"] / 2**30,
        wait_host_s=stats["wait_host_s"],
        wait_device_s=stats["wait_device_s"], launches=launches,
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["profiled_run"] = profiled_run(paths, root, span, regions, chunk=1)

    # the first init alone: the kernels' path against the plain versions
    first = slice("2020-01-01", "2020-01-01T06")
    dc1, cfg1 = bench_suite(paths, os.path.join(root, "first"), first,
                            regions)
    reset_launches()
    s1 = evaluation.evaluate_with_mesh(dc1, cfg1,
                                       input_chunks={"init_time": 1})
    read_launches(s1["chunks"], 2, 0)
    if s1["chunks"] != 1:
      raise AssertionError(f"{s1['chunks']} chunks for one init")
    got = check_results(os.path.join(root, "first", "deterministic.nc"), 21,
                        13)
    names = [str(m) for m in np.asarray(got.coords_dict()["metric"].data)]
    if names != out["metrics"]:
      raise AssertionError(f"metric order {names}")
    want = plain_first_init(paths, regions)
    errs = {}
    for v in ("geopotential", "2m_temperature"):
      dims = tuple("lead_time" if d == "prediction_timedelta" else d
                   for d in want[v + "_dims"])
      g = np.asarray(got[v].transpose(*dims).values, np.float64)
      errs[v] = hold(g, want[v].astype(np.float64),
                     f"kernel path vs plain versions on the card, {v}")
    out["first_init_vs_plain"] = {"errors": errs, "tolerance": E2E_TOLERANCE}
  emit("e2e025", **out)
  return out


def main():
  t_start = time.perf_counter()
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 2
  try:
    from weatherbench2_torch import device as device_lib  # noqa: F401
    from weatherbench2_torch.ops import _build
  except ImportError as err:
    print(f"chip_smoke: run from the repository root ({err})",
          file=sys.stderr)
    return 2

  smi = nvidia_smi()
  emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
       count=torch.cuda.device_count(), torch=torch.__version__,
       cuda=torch.version.cuda, python=sys.version.split()[0])

  t0 = time.perf_counter()
  _build.build(verbose=True)
  emit("build", seconds=time.perf_counter() - t0, source=SOURCE)

  t0 = time.perf_counter()
  cases = kernels_phase()
  t_kernels = time.perf_counter() - t0
  t0 = time.perf_counter()
  e2e, e2e13 = e2e_phase()
  t_e2e = time.perf_counter() - t0
  t0 = time.perf_counter()
  e2e025 = e2e025_phase()
  t_e2e025 = time.perf_counter() - t0

  summary = []
  for name, key, official, replaces in (
      ("fused_deterministic_sums", ("det", "main", False, False),
       ("det", "official", False),
       "weatherbench2_tpu/ops/reductions.py:151"),
      ("fused_region_sums", ("region", "main", False),
       ("region", "official", False),
       "weatherbench2_tpu/ops/reductions.py:366")):
    c = cases[key]
    o = cases[official]
    summary.append({
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": replaces, "launches": e2e["launches"][name],
        "launches_e2e13": e2e13["launches"][name],
        "launches_e2e025": e2e025["launches"][name],
        "max_abs_err": max(v["max_abs_err"] for v in c["errors"].values()),
        "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"], "library_call": c["library_call"],
        "official_shape": o["shape"] + [o["regions"]],
        "official_ms": o["kernel_ms"], "official_bound_ms": o["bound_ms"],
        "official_library_ms": o["library_ms"]})
  emit("times", kernels_s=t_kernels, e2e_s=t_e2e, e2e025_s=t_e2e025,
       total_s=time.perf_counter() - t_start)
  print(json.dumps({"kernels": summary}), flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())

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
           240x121 shapes with the thirteen official regions, at the
           official 0.25-degree shape and at the chunk shapes of the later
           phases (a rank's too, in the batch and in the spatial world),
           without and with NaNs, with
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
           the card on the same stores; then the same four inits in
           lead_time chunks of 7 (three times the launches, equal results);
  e2e_official  the official 1.5-degree configuration through the CLI
           (weatherbench2_torch.cli.evaluate.main): the seven default
           variables at three levels plus 24 h precipitation, a land-sea
           mask in the obs store (sixteen regions), SEEPS, wind vectors;
           `deterministic`, `deterministic_temporal` and
           `deterministic_spatial` in one stream over the first 32 inits of
           January 2020 x 21 leads, launch counters against the prediction;
           the first 16 inits on the card and on the CPU, compared; the
           first chunk's mse (wind vector included) and seeps against plain
           versions run on the card; a run whose process dies after its
           second chunk, resumed from the state file, equal to the
           uninterrupted run bit for bit; the persistence baseline on the
           card and on the CPU;
  e2e_ensemble  the probabilistic suite through the CLI at IFS ENS's width
           (50 members, the seven variables at 500/700/850 hPa, sixteen
           regions, the first 4 inits of January 2020 x 21 leads in chunks
           of 2): three runs (the plan and the per-cell configs; the
           ensemble threshold scores; the Gaussian configs) with launch
           counters against the prediction; the first chunk profiled and
           held against plain versions; the member pass timed; the first
           init on the card and on the CPU on two variables; a seeded rank
           histogram with ties, card against CPU; run 1 killed after its
           first chunk and resumed bit for bit;
  e2e_derived   three runs at full width: (1) the official configuration
           of e2e_official with `--derived_variables=wind_speed,
           10m_wind_speed` (the 10 m winds and the derived variables'
           climatology rows added to the stores), launch counters against
           the prediction, the first 16 inits card against CPU, the first
           chunk's wind_speed mse and ACC against plain versions; (2) the
           probabilistic-climatology baseline of 1990-2019 (30 members,
           the seven variables, sixteen regions, hour interval 6) with
           `probabilistic` and `probabilistic_spatial` over the first 4
           inits in chunks of 2, the fair CRPS and spread/skill of
           independent N(0, 1) members and truth against their closed
           forms, the first init card against CPU on two variables; (3) at
           1440x721 over the first week of 2020: compute_derived_variables
           with its default list, then compute_zonal_energy_spectrum of the
           official thirteen variables, time-averaged; the first day card
           against CPU for both CLIs, the week's blocks against the day's
           run, Parseval, and cuFFT's time beside its byte bound;
  e2e_prep the three data-prep twins of regridding, quantiles and
           climatology at full width: (1) regrid of e2e_derived run 3's
           0.25-degree store to WB2's 1.5-degree grid (conservative; then
           bilinear and nearest on 2m_temperature), the first time block
           card against CPU, the area-weighted mean kept, a target cell
           without valid data NaN; (2) compute_quantiles of a 1.5-degree
           year (2m_temperature, geopotential at 13 levels), a latitude
           band against np.nanquantile; (3) compute_climatology with the
           official settings (1990-2019, 6-hourly, 61-day window; mean,
           std, SEEPS, quantiles) of 2m_temperature and 24 h
           precipitation, one longitude card against CPU; each run's wall,
           host share, bytes read and moved, peak memory, and the library
           calls' CUDA-event times beside their bounds;
  e2e_prep2 the nine remaining data-prep twins at full width: on a
           1.5-degree year of 2020 (2 m temperature, 24 h precipitation,
           geopotential and temperature at 13 levels) compute_averages over
           latitude and longitude and compute_statistical_moments (kernel
           2, launch counters against the prediction), resample_in_time
           (weekly) and resample_daily; compute_ensemble_mean of a
           50-member ensemble at e2e_ensemble's width; slice_dataset at
           0.25 degrees, the latitude reversed and made increasing again;
           index_on_valid_time of e2e_official's forecast and
           expand_climatology of its climatology; the probabilistic
           climatological forecasts of 1 January 2020 from 1990-2019 (30
           members, 15-day leads); each twin card against --device=cpu
           (within the tolerance, or bit for bit where it only gathers),
           with its wall, host and copy shares, bytes read and moved;
  e2e_multi the multi-rank engine and the bfloat16 transfer mode: (1)
           e2e_official's configuration through the CLI without a mesh;
           (2) the same as two gloo ranks sharing the card
           (parallel.mesh.run_ranks), within the tolerance, every rank's
           bytes read and moved, host wait and kernel launches against the
           prediction; (3) a 1 x 2 batch x spatial world on WB2's 64 x 32
           grid (the official configs and a 10-member ensemble's spread
           and skill) against one device and against the CPU (the kernels
           phase holds both kernels to their plain versions at its band
           shapes), and the 121 latitudes of 1.5 degrees refused; (4) a
           2-rank run whose rank 0 dies after its second state file; (5) a world of one on the
           card (NCCL, --n_devices=1): step 1 again, equal bit for bit,
           then the killed run resumed as one rank; (6)
           WB2_TRANSFER_DTYPE=bfloat16 on step 1's configuration, h2d bytes
           and the deviation from float32 per metric, card against CPU on
           8 inits; (7) visualization's relative metrics and spread/skill
           on card-resident results against the host, and the plots'
           named ImportError without matplotlib.

The last lines are the kernel summary, the nvidia-smi name and power
limit, and {"ok": true, "device": {...}}.
"""
import json
import os
import shutil
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


def averages_weights(n_lon, n_lat):
  """compute_averages' two regions over (longitude, latitude) cells: the
  latitude weights (mean 1) and ones."""
  from weatherbench2_torch import metrics

  lat = np.linspace(-90, 90, n_lat)
  w = metrics._cell_area_from_latitude(np.deg2rad(lat))
  w = w / w.mean()
  return np.stack([np.broadcast_to(w, (n_lon, n_lat)).ravel(),
                   np.ones(n_lon * n_lat)]).astype(np.float32)


def band_weights(n_lon, n_lat, n_regions, bands=2):
  """``region_weights`` of the whole grid cut to its first latitude band
  of ``bands`` (cells run longitude-major), as a rank of the spatial axis
  holds them."""
  w = region_weights(n_lon, n_lat, n_regions).reshape(n_regions, n_lon,
                                                       n_lat)
  return np.ascontiguousarray(w[:, :, :n_lat // bands]).reshape(
      n_regions, -1)


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
                float64=False, weights=None):
  """One kernel at one shape against its plain version; timings.  The
  region weights are ``weights`` ((R, cells), a data-prep twin's) or
  ``region_weights``'."""
  import torch

  from weatherbench2_torch.ops import reductions

  rows, cols = shape
  w = torch.as_tensor(region_weights(*grid, n_regions) if weights is None
                      else weights, device="cuda")
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
  for n_regions in (1, 2, 4, 5, 8, 9, 13, 16):
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
       regions=[1, 2, 4, 5, 8, 9, 13, 16], tolerance=TOLERANCE,
       layouts=[name for name, _, _ in layouts])


def infinite_cases(gen):
  """Infinite inputs and squares that overflow, through every core.

  Every core and the plain version must put +inf, -inf and NaN in the same
  places (an infinity times a zero weight is NaN in all of them; the
  tensor-core core's nonfinite_fixup gives back what its split loses) and
  agree, within the tolerance, on the rest: the rows without such values.
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
          for test in (torch.isposinf, torch.isneginf, torch.isnan):
            if not torch.equal(test(g), test(p)):
              raise AssertionError(
                  f"{name} R={n_regions} core={which}: {out} differs from "
                  f"the plain version in {test.__name__}")
          zero = torch.zeros_like(p)
          compare([torch.where(finite, g, zero)],
                  [torch.where(finite, p, zero)],
                  [torch.where(finite, sc, zero)], [out])
        count += 1
  emit("kernels", infinite_cases=count, regions=[3, 13],
       check="+inf, -inf and NaN exactly where the plain version has them; "
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
  # the shapes of one 16-init chunk of the official 1.5-degree config with
  # its sixteen regions (e2e_official): kernel 1 on a three-level and on a
  # surface variable; kernel 2 on mse's rows (18 variable-levels and 3
  # wind-vector levels), on one of ACC's two row groups and on SEEPS's rows
  # (NaN cells where the p1 mask bites)
  for rows in (1008, 336):
    cases[("det", "official16", rows)] = kernel_case(
        "fused_deterministic_sums", (rows, 240 * 121), 16, bench, False,
        False, gen)
  for rows, nans in ((7056, False), (9072, False), (336, True)):
    cases[("region", "official16", rows)] = kernel_case(
        "fused_region_sums", (rows, 240 * 121), 16, bench, nans, None, gen)
  # a rank's share of that chunk in e2e_multi's 2-rank world (8 of the 16
  # inits): half the rows of each shape but ACC's, whose 8 inits are one
  # group of 9072 rows, timed above
  for rows in (504, 168):
    cases[("det", "multi8", rows)] = kernel_case(
        "fused_deterministic_sums", (rows, 240 * 121), 16, bench, False,
        False, gen)
  for rows, nans in ((3528, False), (168, True)):
    cases[("region", "multi8", rows)] = kernel_case(
        "fused_region_sums", (rows, 240 * 121), 16, bench, nans, None, gen)
  # a rank's latitude band in e2e_multi's 1 x 2 batch x spatial world on
  # the 64 x 32 grid (the 16 inits of a chunk, 16 of the 32 latitudes): the
  # shapes that world's rank launches, ACC's two row groups in one, SEEPS
  # with NaN cells; the full grid's weights cut to the band
  band = band_weights(*GRID64, 16)
  for rows in SPATIAL_DET_ROWS:
    cases[("det", "spatial16", rows)] = kernel_case(
        "fused_deterministic_sums", (rows, band.shape[1]), 16, GRID64,
        False, False, gen, weights=band)
  for rows, nans in SPATIAL_REGION_ROWS:
    cases[("region", "spatial16", rows)] = kernel_case(
        "fused_region_sums", (rows, band.shape[1]), 16, GRID64, nans, None,
        gen, weights=band)
  # the shapes of one 2-init chunk of the 50-member ensemble (e2e_ensemble)
  # with its sixteen regions: kernel 2 on the probabilistic plan's five
  # fields of a three-level variable (5 x 2 x 21 x 3 rows) and of a surface
  # variable (5 x 2 x 21), and on the pointwise tier's largest matrix, the
  # ignorance score's rows with their +inf indicator rows (2 x 2 thresholds
  # x 2 inits x 21 leads x 17 variable-levels)
  for rows in ENSEMBLE_ROWS:
    cases[("region", "ensemble16", rows)] = kernel_case(
        "fused_region_sums", (rows, 240 * 121), 16, bench, False, None, gen)
  # the official chunk with the two derived variables (e2e_derived run 1):
  # ACC's row groups that the official chunk does not have
  for rows in DERIVED_ROWS:
    cases[("region", "derived16", rows)] = kernel_case(
        "fused_region_sums", (rows, 240 * 121), 16, bench, False, None, gen)
  # e2e_prep2's shapes: compute_averages' (latitude weights over the cells,
  # ones) and compute_statistical_moments' (ones) rows of one time block of
  # a 13-level and of a surface variable, with NaN cells
  for rows in PREP2_AVERAGE_ROWS:
    cases[("region", "averages", rows)] = kernel_case(
        "fused_region_sums", (rows, PREP2_CELLS), 2, bench, True, None, gen,
        weights=averages_weights(*bench))
  for rows in PREP2_MOMENT_ROWS:
    cases[("region", "moments", rows)] = kernel_case(
        "fused_region_sums", (rows, PREP2_CELLS), 1, bench, True, None, gen,
        weights=np.ones((1, PREP2_CELLS), np.float32))
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


def profiled(run):
  """`run()` (an entry point that returns the engine's counts) under
  torch.profiler: device time by kind, and the device's busy share of the
  wall (kernels and copies on either stream)."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    stats = run()
    torch.cuda.synchronize()
  # key_averages() has a row per operator (device time of the kernels it
  # launched) and a row per kernel: sum the kernel rows only, and name the
  # largest operators
  kernels, operators = {}, {}
  for e in prof.key_averages():
    us = getattr(e, "self_device_time_total", 0) or 0
    if us > 0:
      on_device = e.device_type == torch.autograd.DeviceType.CUDA
      (kernels if on_device else operators)[e.key] = us
  copy_us = sum(v for k, v in kernels.items() if k.lower().startswith(
      ("memcpy", "memset")))
  kernel_us = sum(kernels.values()) - copy_us
  own_us = sum(v for k, v in kernels.items()
               if any(s in k for s in ("pass1_", "pass2", "nonfinite_fixup")))
  top = sorted(operators.items(), key=lambda kv: -kv[1])[:8]
  return {
      "wall_s": stats["wall_s"],
      "device_kernel_s": kernel_us / 1e6,
      "device_copy_s": copy_us / 1e6,
      "reduction_kernels_s": own_us / 1e6,
      "kernel_busy_share": kernel_us / 1e6 / stats["wall_s"],
      "top_device_operators_ms": {k: v / 1e3 for k, v in top},
  }


def profiled_run(paths, root, time_slice, regions=None, chunk=16):
  """The bench suite once more, under the profiler."""
  from weatherbench2_torch import evaluation

  dc, cfgs = bench_suite(paths, os.path.join(root, "profiled"), time_slice,
                         regions)
  return profiled(lambda: evaluation.evaluate_with_mesh(
      dc, cfgs, input_chunks={"init_time": chunk}))


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
  """Errors of got against want; raises past E2E_TOLERANCE.  NaNs (the
  rows of a metric that has no such variable) must be in the same places."""
  nan = np.isnan(want)
  if not np.array_equal(np.isnan(got), nan):
    raise AssertionError(f"{what}: NaNs in other places")
  if nan.all():
    return {"max_abs_err": 0.0, "max_err_over_bound": 0.0}
  err = np.abs(got - want)[~nan]
  bound = (RTOL * np.abs(want) + RTOL * np.nanmax(np.abs(want)))[~nan]
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

    # the same four inits with the lead axis in chunks of 7: three slices,
    # each with accumulators of its own, results concatenated
    dcl, cfgl = bench_suite(paths, os.path.join(root, "lead7"), span, regions)
    reset_launches()
    sl = evaluation.evaluate_with_mesh(
        dcl, cfgl, input_chunks={"init_time": 1, "lead_time": 7})
    if sl["chunks"] != 3 * chunks:
      raise AssertionError(f"{sl['chunks']} chunks in lead_time chunks of 7")
    lead_launches = read_launches(sl["chunks"], 2, 0)
    whole = check_results(os.path.join(root, "gpu", "deterministic.nc"), 21,
                          13)
    sliced = check_results(os.path.join(root, "lead7", "deterministic.nc"),
                           21, 13)
    out["lead_chunks_of_7"] = {
        "wall_s": sl["wall_s"], "chunks": sl["chunks"],
        "launches": lead_launches, "tolerance": E2E_TOLERANCE,
        "errors": {k: hold(
            np.asarray(sliced[k].transpose(*whole[k].dims).values,
                       np.float64),
            np.asarray(whole[k].values, np.float64),
            f"lead_time chunks vs unchunked, {k}") for k in whole.keys()}}
  emit("e2e025", **out)
  return out


# -- e2e_official -------------------------------------------------------------------

VARIABLES_3D = ("geopotential", "temperature", "u_component_of_wind",
                "v_component_of_wind", "specific_humidity")
VARIABLES_2D = ("2m_temperature", "mean_sea_level_pressure")
PRECIP = "total_precipitation_24hr"
OFFICIAL_INITS = 32
# launches per 16-init chunk of the three configs in one stream, written
# down in PERF.md before the first run: kernel 1 once per variable (8) for
# bias/mae of `deterministic` and again of `deterministic_temporal`; kernel
# 2 for mse (1 group), ACC (2 groups under the 1 GiB cap) and SEEPS (1) of
# each, and for the temporal config's rmse (1)
OFFICIAL_LAUNCHES = (16, 9)
# the `deterministic` config alone, in chunks of 16 inits and of 8 (where
# ACC's rows, 0.53 GB, fit one group)
DETERMINISTIC_LAUNCHES = (8, 4)
DETERMINISTIC_LAUNCHES_8 = (8, 3)


def write_official_stores(root, extra_2d=(), clim_3d=(), clim_2d=(),
                          resolution=1.5, latitudes=None):
  """The official 1.5-degree configuration's stores, from the seed: the
  CLI's seven default variables at 500/700/850 hPa and 24 h precipitation
  (non-negative, half of it dry); 32 12-hourly inits x 21 leads; 6-hourly
  truth with a land_sea_mask; an hourly climatology at 6-hour steps with
  the SEEPS threshold and dry fraction (the fraction is uniform over (0, 1)
  from cell to cell, so the p1 mask bites).  The climatology's later
  quarters of the year repeat the values of the first: only its size has
  to be real, and a quarter of the random draws is enough.  ``extra_2d``
  adds surface variables to all three stores, ``clim_3d``/``clim_2d`` rows
  to the climatology alone (the derived variables').  ``resolution`` and
  ``latitudes`` (a grid without poles) give another grid."""
  from weatherbench2_torch import schema, xds

  specs = dict(variables_3d=list(VARIABLES_3D),
               variables_2d=list(VARIABLES_2D) + [PRECIP] + list(extra_2d),
               levels=(500, 700, 850),
               spatial_resolution_in_degrees=resolution)
  truth = schema.mock_truth_data(time_start="2020-01-01",
                                 time_stop="2020-01-27",
                                 time_resolution="6 hours", **specs)
  forecast = schema.mock_forecast_data(
      time_start="2020-01-01", time_stop="2020-01-17",
      time_resolution="12 hours", lead_start="0 days", lead_stop="10 days",
      lead_resolution="12 hours", **specs)
  clim = schema.mock_hourly_climatology_data(hour_interval=6, **dict(
      specs, variables_3d=specs["variables_3d"] + list(clim_3d),
      variables_2d=specs["variables_2d"] + list(clim_2d)))
  if latitudes is not None:
    truth, forecast, clim = (
        ds.isel(latitude=slice(0, len(latitudes))).assign_coords(
            latitude=np.asarray(latitudes)) for ds in (truth, forecast, clim))
  n_lon, n_lat = truth.sizes["longitude"], truth.sizes["latitude"]
  rng = np.random.default_rng(SEED + 1)
  dry_fraction = rng.random((n_lon, n_lat), dtype=np.float32)

  def values(name, shape, cache):
    if name in cache and cache[name].shape == tuple(shape):
      return cache[name]
    if name.endswith("_seeps_dry_fraction"):
      out = np.broadcast_to(dry_fraction, shape)
    elif name.endswith("_seeps_threshold"):
      out = 5e-4 + 2.5e-3 * rng.random(shape, dtype=np.float32)
    else:
      out = rng.standard_normal(shape, dtype=np.float32)
      if name == PRECIP:
        out = np.maximum(out, 0) * np.float32(2e-3)
    cache[name] = out
    return out

  clim_dims = ("dayofyear", "hour", "longitude", "latitude")
  clim_sizes = {**clim.sizes}
  clim_vars = dict(clim.variables_dict())
  for suffix in ("_seeps_threshold", "_seeps_dry_fraction"):
    clim_vars[PRECIP + suffix] = xds.stub_variable(clim_dims, clim_sizes,
                                                   np.float32)
  paths = {}
  for name, ds_vars, coords, dim, block, chunks, reuse in (
      ("truth", truth.variables_dict(), truth.coords_dict(), "time", 54,
       {"time": 54}, False),
      ("forecast", forecast.variables_dict(), forecast.coords_dict(), "time",
       16, {"time": 16, "prediction_timedelta": -1}, False),
      ("climatology", clim_vars, clim.coords_dict(), "dayofyear", 92,
       {"dayofyear": 92}, True)):
    path = os.path.join(root, f"{name}.zarr")
    template = xds.Dataset(
        {k: xds.stub_variable(v.dims, v.sizes, np.float32)
         for k, v in ds_vars.items()}, coords=dict(coords))
    if name == "truth":
      template["land_sea_mask"] = xds.stub_variable(
          ("longitude", "latitude"), template.sizes, np.float32)
    writer = xds.RegionWriter(path, template, chunks=chunks)
    if name == "truth":
      writer.write_array("land_sea_mask", (slice(None), slice(None)),
                         rng.random((n_lon, n_lat), dtype=np.float32))
    n = template.sizes[dim]
    cache = {}
    for start in range(0, n, block):
      sl = slice(start, min(start + block, n))
      if not reuse:
        cache = {}
      for vname, v in ds_vars.items():
        shape = [sl.stop - sl.start if d == dim else v.sizes[d]
                 for d in v.dims]
        writer.write_array(
            vname, tuple(sl if d == dim else slice(None) for d in v.dims),
            values(vname, shape, cache))
    writer.finish()
    paths[name] = path
  return paths


def official_args(paths, out_dir, stop, *more):
  """The CLI's arguments for the official configuration over the stores."""
  return [
      f"--forecast_path={paths['forecast']}", f"--obs_path={paths['truth']}",
      f"--climatology_path={paths['climatology']}",
      f"--output_dir={out_dir}",
      "--variables=" + ",".join(VARIABLES_3D + VARIABLES_2D + (PRECIP,)),
      "--time_start=2020-01-01", f"--time_stop={stop}", "--regions=all",
      "--compute_seeps", "--use_mesh", *more]


OFFICIAL_CONFIGS = "deterministic,deterministic_temporal,deterministic_spatial"
DETERMINISTIC_METRICS = ["mse", "acc", "bias", "mae", "seeps_24hr"]


def open_official_results(out_dir, n_inits, grid=(240, 121), extra_3d=(),
                          extra_2d=()):
  """The three configs' results, checked: shapes, sixteen regions, the
  wind_vector variable, and finite values exactly where a metric has the
  variable (mse: all; acc/bias/mae: all but wind_vector; SEEPS:
  precipitation only).  ``extra_3d``/``extra_2d`` name more variables (the
  derived ones and their bases)."""
  from weatherbench2_torch import xds

  levels = {v: (3,) for v in VARIABLES_3D + ("wind_vector",) + extra_3d}
  names = (VARIABLES_3D + VARIABLES_2D + (PRECIP, "wind_vector") + extra_3d
           + extra_2d)
  results = {
      "deterministic": xds.open_netcdf(
          os.path.join(out_dir, "deterministic.nc")),
      "deterministic_temporal": xds.open_netcdf(
          os.path.join(out_dir, "deterministic_temporal.nc")),
      "deterministic_spatial": xds.open_zarr(
          os.path.join(out_dir, "deterministic_spatial.zarr"))}
  for cname, ds in results.items():
    metrics = [str(m) for m in np.asarray(ds.coords_dict()["metric"].data)]
    spatial = cname == "deterministic_spatial"
    want_metrics = (["bias", "mse", "mae", "seeps_24hr"] if spatial else
                    DETERMINISTIC_METRICS + (
                        ["rmse_sqrt_before_time_avg"]
                        if cname == "deterministic_temporal" else []))
    if metrics != want_metrics:
      raise AssertionError(f"{cname}: metrics {metrics}")
    want_vars = set(names) - ({"wind_vector"} if spatial else set())
    if set(ds.keys()) != want_vars:
      raise AssertionError(f"{cname}: variables {sorted(ds.keys())}")
    if not spatial and list(np.asarray(
        ds.coords_dict()["region"].data))[13:] != [
            "global_land", "extra-tropics_land", "tropics_land"]:
      raise AssertionError(f"{cname}: regions "
                           f"{ds.coords_dict()['region'].data}")
    for v in ds.keys():
      sizes = {"metric": len(metrics), "lead_time": 21}
      if v in levels:
        sizes["level"] = 3
      if spatial:
        sizes.update(longitude=grid[0], latitude=grid[1])
      else:
        sizes["region"] = 16
      if cname == "deterministic_temporal":
        sizes["init_time"] = n_inits
      if ds[v].sizes != sizes:
        raise AssertionError(f"{cname}/{v}: sizes {ds[v].sizes}, expected "
                             f"{sizes}")
      for i, m in enumerate(metrics):
        vals = ds[v].isel(metric=i).values
        has = (v == PRECIP if m == "seeps_24hr" else
               v != "wind_vector" or m in ("mse", "rmse_sqrt_before_time_avg"))
        if spatial and m == "seeps_24hr" and has:
          # per cell: NaN exactly outside the p1 mask
          if not 0.1 < np.isnan(vals).mean() < 0.5:
            raise AssertionError(f"{cname}: SEEPS NaN share "
                                 f"{np.isnan(vals).mean()}")
        elif np.isfinite(vals).all() != has or (
            not has and not np.isnan(vals).all()):
          raise AssertionError(f"{cname}/{v}/{m}: finite where it should "
                               "not be, or the reverse")
  return results


def compare_results(got, want, what):
  """{config/variable: errors} of one run's results against another's."""
  errs = {}
  for cname in want:
    for k in want[cname].keys():
      w = np.asarray(want[cname][k].values, np.float64)
      g = np.asarray(got[cname][k].transpose(*want[cname][k].dims).values,
                     np.float64)
      errs[f"{cname}/{k}"] = hold(g, w, f"{what}, {cname}/{k}")
  worst = max(errs.values(), key=lambda e: e["max_err_over_bound"])
  return {"compared": len(errs), "worst": worst}


def plain_official_first_chunk(paths, regions, n_inits=16,
                               device="cuda"):
  """mse (wind vector included) and SEEPS of the first `n_inits` inits by
  plain PyTorch on the card, written independently of the package's
  metrics: {variable: (region, lead[, level])}, and the SEEPS array."""
  import torch

  from weatherbench2_torch import metrics, ops, xds

  forecast = xds.open_zarr(paths["forecast"], lazy=True)
  truth = xds.open_zarr(paths["truth"], lazy=True)
  clim = xds.open_zarr(paths["climatology"], lazy=True)
  lat = np.asarray(forecast.coords_dict()["latitude"].data)
  lon = np.asarray(forecast.coords_dict()["longitude"].data)
  w = metrics._cell_area_from_latitude(np.deg2rad(lat))
  w = (w / w.mean()).astype(np.float32)
  region_w = torch.as_tensor(ops.make_region_weight_matrix(
      w, [r.mask_weights(lat, lon) for r in regions.values()], len(lon)),
      device=device)
  inits = np.asarray(forecast.coords_dict()["time"].data)[:n_inits]
  leads = np.asarray(forecast.coords_dict()["prediction_timedelta"].data)
  valid = leads[:, None] + inits[None, :]  # (lead, init), as the store
  truth_times = np.asarray(truth.coords_dict()["time"].data)
  t_index = np.searchsorted(truth_times, valid)
  if not np.array_equal(truth_times[t_index], valid):
    raise AssertionError("valid times missing from the truth store")

  def on_card(ds, name, index):
    """(lead, init, [level,] lon, lat) values as a tensor."""
    v = ds[name]
    if index is None:
      arr = np.asarray(v.isel(time=slice(0, n_inits)).values)
    else:
      arr = np.asarray(v.values)[index]
    return torch.as_tensor(arr, device=device)

  def region_means(field, skip_nan=False):
    """Weighted regional means of (lead, init, [level,] lon, lat)."""
    other = tuple(field.shape[:-2])
    sums, wsum, nanw = ops.fused_region_sums_plain(
        field.reshape(int(np.prod(other)), -1), region_w)
    means = sums / wsum
    if not skip_nan:
      means = torch.where(nanw > 0, torch.nan, means)
    return means.reshape((len(regions),) + other)

  out, squares = {}, {}
  for name in VARIABLES_3D + VARIABLES_2D + (PRECIP,):
    dims = forecast[name].dims
    if dims[:2] != ("prediction_timedelta", "time") or dims[-2:] != (
        "longitude", "latitude"):
      raise AssertionError(f"{name}: dims {dims}")
    f = on_card(forecast, name, None)
    t = on_card(truth, name, t_index)
    sq = (f - t) ** 2
    if name in ("u_component_of_wind", "v_component_of_wind"):
      squares[name] = sq
    out[name] = region_means(sq).mean(dim=2).cpu().numpy()  # over inits
  out["wind_vector"] = region_means(
      squares["u_component_of_wind"] + squares["v_component_of_wind"]).mean(
          dim=2).cpu().numpy()

  # SEEPS: categories 0 dry, 1 light, 2 heavy; the score is half the entry
  # of the 3x3 matrix of the cell's dry fraction p1
  f = on_card(forecast, PRECIP, None)
  t = on_card(truth, PRECIP, t_index)
  days = valid.astype("datetime64[D]")
  doy = (days - valid.astype("datetime64[Y]")).astype(np.int64)
  hour = (valid.astype("datetime64[h]") - days).astype(np.int64)
  hours = np.asarray(clim.coords_dict()["hour"].data)
  thr = clim[PRECIP + "_seeps_threshold"]
  if thr.dims != ("dayofyear", "hour", "longitude", "latitude"):
    raise AssertionError(f"threshold dims {thr.dims}")
  n_doy = int(doy.max()) + 1
  wet = torch.as_tensor(
      np.asarray(thr.isel(dayofyear=slice(0, n_doy)).values)[
          doy, np.searchsorted(hours, hour)], device=device)
  p1 = torch.as_tensor(np.asarray(
      clim[PRECIP + "_seeps_dry_fraction"].values).mean(axis=(0, 1)),
      device=device)
  dry = 0.25 / 1000.0

  def category(x):
    cat = torch.full(x.shape, -1, dtype=torch.long, device=device)
    cat[x < dry] = 0
    cat[(x > dry) & (x < wet)] = 1
    cat[x >= wet] = 2
    return cat

  zero = torch.zeros_like(p1)
  matrix = 0.5 * torch.stack([
      torch.stack([zero, 1 / (1 - p1), 4 / (1 - p1)]),
      torch.stack([1 / p1, zero, 3 / (1 - p1)]),
      torch.stack([1 / p1 + 3 / (2 + p1), 3 / (2 + p1), zero])])
  fc, tc = category(f), category(t)
  if int((fc < 0).sum()) or int((tc < 0).sum()):
    raise AssertionError("a precipitation value is in no SEEPS category")
  lon_i = torch.arange(len(lon), device=device)[:, None]
  lat_i = torch.arange(len(lat), device=device)[None, :]
  score = matrix[fc, tc, lon_i, lat_i]
  score = torch.where((p1 > 0.1) & (p1 < 0.85), score, torch.nan)
  seeps = region_means(score, skip_nan=True).mean(dim=2).cpu().numpy()
  return out, seeps


def run_cli(args, expect_chunks, per_chunk):
  """One CLI run on the card with the launch counters read around it."""
  import torch

  from weatherbench2_torch.cli import evaluate as cli

  from weatherbench2_torch.xds import io_zarr

  reset_launches()
  io_zarr.READS.reset()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  stats = cli.main(args)
  if stats["chunks"] != expect_chunks:
    raise AssertionError(f"{stats['chunks']} chunks, expected "
                         f"{expect_chunks}")
  launches = read_launches(stats["chunks"], *per_chunk)
  return {"wall_s": stats["wall_s"], "chunks": stats["chunks"],
          "h2d_gib": stats["h2d_bytes"] / 2**30,
          "read_gib": io_zarr.READS.bytes / 2**30,
          "wait_host_s": stats["wait_host_s"],
          "wait_host_share": stats["wait_host_s"] / stats["wall_s"],
          "wait_device_s": stats["wait_device_s"],
          "finalize_s": stats["finalize_s"], "write_s": stats["write_s"],
          "launches": launches,
          "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}


_DYING_CHILD = """
import os, sys
sys.path.insert(0, {repo!r})
real = os.replace
states = []
def replace(src, dst):
  real(src, dst)
  if dst.startswith({ckpt!r}):
    states.append(dst)
    if len(states) == {snapshots}:
      os._exit(9)  # the process dies here, with no clean-up at all
os.replace = replace
from weatherbench2_torch.cli import evaluate
evaluate.main({argv!r})
"""


def dying_child(argv, ckpt, snapshots):
  """The CLI in a child process that dies right after its n-th state file
  is in place (checkpoint_every=1: after chunk n); its wall in seconds."""
  t0 = time.perf_counter()
  child = subprocess.run(
      [sys.executable, "-c", _DYING_CHILD.format(
          repo=os.path.dirname(os.path.abspath(__file__)), ckpt=ckpt,
          snapshots=snapshots, argv=argv)],
      capture_output=True, text=True, timeout=600)
  if child.returncode != 9:
    raise AssertionError(f"the child ended with {child.returncode}: "
                         f"{child.stderr[-2000:]}")
  return time.perf_counter() - t0


def kill_and_resume(paths, root):
  """The `deterministic` config in chunks of 8 inits: a child process dies
  right after the state of its second chunk is in place; a second call
  resumes from that file and must equal the uninterrupted run exactly."""
  from weatherbench2_torch import xds
  from weatherbench2_torch.parallel import streaming

  more = ("--eval_configs=deterministic", "--input_chunks=init_time=8")
  whole = run_cli(official_args(paths, os.path.join(root, "whole"),
                                "2020-01-16", *more),
                  OFFICIAL_INITS // 8, DETERMINISTIC_LAUNCHES_8)
  ckpt = os.path.join(root, "state")
  state_file = ckpt + ".deterministic"
  argv = official_args(paths, os.path.join(root, "killed"), "2020-01-16",
                       *more, f"--checkpoint_path={ckpt}",
                       "--checkpoint_every=1")
  child_s = dying_child(argv, ckpt, 2)
  if os.path.exists(os.path.join(root, "killed", "deterministic.nc")):
    raise AssertionError("the killed run wrote its results")
  kept = state_file + ".after_chunk_2"
  shutil.copy(state_file, kept)
  state = streaming.StreamingState.load(kept)
  if (state.chunk_index, state.chunk_size, state.total) != (
      2, 8, OFFICIAL_INITS):
    raise AssertionError(f"state at chunk {state.chunk_index} of "
                         f"{state.chunk_size} in {state.total}")
  resumed = run_cli(official_args(paths, os.path.join(root, "resumed"),
                                  "2020-01-16", *more,
                                  f"--checkpoint_path={ckpt}",
                                  "--checkpoint_every=1"),
                    OFFICIAL_INITS // 8 - 2, DETERMINISTIC_LAUNCHES_8)
  a = xds.open_netcdf(os.path.join(root, "whole", "deterministic.nc"))
  b = xds.open_netcdf(os.path.join(root, "resumed", "deterministic.nc"))
  if list(a.keys()) != list(b.keys()):
    raise AssertionError("the resumed run's variables differ")
  for k in a.keys():
    if not np.array_equal(a[k].values, b[k].values, equal_nan=True):
      raise AssertionError(f"resumed run differs from the uninterrupted "
                           f"one in {k}")
  return {"uninterrupted": whole, "child_process_s": child_s,
          "state_kept": {"chunk_index": state.chunk_index,
                         "bytes": os.path.getsize(kept)},
          "resumed": resumed, "results_bit_identical": True,
          "variables_compared": len(list(a.keys()))}


def e2e_official_phase():
  """The official 1.5-degree configuration through the CLI."""
  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import evaluate as cli

  out = {"resolution_degrees": 1.5, "inits": OFFICIAL_INITS, "leads": 21,
         "regions": 16, "configs": OFFICIAL_CONFIGS.split(","),
         "cut": "the first 32 inits of January 2020 (the month has 62): "
                "the whole month would add more than two minutes with the "
                "runs on the CPU",
         "predicted_launches_per_chunk": dict(zip(
             ("fused_deterministic_sums", "fused_region_sums"),
             OFFICIAL_LAUNCHES))}
  with tempfile.TemporaryDirectory(prefix="wb2_chip_smoke_official_") as root:
    t0 = time.perf_counter()
    paths = write_official_stores(root)
    out["write_stores_s"] = time.perf_counter() - t0
    out["store_gib"] = store_gib(paths)
    configs = f"--eval_configs={OFFICIAL_CONFIGS}"

    # the main path: the CLI, three configs in one stream, counters around
    main_dir = os.path.join(root, "main")
    out["main"] = run_cli(
        official_args(paths, main_dir, "2020-01-16", configs,
                      "--input_chunks=init_time=16"),
        OFFICIAL_INITS // 16, OFFICIAL_LAUNCHES)
    open_official_results(main_dir, OFFICIAL_INITS)

    # the first 16 inits (one chunk) on the card and on the CPU
    first = {}
    for dev in ("cuda", "cpu"):
      dev_dir = os.path.join(root, f"first16_{dev}")
      args = official_args(paths, dev_dir, "2020-01-08", configs,
                           "--input_chunks=init_time=16")
      if dev == "cuda":
        out["first16_card"] = run_cli(args, 1, OFFICIAL_LAUNCHES)
      else:
        reset_launches()
        stats = cli.main(args + ["--device=cpu"])
        read_launches(stats["chunks"], 0, 0)
        out["first16_cpu_wall_s"] = stats["wall_s"]
      first[dev] = open_official_results(dev_dir, 16)
    out["first16_card_vs_cpu"] = {
        **compare_results(first["cuda"], first["cpu"], "card vs CPU"),
        "tolerance": E2E_TOLERANCE}

    out["first16_profiled"] = profiled(lambda: cli.main(official_args(
        paths, os.path.join(root, "first16_profiled"), "2020-01-08", configs,
        "--input_chunks=init_time=16")))

    # the first chunk's mse and SEEPS against plain versions on the card
    mask = xds.open_zarr(paths["truth"])["land_sea_mask"]
    want_mse, want_seeps = plain_official_first_chunk(
        paths, cli.predefined_regions_dict(mask))
    det = first["cuda"]["deterministic"]
    errs = {}
    for v, want in want_mse.items():
      dims = ("region", "lead_time") + (("level",) if want.ndim == 3 else ())
      got = det[v].isel(metric=DETERMINISTIC_METRICS.index("mse"))
      errs[f"mse/{v}"] = hold(
          np.asarray(got.transpose(*dims).values, np.float64),
          want.astype(np.float64), f"mse of {v} vs its plain version")
    got = det[PRECIP].isel(metric=DETERMINISTIC_METRICS.index("seeps_24hr"))
    errs["seeps_24hr"] = hold(
        np.asarray(got.transpose("region", "lead_time").values, np.float64),
        want_seeps.astype(np.float64), "SEEPS vs its plain version")
    out["first_chunk_vs_plain"] = {"errors": errs, "tolerance": E2E_TOLERANCE}

    out["kill_and_resume"] = kill_and_resume(paths, root)

    # the persistence baseline, first 16 inits, card against CPU
    persistence = {}
    for dev in ("cuda", "cpu"):
      dev_dir = os.path.join(root, f"persistence_{dev}")
      args = official_args(paths, dev_dir, "2020-01-08",
                           "--eval_configs=deterministic",
                           "--evaluate_persistence",
                           "--input_chunks=init_time=16")
      if dev == "cuda":
        out["persistence_card"] = run_cli(args, 1, DETERMINISTIC_LAUNCHES)
      else:
        cli.main(args + ["--device=cpu"])
      persistence[dev] = {"deterministic": xds.open_netcdf(
          os.path.join(dev_dir, "deterministic.nc"))}
    zero = persistence["cuda"]["deterministic"]["geopotential"].isel(
        metric=0, lead_time=0).values
    if not (zero == 0).all():
      raise AssertionError("persistence at lead 0 is not the truth")
    out["persistence_card_vs_cpu"] = {
        **compare_results(persistence["cuda"], persistence["cpu"],
                          "persistence, card vs CPU"),
        "tolerance": E2E_TOLERANCE}
  emit("e2e_official", **out)
  return out


# -- e2e_ensemble -------------------------------------------------------------------

ENSEMBLE_MEMBERS = 50
ENSEMBLE_INITS = 4
ENSEMBLE_STOP = "2020-01-02T12"  # the 4th 12-hourly init
ENSEMBLE_QUANTILES = (0.25, 0.75)
ENSEMBLE_CLIM_DAYS = 31  # the climatology's days of year: January
# kernel-2 row counts of one 2-init chunk (see kernels_phase)
ENSEMBLE_ROWS = (630, 210, 2856)
# the three runs of the phase: their configs and their launches per chunk of
# 2 inits, written down in PERF.md before the first run on the card:
# kernel 1 never (no deterministic metric); kernel 2 once per variable in
# the probabilistic plan (7), once per metric in the pointwise tier
# (brier, debiased brier, ignorance: 3; Gaussian crps, variance, brier,
# ignorance: 4), never for the configs without regions
ENSEMBLE_RUNS = {
    "run1": ("probabilistic,probabilistic_spatial,"
             "probabilistic_spatial_histograms,"
             "ensemble_forecast_vs_era_experimental_metrics", (0, 7), False),
    "run2": ("ensemble_binary,ensemble_binary_spatial", (0, 3), False),
    "run3": ("gaussian_probabilistic,gaussian_binary", (0, 4), True),
}
# the first init card against CPU on two variables (four variable-levels):
# all seventeen on the CPU would take minutes at 50 members
ENSEMBLE_CPU_VARIABLES = ("geopotential", "2m_temperature")
PROB_FIELDS = ["debiased", "meansq", "skill", "spread", "var"]


def write_ensemble_stores(root):
  """The stores of the 50-member phase, from the seed (values drawn on the
  card, written block by block): 6-hourly truth with a land_sea_mask; the
  ensemble, 4 12-hourly inits x 21 leads x 50 members of the CLI's seven
  default variables at 500/700/850 hPa (one zarr chunk per init and
  variable); a Gaussian forecast of the same variables with their `_std`;
  an hourly climatology at 6-hour steps of `<var>_quantile` at 0.25 and
  0.75 (N(0, 1)'s quartiles plus noise) over January's days of year.  The
  members' float32 values
  have an even last mantissa bit and the truth's an odd one: no member ever
  equals the truth, so the CLI's unseeded rank histogram (its tie-breaks
  are drawn anew in every run) is the same in every run."""
  import torch

  from weatherbench2_torch import schema, xds

  specs = dict(variables_3d=list(VARIABLES_3D),
               variables_2d=list(VARIABLES_2D), levels=(500, 700, 850),
               spatial_resolution_in_degrees=1.5)
  fc_specs = dict(time_start="2020-01-01", time_stop="2020-01-03",
                  time_resolution="12 hours", lead_start="0 days",
                  lead_stop="10 days", lead_resolution="12 hours", **specs)
  truth = schema.mock_truth_data(time_start="2020-01-01",
                                 time_stop="2020-01-13",
                                 time_resolution="6 hours", **specs)
  ensemble = schema.mock_forecast_data(ensemble_size=ENSEMBLE_MEMBERS,
                                       **fc_specs)
  gaussian = schema.mock_forecast_data(**fc_specs)
  # January's days of year: the only ones the valid times select
  clim = schema.mock_hourly_climatology_data(hour_interval=6, **specs).isel(
      dayofyear=slice(0, ENSEMBLE_CLIM_DAYS))
  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED + 2)
  normal = lambda shape: torch.randn(tuple(shape), generator=gen,
                                     device="cuda").cpu().numpy()
  quartiles = np.asarray([-0.6745, 0.6745], np.float32)

  def values(store, name, shape):
    if name.endswith("_std"):
      return np.abs(normal(shape)) + np.float32(0.5)
    if name.endswith("_quantile"):
      q = quartiles.reshape((2,) + (1,) * (len(shape) - 1))
      return q + np.float32(0.1) * normal(shape)
    bits = normal(shape).view(np.int32)
    if store == "ensemble":
      return (bits & ~1).view(np.float32)
    return (bits | 1).view(np.float32) if store == "truth" else bits.view(
        np.float32)

  gauss_vars = dict(gaussian.variables_dict())
  for k, v in gaussian.variables_dict().items():
    gauss_vars[f"{k}_std"] = v
  quantile_vars = {
      f"{k}_quantile": xds.stub_variable(
          ("quantile",) + v.dims, {**v.sizes, "quantile": 2}, np.float32)
      for k, v in clim.variables_dict().items()}
  paths = {}
  for name, ds_vars, coords, dim, block, chunks, reuse in (
      ("truth", truth.variables_dict(), truth.coords_dict(), "time", 48,
       {"time": 48}, False),
      ("ensemble", ensemble.variables_dict(), ensemble.coords_dict(), "time",
       1, {"time": 1, "prediction_timedelta": -1}, False),
      ("gaussian", gauss_vars, gaussian.coords_dict(), "time", 4,
       {"time": 4, "prediction_timedelta": -1}, False),
      ("climatology", quantile_vars,
       {**clim.coords_dict(),
        "quantile": np.asarray(ENSEMBLE_QUANTILES)}, "dayofyear", 92,
       {"dayofyear": 92}, True)):
    path = os.path.join(root, f"{name}.zarr")
    template = xds.Dataset(
        {k: xds.stub_variable(v.dims, v.sizes, np.float32)
         for k, v in ds_vars.items()}, coords=dict(coords))
    if name == "truth":
      template["land_sea_mask"] = xds.stub_variable(
          ("longitude", "latitude"), template.sizes, np.float32)
    writer = xds.RegionWriter(path, template, chunks=chunks)
    if name == "truth":
      writer.write_array("land_sea_mask", (slice(None), slice(None)),
                         np.random.default_rng(SEED + 3).random(
                             (truth.sizes["longitude"],
                              truth.sizes["latitude"]), dtype=np.float32))
    n = template.sizes[dim]
    cache = {}
    for start in range(0, n, block):
      sl = slice(start, min(start + block, n))
      for vname, v in template.variables_dict().items():
        if vname == "land_sea_mask":
          continue
        shape = [sl.stop - sl.start if d == dim else v.sizes[d]
                 for d in v.dims]
        if not (reuse and vname in cache and cache[vname].shape == tuple(
            shape)):
          cache[vname] = values(name, vname, shape)
        writer.write_array(
            vname, tuple(sl if d == dim else slice(None) for d in v.dims),
            cache[vname])
        if not reuse:
          del cache[vname]
    writer.finish()
    paths[name] = path
  return paths


def ensemble_args(paths, out_dir, configs, stop=ENSEMBLE_STOP, gaussian=False,
                  variables=VARIABLES_3D + VARIABLES_2D, *more):
  """The CLI's arguments for the ensemble phase (thresholds for every run:
  the configs without threshold metrics ignore them)."""
  args = [
      f"--forecast_path={paths['gaussian' if gaussian else 'ensemble']}",
      f"--obs_path={paths['truth']}",
      f"--climatology_path={paths['climatology']}",
      f"--output_dir={out_dir}", "--variables=" + ",".join(variables),
      "--time_start=2020-01-01", f"--time_stop={stop}", "--regions=all",
      "--use_mesh", "--ensemble_dim=realization",
      "--input_chunks=init_time=2", f"--eval_configs={configs}",
      "--quantile_thresholds=" + ",".join(map(str, ENSEMBLE_QUANTILES)),
      *more]
  if gaussian:
    args.append("--aux_variables=" + ",".join(f"{v}_std" for v in variables))
  return args


ENSEMBLE_METRICS = {
    "probabilistic": ["crps", "crps_spread", "crps_skill",
                      "ensemble_mean_mse", "debiased_ensemble_mean_mse",
                      "ensemble_variance"],
    "probabilistic_spatial": ["crps", "crps_spread", "crps_skill",
                              "ensemble_mean_mse",
                              "debiased_ensemble_mean_mse",
                              "ensemble_variance"],
    "probabilistic_spatial_histograms": ["rank_histogram"],
    "ensemble_forecast_vs_era_experimental_metrics": [
        "energy_score", "energy_score_spread", "energy_score_skill",
        "ensemble_mean_rmse_sqrt_before_time_avg",
        "ensemble_stddev_sqrt_before_time_avg"],
    "ensemble_binary": ["brier_score", "debiased_brier_score",
                        "ignorance_score"],
    "ensemble_binary_spatial": ["brier_score", "debiased_brier_score",
                                "ignorance_score"],
    "gaussian_probabilistic": ["crps", "ensemble_variance"],
    "gaussian_binary": ["brier_score", "ignorance_score"],
}
SPATIAL_CONFIGS = ("probabilistic_spatial", "ensemble_binary_spatial",
                   "probabilistic_spatial_histograms")


def open_ensemble_results(out_dir, configs, variables):
  """Each config's results, checked: metric names, sizes (sixteen regions,
  21 leads, 3 levels, the two quantiles, 51 bins or the 240x121 cells), no
  NaN (the stores have none); +inf only in ignorance scores, where a whole
  ensemble or a Gaussian's tail misses the observed side; rank-histogram
  frequencies that sum to one in every cell."""
  from weatherbench2_torch import xds

  results = {}
  for cname in configs.split(","):
    spatial = cname in SPATIAL_CONFIGS
    path = os.path.join(out_dir, cname + (".zarr" if spatial else ".nc"))
    ds = xds.open_zarr(path) if spatial else xds.open_netcdf(path)
    metrics = [str(m) for m in np.asarray(ds.coords_dict()["metric"].data)]
    if metrics != ENSEMBLE_METRICS[cname]:
      raise AssertionError(f"{cname}: metrics {metrics}")
    if set(ds.keys()) != set(variables):
      raise AssertionError(f"{cname}: variables {sorted(ds.keys())}")
    for v in ds.keys():
      sizes = {"metric": len(metrics), "lead_time": 21}
      if v in VARIABLES_3D:
        sizes["level"] = 3
      if spatial:
        sizes.update(longitude=240, latitude=121)
      elif cname != "ensemble_forecast_vs_era_experimental_metrics":
        sizes["region"] = 16  # the one config without regions: per metric
      if "binary" in cname:
        sizes["quantile"] = 2
      if cname == "probabilistic_spatial_histograms":
        sizes["bins"] = ENSEMBLE_MEMBERS + 1
      if ds[v].sizes != sizes:
        raise AssertionError(f"{cname}/{v}: sizes {ds[v].sizes}, expected "
                             f"{sizes}")
      for i, m in enumerate(metrics):
        vals = np.asarray(ds[v].isel(metric=i).values)
        ok = np.isfinite(vals) | (np.isposinf(vals) if m == "ignorance_score"
                                  else False)
        if not ok.all():
          raise AssertionError(f"{cname}/{v}/{m}: {int((~ok).sum())} "
                               "values NaN or infinite")
      if cname == "probabilistic_spatial_histograms":
        total = np.asarray(ds[v].values, np.float64).sum(axis=ds[v].dims.index(
            "bins"))
        if not np.allclose(total, 1.0, rtol=0, atol=1e-6):
          raise AssertionError(f"{cname}/{v}: frequencies do not sum to 1")
    if "binary" in cname and not np.array_equal(
        np.asarray(ds.coords_dict()["quantile"].data), ENSEMBLE_QUANTILES):
      raise AssertionError(f"{cname}: quantiles "
                           f"{ds.coords_dict()['quantile'].data}")
    results[cname] = ds
  return results


def hold_with_infs(got, want, what):
  """``hold`` where +inf (ignorance) must be in the same places."""
  inf = np.isinf(want)
  if not np.array_equal(np.isinf(got), inf) or not np.array_equal(
      got[inf], want[inf]):
    raise AssertionError(f"{what}: infinities in other places")
  report = hold(np.where(inf, np.nan, got), np.where(inf, np.nan, want), what)
  report["infinite_values"] = int(inf.sum())
  return report


def compare_ensemble_results(got, want, what):
  """{config/variable: errors}: rank histograms equal (the stores hold no
  ties, so the CLI's unseeded tie-breaks never act), the rest within the
  tolerance."""
  errs = {}
  for cname in want:
    for k in want[cname].keys():
      w = np.asarray(want[cname][k].values, np.float64)
      g = np.asarray(got[cname][k].transpose(*want[cname][k].dims).values,
                     np.float64)
      if cname == "probabilistic_spatial_histograms":
        if not np.array_equal(g, w):
          raise AssertionError(f"{what}, {cname}/{k}: histograms differ")
        errs[f"{cname}/{k}"] = {"max_abs_err": 0.0, "max_err_over_bound": 0.0,
                                "equal": True}
      else:
        errs[f"{cname}/{k}"] = hold_with_infs(g, w, f"{what}, {cname}/{k}")
  worst = max(errs.values(), key=lambda e: e["max_err_over_bound"])
  return {"compared": len(errs), "worst": worst,
          "infinite_values": sum(e.get("infinite_values", 0)
                                 for e in errs.values())}


def ensemble_first_chunk_tensors(paths, name, n_inits=2, device="cuda"):
  """(members (M, lead, init, [level,] lon, lat), truth (lead, init, ...))
  of one variable's first `n_inits` inits on the card, read with numpy."""
  import torch

  from weatherbench2_torch import xds

  forecast = xds.open_zarr(paths["ensemble"], lazy=True)
  truth = xds.open_zarr(paths["truth"], lazy=True)
  inits = np.asarray(forecast.coords_dict()["time"].data)[:n_inits]
  leads = np.asarray(forecast.coords_dict()["prediction_timedelta"].data)
  valid = leads[:, None] + inits[None, :]  # (lead, init), as the store
  truth_times = np.asarray(truth.coords_dict()["time"].data)
  t_index = np.searchsorted(truth_times, valid)
  if not np.array_equal(truth_times[t_index], valid):
    raise AssertionError("valid times missing from the truth store")
  dims = forecast[name].dims
  if dims[:3] != ("realization", "prediction_timedelta", "time"):
    raise AssertionError(f"{name}: dims {dims}")
  f = np.asarray(forecast[name].isel(time=slice(0, n_inits)).values)
  t = np.asarray(truth[name].values)[t_index]
  return torch.as_tensor(f, device=device), torch.as_tensor(t, device=device)


def plain_probabilistic_first_chunk(paths, regions, device="cuda"):
  """The `probabilistic` config's six metrics over the first chunk (2
  inits), written independently of the package: the member fields from
  torch.sort and torch's means, reduced by kernel 2's plain version on the
  card; {variable: (metric, region, lead[, level])}."""
  import torch

  from weatherbench2_torch import metrics, ops, xds

  forecast = xds.open_zarr(paths["ensemble"], lazy=True)
  lat = np.asarray(forecast.coords_dict()["latitude"].data)
  lon = np.asarray(forecast.coords_dict()["longitude"].data)
  w = metrics._cell_area_from_latitude(np.deg2rad(lat))
  w = (w / w.mean()).astype(np.float32)
  region_w = torch.as_tensor(ops.make_region_weight_matrix(
      w, [r.mask_weights(lat, lon) for r in regions.values()], len(lon)),
      device=device)
  out = {}
  for name in VARIABLES_3D + VARIABLES_2D:
    f, t = ensemble_first_chunk_tensors(paths, name, device=device)
    m = f.shape[0]
    xs = torch.sort(f, dim=0).values
    coef = (2 * torch.arange(1, m + 1, device=device) - m - 1).to(f.dtype)
    spread = 2 * (coef.reshape((m,) + (1,) * (f.ndim - 1)) * xs).sum(0) / (
        m * (m - 1))
    del xs
    skill = (f - t).abs().mean(0)
    xbar = f.mean(0)
    meansq = (xbar - t) ** 2
    var = ((f - xbar) ** 2).sum(0) / (m - 1)
    fields = {"crps": skill - 0.5 * spread, "crps_spread": spread,
              "crps_skill": skill, "ensemble_mean_mse": meansq,
              "debiased_ensemble_mean_mse": meansq - var / m,
              "ensemble_variance": var}
    other = tuple(skill.shape[:-2])  # (lead, init[, level])
    stack = []
    for field in fields.values():
      sums, wsum, _ = ops.fused_region_sums_plain(
          field.reshape(int(np.prod(other)), -1), region_w)
      stack.append((sums / wsum).reshape((len(regions),) + other).mean(
          dim=2))  # over the inits
    out[name] = torch.stack(stack).cpu().numpy()
    del f, t
  return out


def member_pass_timing(paths):
  """CUDA-event medians of the member pass on the first chunk of
  geopotential ((50, 126, 29 040) members): the sort alone, the spread,
  and the five fields of the probabilistic plan; beside the bytes it must
  move (members read once, fields written once)."""
  import torch

  from weatherbench2_torch import metrics
  from weatherbench2_torch.parallel import streaming

  f, t = ensemble_first_chunk_tensors(paths, "geopotential")
  m = f.shape[0]
  l = f.shape[-2] * f.shape[-1]
  f3 = f.reshape(m, -1, l)
  t2 = t.reshape(-1, l)
  b = f3.shape[1]
  sort = lambda x: x.movedim(0, -1).contiguous().sort(dim=-1)
  out = {
      "shape": [m, b, l],
      "sort_ms": cuda_time_ms(sort, [(f3,)]),
      "spread_ms": cuda_time_ms(
          lambda x: metrics.pwm_spread(x, 0, False), [(f3,)]),
      "fields_ms": cuda_time_ms(
          lambda x, y: streaming.member_fields(x, y, PROB_FIELDS, False),
          [(f3, t2)]),
      "fields_skipna_ms": cuda_time_ms(
          lambda x, y: streaming.member_fields(x, y, PROB_FIELDS, True),
          [(f3, t2)]),
  }
  nbytes = 4 * (m * b * l + b * l + len(PROB_FIELDS) * b * l)
  out["bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
  out["fields_share_of_bytes_bound"] = out["bytes_bound_ms"] / out["fields_ms"]
  del f, t, f3, t2
  torch.cuda.empty_cache()
  return out


def seeded_histogram_card_vs_cpu(paths):
  """RankHistogram(seed=771) on the first init of geopotential rounded to
  halves (ties in most cells), on the card and on the CPU: equal counts."""
  import torch

  from weatherbench2_torch import metrics, xds

  f, t = ensemble_first_chunk_tensors(paths, "geopotential", n_inits=1)
  f, t = torch.round(2 * f) / 2, torch.round(2 * t) / 2
  dims = ("lead_time", "init_time", "level", "longitude", "latitude")
  hists = {}
  for dev in ("cuda", "cpu"):
    fc = xds.Dataset({"z": xds.Variable(("realization",) + dims, f.to(dev))})
    tr = xds.Dataset({"z": xds.Variable(dims, t.to(dev))})
    hists[dev] = metrics.RankHistogram(ensemble_dim="realization",
                                       seed=771).compute_chunk(fc, tr)
  a, b = hists["cuda"]["z"].values, hists["cpu"]["z"].values
  if not np.array_equal(a, b):
    raise AssertionError("seeded rank histograms differ, card against CPU")
  ties = float((f == t).any(dim=0).float().mean())
  return {"cells": int(a.size // a.shape[-1]), "bins": int(a.shape[-1]),
          "share_of_cells_with_ties": ties, "counts_equal": True}


def ensemble_kill_and_resume(paths, root, whole_dir):
  """Run 1 in a child process that dies right after its first state file;
  a second call resumes from it and must equal the uninterrupted run (the
  phase's main run 1) bit for bit."""
  from weatherbench2_torch import xds
  from weatherbench2_torch.parallel import streaming

  configs, per_chunk, _ = ENSEMBLE_RUNS["run1"]
  ckpt = os.path.join(root, "state")
  state_file = ckpt + "." + "+".join(sorted(configs.split(",")))
  more = (f"--checkpoint_path={ckpt}", "--checkpoint_every=1")
  child_s = dying_child(
      ensemble_args(paths, os.path.join(root, "killed"), configs, ENSEMBLE_STOP,
                    False, VARIABLES_3D + VARIABLES_2D, *more), ckpt, 1)
  if os.path.exists(os.path.join(root, "killed", "probabilistic.nc")):
    raise AssertionError("the killed run wrote its results")
  state_bytes = os.path.getsize(state_file)
  state = streaming.StreamingState.load(state_file)
  if (state.chunk_index, state.chunk_size, state.total) != (
      1, 2, ENSEMBLE_INITS):
    raise AssertionError(f"state at chunk {state.chunk_index} of "
                         f"{state.chunk_size} in {state.total}")
  del state
  resumed_dir = os.path.join(root, "resumed")
  resumed = run_cli(ensemble_args(paths, resumed_dir, configs, ENSEMBLE_STOP,
                                  False, VARIABLES_3D + VARIABLES_2D, *more),
                    1, per_chunk)
  compared = 0
  for cname in configs.split(","):
    ext = ".zarr" if cname in SPATIAL_CONFIGS else ".nc"
    opener = xds.open_zarr if ext == ".zarr" else xds.open_netcdf
    a = opener(os.path.join(whole_dir, cname + ext))
    b = opener(os.path.join(resumed_dir, cname + ext))
    if list(a.keys()) != list(b.keys()):
      raise AssertionError(f"{cname}: the resumed run's variables differ")
    for k in a.keys():
      if not np.array_equal(a[k].values, b[k].values, equal_nan=True):
        raise AssertionError(f"resumed run differs from the uninterrupted "
                             f"one in {cname}/{k}")
      compared += 1
  shutil.rmtree(resumed_dir)
  os.remove(state_file)
  return {"child_process_s": child_s, "state_bytes": state_bytes,
          "resumed": resumed, "results_bit_identical": True,
          "variables_compared": compared}


def e2e_ensemble_phase():
  """The probabilistic suite through the CLI: 50 members, 1.5 degrees,
  sixteen regions."""
  import torch

  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import evaluate as cli

  variables = VARIABLES_3D + VARIABLES_2D
  out = {"members": ENSEMBLE_MEMBERS, "resolution_degrees": 1.5,
         "inits": ENSEMBLE_INITS, "leads": 21, "regions": 16,
         "variable_levels": 17,
         "cut": "the first 4 inits of January 2020 in chunks of 2 instead "
                "of a year; leads to 10 days (the published IFS ENS runs "
                "to 15); the climatology's days of year 1-31 (the only "
                "ones the valid times select) instead of 366; the first "
                "init card against CPU on geopotential and 2m_temperature "
                "only (four variable-levels)",
         "predicted_launches_per_chunk": {
             run: dict(zip(("fused_deterministic_sums", "fused_region_sums"),
                           per_chunk))
             for run, (_, per_chunk, _) in ENSEMBLE_RUNS.items()}}
  with tempfile.TemporaryDirectory(prefix="wb2_chip_smoke_ensemble_") as root:
    t0 = time.perf_counter()
    paths = write_ensemble_stores(root)
    out["write_stores_s"] = time.perf_counter() - t0
    out["store_gib"] = store_gib(paths)

    # the main path: three runs, counters around each
    main_dirs = {}
    for run, (configs, per_chunk, gaussian) in ENSEMBLE_RUNS.items():
      main_dirs[run] = os.path.join(root, f"main_{run}")
      out[run] = {"configs": configs.split(","), **run_cli(
          ensemble_args(paths, main_dirs[run], configs, gaussian=gaussian),
          ENSEMBLE_INITS // 2, per_chunk)}
      emit("e2e_ensemble_run", run=run, **out[run])
      open_ensemble_results(main_dirs[run], configs, variables)

    # the first chunk of run 1 under the profiler; its `probabilistic`
    # results against plain versions on the card
    first_dir = os.path.join(root, "first_chunk")
    configs = ENSEMBLE_RUNS["run1"][0]
    out["first_chunk_profiled"] = profiled(lambda: cli.main(ensemble_args(
        paths, first_dir, configs, stop="2020-01-01T12")))
    emit("e2e_ensemble_step",
         first_chunk_profiled=out["first_chunk_profiled"])
    out["member_pass"] = member_pass_timing(paths)
    emit("e2e_ensemble_step", member_pass=out["member_pass"])
    mask = xds.open_zarr(paths["truth"])["land_sea_mask"]
    want = plain_probabilistic_first_chunk(
        paths, cli.predefined_regions_dict(mask))
    got = open_ensemble_results(first_dir, "probabilistic", variables)[
        "probabilistic"]
    errs = {}
    for v, w in want.items():
      dims = ("metric", "region", "lead_time") + (
          ("level",) if w.ndim == 4 else ())
      errs[v] = hold(np.asarray(got[v].transpose(*dims).values, np.float64),
                     w.astype(np.float64),
                     f"probabilistic plan vs plain versions, {v}")
    out["first_chunk_vs_plain"] = {"errors": errs, "tolerance": E2E_TOLERANCE}
    emit("e2e_ensemble_step", first_chunk_vs_plain=out["first_chunk_vs_plain"])
    shutil.rmtree(first_dir)

    # the first init on the card and on the CPU, two variables
    first = {"cuda": {}, "cpu": {}}
    walls = {"cuda": {}, "cpu": {}}
    for run, (configs, per_chunk, gaussian) in ENSEMBLE_RUNS.items():
      for dev in ("cuda", "cpu"):
        dev_dir = os.path.join(root, f"first_{run}_{dev}")
        args = ensemble_args(paths, dev_dir, configs, "2020-01-01T00",
                             gaussian, ENSEMBLE_CPU_VARIABLES)
        if dev == "cuda":
          n_vars = len(ENSEMBLE_CPU_VARIABLES)
          walls[dev][run] = run_cli(
              args, 1, (0, n_vars if run == "run1" else per_chunk[1]))["wall_s"]
        else:
          reset_launches()
          stats = cli.main(args + ["--device=cpu"])
          read_launches(stats["chunks"], 0, 0)
          walls[dev][run] = stats["wall_s"]
        first[dev].update(open_ensemble_results(dev_dir, configs,
                                                ENSEMBLE_CPU_VARIABLES))
    out["first_init_card_vs_cpu"] = {
        **compare_ensemble_results(first["cuda"], first["cpu"],
                                   "card vs CPU"),
        "wall_s": walls, "tolerance": E2E_TOLERANCE,
        "rank_histograms": "equal"}
    emit("e2e_ensemble_step", first_init_card_vs_cpu=out[
        "first_init_card_vs_cpu"])
    out["seeded_rank_histogram"] = seeded_histogram_card_vs_cpu(paths)
    emit("e2e_ensemble_step",
         seeded_rank_histogram=out["seeded_rank_histogram"])

    out["kill_and_resume"] = ensemble_kill_and_resume(paths, root,
                                                      main_dirs["run1"])
    out["disk_free_gib"] = shutil.disk_usage(root).free / 2**30
    torch.cuda.empty_cache()
  emit("e2e_ensemble", **out)
  return out


# -- e2e_derived --------------------------------------------------------------

WIND_10M = ("10m_u_component_of_wind", "10m_v_component_of_wind")
DERIVED = ("wind_speed", "10m_wind_speed")
# launches per 16-init chunk of run 1 (the three official configs with the
# two derived variables), written down in PERF.md before the first run on
# the card: kernel 1 once per variable (8 + the two 10 m components + the
# two derived = 12) for bias/mae of `deterministic` and of
# `deterministic_temporal`; kernel 2 for mse (1 group), ACC (3 groups under
# the 1 GiB cap) and SEEPS (1) of each, and the temporal config's rmse (1)
DERIVED_LAUNCHES = (24, 11)
# the rows of run 1's one new kernel-2 group: ACC's third (the 10 m winds
# and the two derived variables); its first two hold 9072 rows, as mse's
DERIVED_ROWS = (6048,)
# run 2: the probabilistic plan, one launch per variable a 2-init chunk
PROB_CLIM_LAUNCHES = (0, 7)
PROB_CLIM_YEARS = (1990, 2019)  # the official climatology's span
PROB_CLIM_CONFIGS = "probabilistic,probabilistic_spatial"
# run 3: the official spectra job's thirteen base variables
SPECTRUM_VARIABLES = (
    "geopotential", "specific_humidity", "temperature", "u_component_of_wind",
    "v_component_of_wind", "wind_speed", "10m_u_component_of_wind",
    "10m_v_component_of_wind", "10m_wind_speed", "2m_temperature",
    "mean_sea_level_pressure", "total_precipitation_6hr",
    "total_precipitation_24hr")
WIDE_TIMES = 28  # the first 7 days of 2020, 6-hourly


def plain_wind_speed_first_chunk(paths, regions, n_inits=16, device="cuda"):
  """mse and ACC of wind_speed over the first `n_inits` inits by plain
  PyTorch on the card, written independently of the package: the speed
  from the stores' u and v, the climatology's wind_speed rows at each valid
  time's (dayofyear, hour), kernel 2's plain version for the regional
  means; {metric: (region, lead, level)}."""
  import torch

  from weatherbench2_torch import metrics, ops, xds

  forecast = xds.open_zarr(paths["forecast"], lazy=True)
  truth = xds.open_zarr(paths["truth"], lazy=True)
  clim = xds.open_zarr(paths["climatology"], lazy=True)
  lat = np.asarray(forecast.coords_dict()["latitude"].data)
  lon = np.asarray(forecast.coords_dict()["longitude"].data)
  w = metrics._cell_area_from_latitude(np.deg2rad(lat))
  w = (w / w.mean()).astype(np.float32)
  region_w = torch.as_tensor(ops.make_region_weight_matrix(
      w, [r.mask_weights(lat, lon) for r in regions.values()], len(lon)),
      device=device)
  inits = np.asarray(forecast.coords_dict()["time"].data)[:n_inits]
  leads = np.asarray(forecast.coords_dict()["prediction_timedelta"].data)
  valid = leads[:, None] + inits[None, :]  # (lead, init), as the store
  truth_times = np.asarray(truth.coords_dict()["time"].data)
  t_index = np.searchsorted(truth_times, valid)

  def speed(ds, index):
    parts = []
    for name in ("u_component_of_wind", "v_component_of_wind"):
      v = ds[name]
      arr = (np.asarray(v.isel(time=slice(0, n_inits)).values)
             if index is None else np.asarray(v.values)[index])
      parts.append(torch.as_tensor(arr, device=device))
    return torch.sqrt(parts[0] ** 2 + parts[1] ** 2)

  f, t = speed(forecast, None), speed(truth, t_index)
  days = valid.astype("datetime64[D]")
  doy = (days - valid.astype("datetime64[Y]")).astype(np.int64)
  hour = (valid.astype("datetime64[h]") - days).astype(np.int64)
  c_da = clim["wind_speed"]
  if c_da.dims != ("dayofyear", "hour", "level", "longitude", "latitude"):
    raise AssertionError(f"climatology dims {c_da.dims}")
  hours = np.asarray(clim.coords_dict()["hour"].data)
  c = torch.as_tensor(np.asarray(c_da.isel(
      dayofyear=slice(0, int(doy.max()) + 1)).values)[
          doy, np.searchsorted(hours, hour)], device=device)

  def region_means(field):
    other = tuple(field.shape[:-2])
    sums, wsum, _ = ops.fused_region_sums_plain(
        field.reshape(int(np.prod(other)), -1), region_w)
    return (sums / wsum).reshape((len(regions),) + other)

  fa, ta = f - c, t - c
  acc = region_means(fa * ta) / torch.sqrt(
      region_means(fa ** 2) * region_means(ta ** 2))
  return {"mse": region_means((f - t) ** 2).mean(dim=2).cpu().numpy(),
          "acc": acc.mean(dim=2).cpu().numpy()}


def derived_run(root):
  """Run 1: the official configuration with wind_speed and 10m_wind_speed
  through the CLI; first 16 inits card against CPU; the first chunk's
  wind_speed mse and ACC against plain versions on the card."""
  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import evaluate as cli

  out = {"predicted_launches_per_chunk": dict(zip(
      ("fused_deterministic_sums", "fused_region_sums"), DERIVED_LAUNCHES))}
  t0 = time.perf_counter()
  paths = write_official_stores(root, extra_2d=WIND_10M,
                                clim_3d=("wind_speed",),
                                clim_2d=("10m_wind_speed",))
  out["write_stores_s"] = time.perf_counter() - t0
  out["store_gib"] = store_gib(paths)
  more = (f"--eval_configs={OFFICIAL_CONFIGS}", "--input_chunks=init_time=16",
          "--derived_variables=" + ",".join(DERIVED))
  extra = dict(extra_3d=("wind_speed",), extra_2d=WIND_10M + (DERIVED[1],))
  main_dir = os.path.join(root, "main")
  out["main"] = run_cli(official_args(paths, main_dir, "2020-01-16", *more),
                        OFFICIAL_INITS // 16, DERIVED_LAUNCHES)
  open_official_results(main_dir, OFFICIAL_INITS, **extra)
  emit("e2e_derived_run", run="run1", **out["main"])

  first = {}
  for dev in ("cuda", "cpu"):
    dev_dir = os.path.join(root, f"first16_{dev}")
    args = official_args(paths, dev_dir, "2020-01-08", *more)
    if dev == "cuda":
      out["first16_card"] = run_cli(args, 1, DERIVED_LAUNCHES)
    else:
      reset_launches()
      stats = cli.main(args + ["--device=cpu"])
      read_launches(stats["chunks"], 0, 0)
      out["first16_cpu_wall_s"] = stats["wall_s"]
    first[dev] = open_official_results(dev_dir, 16, **extra)
  out["first16_card_vs_cpu"] = {
      **compare_results(first["cuda"], first["cpu"], "card vs CPU"),
      "tolerance": E2E_TOLERANCE}

  mask = xds.open_zarr(paths["truth"])["land_sea_mask"]
  want = plain_wind_speed_first_chunk(paths, cli.predefined_regions_dict(mask))
  det = first["cuda"]["deterministic"]
  out["first_chunk_vs_plain"] = {"errors": {
      m: hold(np.asarray(det["wind_speed"].isel(
          metric=DETERMINISTIC_METRICS.index(m)).transpose(
              "region", "lead_time", "level").values, np.float64),
              want[m].astype(np.float64),
              f"wind_speed {m} vs its plain version")
      for m in ("mse", "acc")}, "tolerance": E2E_TOLERANCE}
  return out


def write_prob_clim_stores(root):
  """Run 2's stores, from the seed (values drawn on the card): a truth of
  1-15 January of each year 1990-2020, 6-hourly, the CLI's seven variables
  at 500/700/850 hPa, each year drawn independently, with a land_sea_mask;
  a forecast of 4 12-hourly inits x 21 leads (its values are replaced by
  the members; only its coordinates are read)."""
  import torch

  from weatherbench2_torch import schema, xds

  specs = dict(variables_3d=list(VARIABLES_3D),
               variables_2d=list(VARIABLES_2D), levels=(500, 700, 850),
               spatial_resolution_in_degrees=1.5)
  year = schema.mock_truth_data(time_start="2020-01-01",
                                time_stop="2020-01-16",
                                time_resolution="6 hours", **specs)
  per_year = year.sizes["time"]
  first, last = PROB_CLIM_YEARS[0], 2020
  times = np.concatenate([
      np.datetime64(f"{y}-01-01", "ns") + np.arange(per_year)
      * np.timedelta64(6, "h") for y in range(first, last + 1)])
  forecast = schema.mock_forecast_data(
      time_start="2020-01-01", time_stop="2020-01-03",
      time_resolution="12 hours", lead_start="0 days", lead_stop="10 days",
      lead_resolution="12 hours", **specs)
  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED + 4)
  paths = {}
  for name, ds, block in (("truth", year, per_year), ("forecast", forecast,
                                                      4)):
    coords = dict(ds.coords_dict())
    sizes = dict(ds.sizes)
    if name == "truth":
      coords["time"] = times
      sizes["time"] = len(times)
    template = xds.Dataset(
        {k: xds.stub_variable(v.dims, sizes, np.float32)
         for k, v in ds.variables_dict().items()}, coords=coords)
    if name == "truth":
      template["land_sea_mask"] = xds.stub_variable(
          ("longitude", "latitude"), sizes, np.float32)
    path = os.path.join(root, f"{name}.zarr")
    writer = xds.RegionWriter(path, template, chunks={"time": block})
    if name == "truth":
      writer.write_array("land_sea_mask", (slice(None), slice(None)),
                         np.random.default_rng(SEED + 5).random(
                             (sizes["longitude"], sizes["latitude"]),
                             dtype=np.float32))
    for start in range(0, sizes["time"], block):
      sl = slice(start, min(start + block, sizes["time"]))
      for vname, v in ds.variables_dict().items():
        shape = [sl.stop - sl.start if d == "time" else sizes[d]
                 for d in v.dims]
        writer.write_array(
            vname, tuple(sl if d == "time" else slice(None) for d in v.dims),
            torch.randn(tuple(shape), generator=gen,
                        device="cuda").cpu().numpy())
    writer.finish()
    paths[name] = path
  return paths


def prob_clim_args(paths, out_dir, stop=ENSEMBLE_STOP,
                   variables=VARIABLES_3D + VARIABLES_2D):
  return [
      f"--forecast_path={paths['forecast']}", f"--obs_path={paths['truth']}",
      f"--output_dir={out_dir}", "--variables=" + ",".join(variables),
      "--time_start=2020-01-01", f"--time_stop={stop}", "--regions=all",
      "--use_mesh", "--input_chunks=init_time=2",
      f"--eval_configs={PROB_CLIM_CONFIGS}",
      "--evaluate_probabilistic_climatology",
      f"--probabilistic_climatology_start_year={PROB_CLIM_YEARS[0]}",
      f"--probabilistic_climatology_end_year={PROB_CLIM_YEARS[1]}",
      "--probabilistic_climatology_hour_interval=6"]


def prob_clim_run(root):
  """Run 2: the probabilistic-climatology baseline (30 years as members)
  through the CLI, `probabilistic` and `probabilistic_spatial`; the first
  init card against CPU on two variables; the closed forms of independent
  N(0, 1) members and truth: the fair CRPS averages 1/sqrt(pi), the
  spread/skill ratio 1."""
  from weatherbench2_torch.cli import evaluate as cli

  out = {"members": PROB_CLIM_YEARS[1] - PROB_CLIM_YEARS[0] + 1,
         "predicted_launches_per_chunk": dict(zip(
             ("fused_deterministic_sums", "fused_region_sums"),
             PROB_CLIM_LAUNCHES))}
  t0 = time.perf_counter()
  paths = write_prob_clim_stores(root)
  out["write_stores_s"] = time.perf_counter() - t0
  out["store_gib"] = store_gib(paths)
  main_dir = os.path.join(root, "main")
  out["main"] = run_cli(prob_clim_args(paths, main_dir), ENSEMBLE_INITS // 2,
                        PROB_CLIM_LAUNCHES)
  emit("e2e_derived_run", run="run2", **out["main"])
  variables = VARIABLES_3D + VARIABLES_2D
  results = open_ensemble_results(main_dir, PROB_CLIM_CONFIGS, variables)
  prob = results["probabilistic"]
  metrics = list(np.asarray(prob.coords_dict()["metric"].data))
  closed = {}
  for v in variables:
    glob = prob[v].isel(region=0)
    mean = lambda m: float(np.mean(np.asarray(
        glob.isel(metric=metrics.index(m)).values, np.float64)))
    crps = mean("crps")
    ratio = np.sqrt(mean("ensemble_variance")
                    / mean("debiased_ensemble_mean_mse"))
    if abs(crps - 1 / np.sqrt(np.pi)) > 0.01 or abs(ratio - 1) > 0.02:
      raise AssertionError(f"{v}: fair CRPS {crps}, spread/skill {ratio}")
    closed[v] = {"crps": crps, "spread_skill": float(ratio)}
  out["closed_forms"] = {"crps_want": 1 / np.sqrt(np.pi),
                         "spread_skill_want": 1.0, "global": closed}

  first = {}
  for dev in ("cuda", "cpu"):
    dev_dir = os.path.join(root, f"first_{dev}")
    args = prob_clim_args(paths, dev_dir, "2020-01-01T00",
                          ENSEMBLE_CPU_VARIABLES)
    if dev == "cuda":
      out["first_init_card"] = run_cli(
          args, 1, (0, len(ENSEMBLE_CPU_VARIABLES)))
    else:
      reset_launches()
      stats = cli.main(args + ["--device=cpu"])
      read_launches(stats["chunks"], 0, 0)
      out["first_init_cpu_wall_s"] = stats["wall_s"]
    first[dev] = open_ensemble_results(dev_dir, PROB_CLIM_CONFIGS,
                                       ENSEMBLE_CPU_VARIABLES)
  out["first_init_card_vs_cpu"] = {
      **compare_results(first["cuda"], first["cpu"], "card vs CPU"),
      "tolerance": E2E_TOLERANCE}
  return out


def write_wide_store(root, n_times=WIDE_TIMES, name="wide"):
  """Run 3's 1440x721 truth-like store, 6-hourly from 2020-01-01, from the
  seed (values drawn on the card): the five 3-d variables at 500/700/850
  hPa (temperatures near 250 K, humidities in (0, 5e-3), geopotentials
  near 49 000 m2/s2), 2 m temperature, mean sea level pressure, the 10 m
  winds and the 6 h and 24 h precipitation."""
  import torch

  from weatherbench2_torch import schema, xds

  variables_2d = ["2m_temperature", "mean_sea_level_pressure", *WIND_10M,
                  "total_precipitation_6hr", "total_precipitation_24hr"]
  ds = schema.mock_truth_data(
      variables_3d=list(VARIABLES_3D), variables_2d=variables_2d,
      levels=(500, 700, 850), spatial_resolution_in_degrees=WIDE_RESOLUTION,
      time_start="2020-01-01", time_stop="2020-01-08",
      time_resolution="6 hours")
  ds = ds.isel(time=slice(0, n_times))
  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED + 6)
  scale = {"temperature": (250.0, 10.0), "geopotential": (49050.0, 981.0)}
  path = os.path.join(root, f"{name}.zarr")
  template = xds.Dataset(
      {k: xds.stub_variable(v.dims, v.sizes, np.float32)
       for k, v in ds.variables_dict().items()}, coords=dict(ds.coords_dict()))
  writer = xds.RegionWriter(path, template, chunks={"time": 4})
  for start in range(0, n_times, 4):
    sl = slice(start, min(start + 4, n_times))
    for vname, v in ds.variables_dict().items():
      shape = tuple(sl.stop - sl.start if d == "time" else v.sizes[d]
                    for d in v.dims)
      x = torch.randn(shape, generator=gen, device="cuda")
      if vname == "specific_humidity":
        x = 5e-3 * torch.rand(shape, generator=gen, device="cuda")
      elif vname.startswith("total_precipitation"):
        x = 1e-3 * x.abs()
      elif vname in scale:
        x = scale[vname][0] + scale[vname][1] * x
      writer.write_array(
          vname, tuple(sl if d == "time" else slice(None) for d in v.dims),
          x.cpu().numpy())
  writer.finish()
  return path


def compare_stores(got, want, what, names=None):
  """{variable: errors} of two stores; ±inf and NaN in the same places."""
  errs = {}
  for k in names or want.keys():
    w = np.asarray(want[k].values, np.float64)
    g = np.asarray(got[k].transpose(*want[k].dims).values, np.float64)
    errs[k] = hold_with_infs(g, w, f"{what}, {k}")
  worst = max(errs.values(), key=lambda e: e["max_err_over_bound"])
  return {"compared": len(errs), "worst": worst,
          "infinite_values": sum(e["infinite_values"] for e in errs.values())}


def spectrum_timing(path):
  """CUDA-event median of the spectrum of one block of geopotential (the
  first 4 times, 3 levels, 1440x721) beside its byte bound (the field read
  once, the power written once)."""
  import torch

  from weatherbench2_torch import xds
  from weatherbench2_torch.derived_variables import ZonalEnergySpectrum

  block = xds.to_device(xds.open_zarr(path, lazy=True)[["geopotential"]].isel(
      time=slice(0, 4)), torch.device("cuda"))
  x = block["geopotential"]
  ax = x.dims.index("longitude")
  data = x.data.contiguous()

  def power(d):
    f_k = torch.fft.rfft(d, dim=ax, norm="forward")
    return f_k.real ** 2 + f_k.imag ** 2

  out_elems = data.numel() // data.shape[ax] * (data.shape[ax] // 2 + 1)
  nbytes = 4 * (data.numel() + out_elems)
  res = {"shape": list(data.shape), "dims": list(x.dims),
         "rfft_power_ms": cuda_time_ms(power, [(data,)]),
         "compute_ms": cuda_time_ms(
             lambda _: ZonalEnergySpectrum("geopotential").compute(block),
             [(data,)]),
         "bytes": nbytes,
         "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         "library_call": "torch.fft.rfft (cuFFT)"}
  res["share_of_bound"] = res["bytes_bound_ms"] / res["rfft_power_ms"]
  return res


def spectra_run(root):
  """Run 3: the spectra pipeline at 0.25 degrees: compute_derived_variables
  with its default list, then compute_zonal_energy_spectrum with the
  official thirteen variables, time-averaged; the first day card against
  CPU for both CLIs; Parseval on the first day's spectrum."""
  import torch

  from weatherbench2_torch import schema, xds
  from weatherbench2_torch.cli import compute_derived_variables as derived_cli
  from weatherbench2_torch.cli import (
      compute_zonal_energy_spectrum as spectrum_cli)

  out = {"resolution_degrees": WIDE_RESOLUTION, "times": WIDE_TIMES}
  t0 = time.perf_counter()
  wide = write_wide_store(root)
  day = write_wide_store(root, 4, "first_day")
  out["write_stores_s"] = time.perf_counter() - t0
  out["store_gib"] = store_gib({"wide": wide})

  def derive(src, dst, dev):
    """The CLI's counts: wall, blocks, GiB to the device and back."""
    counts = derived_cli.main([f"--input_path={src}", f"--output_path={dst}"]
                              + (["--device=cpu"] if dev == "cpu" else []))
    return {k.replace("_bytes", "_gib"): v / 2**30 if k.endswith("_bytes")
            else v for k, v in counts.items()}

  def spectrum(src, dst, dev, stop):
    counts = spectrum_cli.main(
        [f"--input_path={src}", f"--output_path={dst}",
         "--base_variables=" + ",".join(SPECTRUM_VARIABLES),
         "--time_start=2020-01-01", f"--time_stop={stop}"]
        + (["--device=cpu"] if dev == "cpu" else []))
    return {k.replace("_bytes", "_gib"): v / 2**30 if k.endswith("_bytes")
            else v for k, v in counts.items()}

  # the main path: both CLIs on the card over the week, counters around
  reset_launches()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  derived = os.path.join(root, "derived.zarr")
  out["derive"] = derive(wide, derived, "cuda")
  out["derived_store_gib"] = store_gib({"d": derived})
  spectra = os.path.join(root, "spectra.zarr")
  out["spectrum"] = spectrum(derived, spectra, "cuda", "2020-01-07T18")
  read_launches(1, 0, 0)
  out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
  inputs = xds.open_zarr(wide, lazy=True)
  got = xds.open_zarr(derived, lazy=True)
  names = sorted(set(got.keys()) - set(inputs.keys()))
  out["derived_variables"] = names
  spec = xds.open_zarr(spectra)
  if sorted(spec.keys()) != sorted(SPECTRUM_VARIABLES):
    raise AssertionError(f"spectra of {sorted(spec.keys())}")
  n_wave = inputs.sizes["longitude"] // 2 + 1
  for k in spec.keys():
    if not np.isfinite(spec[k].values).all() or spec[k].sizes[
        "zonal_wavenumber"] != n_wave:
      raise AssertionError(f"spectrum of {k}: {spec[k].sizes}")
  emit("e2e_derived_run", run="run3", derive=out["derive"],
       spectrum=out["spectrum"])

  # the first day: card against CPU for both CLIs, and the week's first
  # day (derived in blocks) against the day's own run
  stores = {}
  for dev in ("cuda", "cpu"):
    stores[dev] = os.path.join(root, f"day_derived_{dev}.zarr")
    out[f"day_derive_{dev}_s"] = derive(day, stores[dev], dev)["wall_s"]
    stores[f"spec_{dev}"] = os.path.join(root, f"day_spectra_{dev}.zarr")
    out[f"day_spectrum_{dev}_s"] = spectrum(
        stores[dev], stores[f"spec_{dev}"], dev, "2020-01-01T18")["wall_s"]
  day_card = xds.open_zarr(stores["cuda"], lazy=True)
  out["day_derived_card_vs_cpu"] = {
      **compare_stores(day_card, xds.open_zarr(stores["cpu"], lazy=True),
                       "card vs CPU", names), "tolerance": E2E_TOLERANCE}
  out["week_blocks_vs_day"] = compare_stores(
      got.isel(time=slice(0, 4)), day_card, "blocks vs day", names)
  day_spec = xds.open_zarr(stores["spec_cuda"])
  out["day_spectra_card_vs_cpu"] = {
      **compare_stores(day_spec, xds.open_zarr(stores["spec_cpu"]),
                       "card vs CPU"), "tolerance": E2E_TOLERANCE}

  # Parseval: the spectrum sums to the zonal mean square times the
  # circumference, plus the Nyquist bin once more (1440 is even, and the
  # one-sided doubling counts it twice, as the reference does)
  x = np.asarray(xds.open_zarr(day)["2m_temperature"].transpose(
      "time", "longitude", "latitude").values, np.float64)
  lat = np.asarray(day_spec.coords_dict()["latitude"].data)
  circumference = 2 * np.pi * schema.EARTH_RADIUS_M * np.cos(np.deg2rad(lat))
  nyquist = np.abs(np.fft.rfft(x, axis=1, norm="forward")[:, -1]) ** 2
  want = (((x ** 2).mean(axis=1) + nyquist) * circumference).mean(axis=0)
  got_sum = np.asarray(day_spec["2m_temperature"].sum(
      "zonal_wavenumber").values, np.float64)
  out["parseval"] = hold(got_sum, want, "Parseval of the day's spectrum")
  out["spectrum_timing"] = spectrum_timing(day)
  return out


# -- e2e_prep: the data-prep twins of regridding, quantiles, climatology --------

PREP_GRID = ["--latitude_nodes=121", "--longitude_nodes=240",
             "--latitude_spacing=EQUIANGULAR_WITH_POLES",
             "--longitude_scheme=START_AT_ZERO"]  # WB2's 1.5-degree grid
PREP_LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925,
               1000)  # the 13 levels of WB2's ERA5 stores
PREP_RESOLUTION = 1.5  # degrees: WB2's 240x121 grid
PREP_QUANTILE_YEAR = 2020
PREP_BAND = slice(58, 64)  # latitudes -3 to 4.5, the NaN cells at 0
PREP_QUANTILES = (0.1, 0.5, 0.9)
CLIM_YEARS = (1990, 2019)  # the official climatology's span
CLIM_VARIABLES = ("2m_temperature", "total_precipitation_24hr")
CLIM_QUANTILES = ENSEMBLE_QUANTILES  # the quantiles e2e_ensemble reads
CLIM_TOLERANCE = (
    f"every statistic: {E2E_TOLERANCE} (the same float32 torch ops on the "
    "card and on the CPU; the weighted quantiles' cumulative weights in "
    "float64 on both)")
CLIM_CHECK_TILE = {"longitude": slice(0, 1)}  # card vs CPU: 121 pixels
PREP_CUTS = [
    "regrid: 28 six-hourly times of 2020 (as e2e_derived run 3), not a "
    "year; bilinear and nearest on 2m_temperature alone",
    "compute_quantiles: none (2020, 1464 times, 14 fields at 1.5 degrees)",
    "compute_climatology: none (1990-2019, 43 830 times, two variables at "
    "1.5 degrees); card against CPU on one longitude (121 pixels)"]


def prep_counts(counts):
  """A CLI's counts with bytes in GiB and the host's share of the wall
  (reading and writing, while the card waits)."""
  out = {k.replace("_bytes", "_gib"): v / 2**30 if k.endswith("_bytes")
         else v for k, v in counts.items()}
  out["host_wait_share"] = (counts["read_s"] + counts["write_s"]) / counts[
      "wall_s"]
  return out


def prep_cli(main, argv):
  """One data-prep CLI run on the card: its counts, the bytes read from
  the store, the peak device memory; the reduction kernels must not run."""
  import torch

  from weatherbench2_torch.xds import io_zarr

  reset_launches()
  io_zarr.READS.reset()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  counts = prep_counts(main(argv))
  read_launches(1, 0, 0)
  counts["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
  return counts


def bound_ms(nbytes, flops):
  """The least time of a call: its bytes at the HBM rate or its fp32
  operations at the CUDA cores' rate, whichever is longer."""
  by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  by_ops = flops / FP32_FLOPS_PER_S * 1e3
  return {"bound_ms": max(by_bytes, by_ops),
          "bound_by": "bytes" if by_bytes >= by_ops else "operations",
          "bytes": nbytes, "operations": flops}


def write_grid_store(path, variables, times, resolution, levels, gen,
                     values, chunk):
  """A truth-like store of ``variables`` ({name: has levels}) at
  ``times``, values drawn on the card by ``values(name, shape, gen,
  chunk_times)``, written in time chunks of ``chunk`` (nothing the size of
  the store is held)."""
  import torch

  from weatherbench2_torch import xds

  n_lat, n_lon = round(180 / resolution) + 1, round(360 / resolution)
  coords = {"time": times, "latitude": np.linspace(-90, 90, n_lat),
            "longitude": np.linspace(0, 360, n_lon, endpoint=False)}
  sizes = {"time": len(times), "latitude": n_lat, "longitude": n_lon}
  if any(variables.values()):
    coords["level"] = np.array(levels)
    sizes["level"] = len(levels)
  dims = {k: ("time",) + (("level",) if has else ()) + ("longitude",
                                                         "latitude")
          for k, has in variables.items()}
  template = xds.Dataset({k: xds.stub_variable(d, sizes, np.float32)
                          for k, d in dims.items()}, coords=coords)
  writer = xds.RegionWriter(path, template, chunks={"time": chunk})
  for start in range(0, len(times), chunk):
    sl = slice(start, min(start + chunk, len(times)))
    for name, d in dims.items():
      shape = tuple(sl.stop - sl.start if k == "time" else sizes[k]
                    for k in d)
      writer.write_array(name, (sl,),
                         values(name, shape, gen, times[sl]).cpu().numpy())
  writer.finish()
  return path


def regrid_timing(regridder, block):
  """CUDA-event medians of the regridding calls on one field and on one
  time block, beside their bounds."""
  import torch

  from weatherbench2_torch import xds

  dev = torch.device("cuda")
  field = xds.to_device(block, dev)["2m_temperature"].data
  one = field[0].contiguous()
  n_in, n_out = one.numel(), int(np.prod(regridder.target.shape))
  out = {}
  if hasattr(regridder, "_lat_weights"):
    lat_w = torch.as_tensor(regridder._lat_weights, device=dev)
    lon_w = torch.as_tensor(regridder._lon_weights, device=dev)
    (a, b), (c, d) = lon_w.shape, lat_w.shape
    macs = b * d * c + a * b * c  # latitude contracted first
    out["matmul_pair_per_field"] = {
        "ms": cuda_time_ms(lambda x: torch.matmul(lon_w, torch.matmul(
            x, lat_w.T)), [(one,)]),
        **bound_ms(4 * (n_in + n_out + lat_w.numel() + lon_w.numel()),
                   2 * macs),
        "library_call": "torch.matmul (two, float32)"}
  out["regrid_array_per_field"] = {
      "ms": cuda_time_ms(regridder.regrid_array, [(one,)]),
      **bound_ms(4 * (n_in + n_out), 0)}
  out["regrid_array_block"] = {
      "shape": list(field.shape),
      "ms": cuda_time_ms(regridder.regrid_array, [(field,)]),
      **bound_ms(4 * field.shape[0] * (n_in + n_out), 0)}
  return out


def area_mean(x, lat, includes_poles=True):
  """Cell-area weighted mean of (..., longitude, latitude) fields."""
  from weatherbench2_torch import regridding

  bounds = regridding._cell_bounds_lat(np.asarray(lat), includes_poles)
  w = regridding._lat_area_from_bounds(bounds[:-1], bounds[1:])
  return (np.asarray(x, np.float64).mean(-2) * w).sum(-1) / w.sum()


def regrid_run(root):
  """Run 1: conservative regridding of e2e_derived run 3's 0.25-degree
  store (the official thirteen variables, 28 times) to WB2's 1.5-degree
  grid; the first time block card against CPU; the area-weighted means
  kept; a target cell without valid data NaN.  Then bilinear and nearest
  on a 2m_temperature store of the same times."""
  import torch

  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import regrid as cli

  out = {}
  t0 = time.perf_counter()
  wide = write_wide_store(root)
  # the four southernmost rows (-90 to -89.25) of the first time: the
  # target row at -90 covers no other source cell, so it has no valid data
  src = xds.open_zarr(wide, lazy=True)
  t2 = src["2m_temperature"]
  key = tuple(0 if d == "time" else slice(0, 4) if d == "latitude"
              else slice(None) for d in t2.dims)
  shape = [1 if d == "time" else 4 if d == "latitude" else t2.sizes[d]
           for d in t2.dims]
  xds.write_zarr_region(wide, "2m_temperature", key,
                        np.full(shape, np.nan, np.float32))
  t2_path = os.path.join(root, "t2m.zarr")
  xds.to_zarr(xds.read(xds.open_zarr(wide, lazy=True)[["2m_temperature"]]),
              t2_path, chunks={"time": 4})
  out["write_stores_s"] = time.perf_counter() - t0
  out["store_gib"] = store_gib({"wide": wide})
  for method, path in (("conservative", wide), ("bilinear", t2_path),
                       ("nearest", t2_path)):
    dst = os.path.join(root, f"{method}.zarr")
    argv = [f"--input_path={path}", f"--output_path={dst}", *PREP_GRID,
            f"--regridding_method={method}"]
    run = out[method] = prep_cli(cli.main, argv)
    emit("e2e_prep_run", run="regrid", method=method, **run)
    # the first block: card against the port's CPU functions
    source = xds.open_zarr(path, lazy=True)
    block = xds.read(source.isel(time=slice(0, xds.default_block(
        source, "time", "cuda"))))
    regridder = cli.make_regridder(source, cli.build_parser().parse_args(
        argv))
    want = regridder.regrid_dataset(xds.to_device(block, torch.device("cpu")))
    want = want.copy(data={k: v.data.numpy()
                           for k, v in want.variables_dict().items()})
    got = xds.open_zarr(dst, lazy=True).isel(
        time=slice(0, block.sizes["time"]))
    run["first_block_card_vs_cpu"] = {
        **compare_stores(got, want, f"{method}: card vs CPU"),
        "times": block.sizes["time"], "tolerance": E2E_TOLERANCE}
    if method == "conservative":
      res = xds.open_zarr(dst)["2m_temperature"].transpose(
          "time", "longitude", "latitude").values
      if not (np.isnan(res[0, :, 0]).all() and np.isfinite(res[0, :, 1:]).all()
              and np.isfinite(res[1:]).all()):
        raise AssertionError("conservative: NaN where a target cell has "
                             "valid data, or none where it has none")
      source_t2 = xds.open_zarr(path)["2m_temperature"].transpose(
          "time", "longitude", "latitude").values[1:]
      run["area_mean"] = hold(
          area_mean(res[1:], regridder.target.latitudes),
          area_mean(source_t2, regridder.source.latitudes),
          "area-weighted mean of 2m_temperature, source and target")
      run["nan_cells"] = "target row -90 of the first time: all NaN"
    run["timing"] = regrid_timing(regridder, block.isel(time=slice(0, 4)))
  return out


def quantile_timing(path):
  """The tile's pencil sort: CUDA-event medians of the quantile of one
  latitude tile of geopotential (the CLI's call) and of its torch.sort,
  beside the bound of the quantile (the tile read once, the quantiles
  written once)."""
  import torch

  from weatherbench2_torch import xds
  from weatherbench2_torch.xds import _xp

  ds = xds.open_zarr(path, lazy=True)
  band = xds.default_block(ds, "latitude", "cuda")
  tile = xds.to_device(xds.read(ds[["geopotential"]].isel(
      latitude=slice(0, band))), torch.device("cuda"))["geopotential"].data
  q = np.asarray(PREP_QUANTILES)
  pencils = tile.numel() // tile.shape[0]
  moved = tile.permute(1, 2, 3, 0).reshape(pencils, tile.shape[0])
  return {"shape": list(tile.shape), "pencils": pencils,
          "quantile_ms": cuda_time_ms(
              lambda x: _xp.quantile(x, q, (0,), True), [(tile,)]),
          "sort_ms": cuda_time_ms(lambda x: torch.sort(x, dim=-1),
                                  [(moved,)]),
          **bound_ms(4 * (tile.numel() + len(q) * pencils), 0),
          "library_call": "torch.sort (float32 keys, int64 indices)"}


def quantiles_run(root):
  """Run 2: compute_quantiles over 2020 of a 1.5-degree store (2 m
  temperature, geopotential at 13 levels; a few NaNs), skipna, three
  quantiles; a latitude band card against np.nanquantile."""
  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import compute_quantiles as cli

  import torch

  out = {}
  t0 = time.perf_counter()
  times = np.arange(np.datetime64(f"{PREP_QUANTILE_YEAR}-01-01", "ns"),
                    np.datetime64(f"{PREP_QUANTILE_YEAR + 1}-01-01", "ns"),
                    np.timedelta64(6, "h"))
  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED + 7)

  def values(name, shape, g, _):
    x = torch.randn(shape, generator=g, device="cuda")
    if name == "geopotential":
      return 49050.0 + 981.0 * x
    x = 280.0 + 10.0 * x
    x[:, 10:20, PREP_BAND.start + 2] = torch.nan  # cells with no data
    return x

  path = write_grid_store(
      os.path.join(root, "year.zarr"),
      {"2m_temperature": False, "geopotential": True}, times,
      PREP_RESOLUTION, PREP_LEVELS, gen, values, 61)
  out["write_stores_s"] = time.perf_counter() - t0
  out["store_gib"] = store_gib({"year": path})
  dst = os.path.join(root, "quantiles.zarr")
  out["main"] = prep_cli(cli.main, [
      f"--input_path={path}", f"--output_path={dst}", "--dim=time",
      "--skipna", "--quantiles=" + ",".join(map(str, PREP_QUANTILES))])
  emit("e2e_prep_run", run="compute_quantiles", **out["main"])
  band = PREP_BAND
  got = xds.open_zarr(dst).isel(latitude=band)
  src = xds.open_zarr(path, lazy=True).isel(latitude=band)
  errs = {}
  for name in ("2m_temperature", "geopotential"):
    x = np.asarray(xds.read(src[[name]])[name].values)
    want = np.nanquantile(x, PREP_QUANTILES, axis=0)
    g = got[name]
    g = np.asarray(g.transpose("quantile", *src[name].dims[1:]).values,
                   np.float64)
    errs[name] = hold(g, want.astype(np.float64),
                      f"{name}: card vs np.nanquantile")
  out["band_card_vs_numpy"] = {"latitudes": [band.start, band.stop],
                               "errors": errs, "tolerance": E2E_TOLERANCE}
  out["timing"] = quantile_timing(path)
  return out


def climatology_timing(path):
  """The circulant products and one day block of the window quantile at
  the run's shapes (one hour of 2m_temperature), beside their bounds."""
  import torch

  from weatherbench2_torch import utils, xds
  from weatherbench2_torch.ops import climatology as clim_ops

  dev = torch.device("cuda")
  ds = xds.open_zarr(path, lazy=True)[["2m_temperature"]].sel(
      time=slice(str(CLIM_YEARS[0]), str(CLIM_YEARS[1])))
  hour = utils.select_hour(xds.to_device(xds.read(ds), dev), 0)
  stacked = utils.stack_years(hour)["2m_temperature"].data
  n_years, n_days = stacked.shape[:2]
  npix = stacked[0, 0].numel()
  w = utils.create_window_weights(61).values
  m = torch.as_tensor(clim_ops.circulant_window_matrix(w, n_days), device=dev)
  flat = torch.nan_to_num(stacked.reshape(n_years, n_days, npix)).sum(0)
  out = {"stacked_shape": list(stacked.shape)}
  out["circulant_product"] = {
      "ms": cuda_time_ms(lambda a: m @ a, [(flat,)]),
      **bound_ms(4 * (m.numel() + 2 * flat.numel()),
                 2 * n_days * n_days * npix),
      "library_call": "torch.matmul (float32)"}
  out["rolling_mean"] = {
      "ms": cuda_time_ms(lambda x: clim_ops.device_rolling_clim(x, w),
                         [(stacked,)]),
      **bound_ms(4 * (stacked.numel() + n_days * npix),
                 2 * 2 * n_days * n_days * npix)}
  # one day block as the CLI runs it: the pool of its days, sorted
  pool = n_years * 61
  day_block = min(n_days, clim_ops.quantile_day_block(npix, pool, 4, "cuda"))
  # (the window wraps within the block's days: the same work as a block
  # of the year)
  values = stacked[:, :day_block].reshape(n_years, day_block, npix)
  # comparisons of a sort of each pencil: pool x log2(pool) per pencil
  compares = day_block * npix * pool * float(np.log2(pool))
  out["window_quantile_day_block"] = {
      "days": day_block, "pool": pool,
      "ms": cuda_time_ms(lambda x: clim_ops.device_window_quantile(
          x, 61, CLIM_QUANTILES, w),
          [(values,)]),
      **bound_ms(4 * (values.numel() + len(CLIM_QUANTILES) * day_block
                      * npix), compares),
      "library_call": "torch.sort (stable, float32 keys) and gathers"}
  return out


def climatology_run(root):
  """Run 3: compute_climatology with the official climatology's settings
  (1990-2019, 6-hourly, a 61-day window) of 2m_temperature and 24 h
  precipitation at 1.5 degrees: mean, std, SEEPS and the quantiles that
  e2e_ensemble reads; one longitude card against the port's CPU
  functions."""
  import torch

  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import compute_climatology as cli

  out = {"years": list(CLIM_YEARS)}
  t0 = time.perf_counter()
  times = np.arange(np.datetime64(f"{CLIM_YEARS[0]}-01-01", "ns"),
                    np.datetime64(f"{CLIM_YEARS[1] + 1}-01-01", "ns"),
                    np.timedelta64(6, "h"))
  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED + 8)

  def values(name, shape, g, chunk_times):
    x = torch.randn(shape, generator=g, device="cuda")
    if name == "2m_temperature":  # a seasonal cycle of 15 K, noise of 5 K
      day = (chunk_times - chunk_times.astype("datetime64[Y]")) / (
          np.timedelta64(1, "D"))
      season = torch.as_tensor(15.0 * np.cos(2 * np.pi * day / 365.25),
                               dtype=torch.float32, device="cuda")
      return 280.0 + season[:, None, None] + 5.0 * x
    return (1e-3 * x).clamp(min=0.0)  # half the values dry

  path = write_grid_store(
      os.path.join(root, "truth.zarr"), dict.fromkeys(CLIM_VARIABLES, False),
      times, PREP_RESOLUTION, (), gen, values, 1461)
  out["write_stores_s"] = time.perf_counter() - t0
  out["store_gib"] = store_gib({"truth": path})
  dst = os.path.join(root, "climatology.zarr")
  argv = [f"--input_path={path}", f"--output_path={dst}",
          "--frequency=hourly", "--hour_interval=6", "--window_size=61",
          f"--start_year={CLIM_YEARS[0]}", f"--end_year={CLIM_YEARS[1]}",
          "--statistics=mean,std,seeps,quantile",
          "--quantiles=" + ",".join(map(str, CLIM_QUANTILES))]
  out["main"] = prep_cli(cli.main, argv)
  emit("e2e_prep_run", run="compute_climatology", **out["main"])
  got = xds.open_zarr(dst)
  for k in got.keys():
    if not np.isfinite(got[k].values).all():
      raise AssertionError(f"climatology {k} is not finite")
  # one longitude on the CPU through the CLI's own functions
  t0 = time.perf_counter()
  args = cli.build_parser().parse_args(argv + ["--device=cpu"])
  run = cli._Run(args)
  tile = xds.to_device(xds.read(xds.open_zarr(path, lazy=True).sel(
      time=run.clim_years).isel(CLIM_CHECK_TILE)), torch.device("cpu"))
  pieces = [run.stat(tile, s, list(CLIM_QUANTILES)) for s in
            ("mean", "std", "quantile")]
  pieces = [pieces[0]] + [
      p.rename({v: f"{v}_{s}" for v in p.keys()})
      for p, s in zip(pieces[1:], ("std", "quantile"))]
  pieces.append(run.seeps(tile, "total_precipitation_24hr", 0.25))
  want = xds.merge(pieces)
  want = want.copy(data={k: v.data.numpy()
                         for k, v in want.variables_dict().items()})
  out["cpu_tile_s"] = time.perf_counter() - t0
  out["tile_card_vs_cpu"] = {
      **compare_stores(got.isel(CLIM_CHECK_TILE), want, "card vs CPU"),
      "tile": "longitude 0, every latitude", "tolerance": CLIM_TOLERANCE}
  out["timing"] = climatology_timing(path)
  return out


def e2e_prep_phase():
  """The data-prep twins at full width: regridding 0.25 to 1.5 degrees,
  the quantiles of a year, the official climatology; each run in a
  temporary directory of its own."""
  import torch

  for cut in PREP_CUTS:
    print(f"e2e_prep cut: {cut}", flush=True)
  out = {"cuts": PREP_CUTS}
  t0 = time.perf_counter()
  for run, fn in (("regrid", regrid_run), ("compute_quantiles", quantiles_run),
                  ("compute_climatology", climatology_run)):
    with tempfile.TemporaryDirectory(prefix=f"wb2_chip_smoke_{run}_") as root:
      out[run] = fn(root)
    torch.cuda.empty_cache()
    emit("e2e_prep_step", run=run, seconds=time.perf_counter() - t0)
  emit("e2e_prep", **out)
  return out


# -- e2e_prep2: the nine remaining data-prep twins ------------------------------

PREP2_YEAR_VARIABLES = {"2m_temperature": False,
                        "total_precipitation_24hr": False,
                        "geopotential": True, "temperature": True}
PREP2_FIELDS = 2 + 2 * len(PREP_LEVELS)  # 28 fields a time
PREP2_CELLS = 240 * 121
# the time block of the year store's twins on the card (1 GiB of input):
# kernel 2's rows per launch follow from it (see kernels_phase)
PREP2_BLOCK = 2 ** 30 // (4 * PREP2_FIELDS * PREP2_CELLS)
PREP2_AVERAGE_ROWS = (PREP2_BLOCK * len(PREP_LEVELS), PREP2_BLOCK)
PREP2_MOMENT_ROWS = tuple(2 * r for r in PREP2_AVERAGE_ROWS)
PREP2_CHECK = ("2020-01-01", "2020-01-31")  # card against CPU: January
PREP2_NAN_CELLS = (slice(10, 20), 60)  # 2 m temperature's (lon, lat)
PREP2_ENSEMBLE_INITS = 2
PREP2_EXPAND = ("2020-12-01", "2021-01-31")
PCF_YEARS = (1990, 2019)
PCF_INITS = ("2020-01-01", "2020-01-01T18")
PCF_MEMBERS = 30
PREP2_CUTS = [
    "compute_ensemble_mean: 2 of e2e_ensemble's 12-hourly inits (50 members, "
    "17 variable-levels, 21 leads), not a year",
    "compute_averages, compute_statistical_moments, resample_in_time, "
    "resample_daily: none (2020, 1464 times, 28 fields at 1.5 degrees); "
    "card against CPU on January",
    "slice_dataset: e2e_derived run 3's 28 times at 0.25 degrees",
    "index_on_valid_time: e2e_official's 33 inits x 21 leads",
    "expand_climatology: December 2020 and January 2021 (248 times, day 366 "
    "among them), not a year",
    "compute_probabilistic_climatological_forecasts: 4 inits of 1 January "
    "2020; a truth of 24 December - 24 January of each year 1990-2020 (the "
    "only days the samples and their 15-day leads reach)"]
GATHER_EQUAL = "bit for bit (the twin gathers and computes nothing)"


def prep2_cli(main, argv, region_launches=0):
  """One data-prep twin on the card: its counts (GiB, the host's share,
  the copies' share of the wall), the peak device memory and the launches
  of the reduction kernels, which must be ``region_launches`` of kernel 2
  and none of kernel 1."""
  import torch

  reset_launches()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  counts = main(argv)
  out = prep_counts(counts)
  out["copy_share"] = (counts["h2d_s"] + counts["d2h_s"]) / counts["wall_s"]
  out["launches"] = read_launches(1, 0, region_launches)
  out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
  return out


def equal_stores(got_path, want_path, names=None):
  """Raises unless the variables ``names`` (default: all of the second
  store's) and every coordinate are equal, NaNs in the same places."""
  from weatherbench2_torch import xds

  got, want = xds.open_zarr(got_path, lazy=True), xds.open_zarr(want_path,
                                                                lazy=True)
  names = list(names or want.keys())
  for k in names:
    g = np.asarray(xds.read(got[[k]])[k].values)
    w = np.asarray(xds.read(want[[k]])[k].values)
    if g.shape != w.shape or not np.array_equal(g, w, equal_nan=True):
      raise AssertionError(f"{k}: the stores differ")
  for c, v in want.coords_dict().items():
    if not np.array_equal(np.asarray(got.coords_dict()[c].data),
                          np.asarray(v.data)):
      raise AssertionError(f"coordinate {c}: the stores differ")
  return {"compared": len(names), "equal": GATHER_EQUAL}


def twin_card_vs_cpu(main, argv, root, tag, equal=False, names=None):
  """The twin on the card and with --device=cpu on the same store and
  flags; their outputs within E2E_TOLERANCE, or ``equal``."""
  from weatherbench2_torch import xds

  paths = [os.path.join(root, f"{tag}_{who}.zarr") for who in ("card", "cpu")]
  main(argv + [f"--output_path={paths[0]}"])
  t0 = time.perf_counter()
  main(argv + [f"--output_path={paths[1]}", "--device=cpu"])
  out = {"cpu_s": time.perf_counter() - t0}
  if equal:
    out.update(equal_stores(*paths, names))
  else:
    out.update(compare_stores(xds.open_zarr(paths[0]),
                              xds.open_zarr(paths[1]), "card vs CPU", names),
               tolerance=E2E_TOLERANCE)
  for p in paths:
    shutil.rmtree(p)
  return out


def finite_store(path, sizes, masked=()):
  """The store's sizes; raises unless they include ``sizes`` and every
  variable is finite, those of ``masked`` that keep the grid (longitude and
  latitude last) outside the NaN cells of the year store."""
  from weatherbench2_torch import xds

  ds = xds.open_zarr(path, lazy=True)
  for d, n in sizes.items():
    if ds.sizes.get(d) != n:
      raise AssertionError(f"{path}: {d} has {ds.sizes.get(d)}, not {n}")
  for k in ds.keys():
    x = np.array(xds.read(ds[[k]])[k].values)
    if k in masked and ds[k].dims[-2:] == ("longitude", "latitude"):
      x[(...,) + PREP2_NAN_CELLS] = 0.0
    if not np.isfinite(x).all():
      raise AssertionError(f"{path}: {k} is not finite")
  return dict(ds.sizes)


def year_runs(root):
  """A 1.5-degree year of 2020 (2 m temperature with NaN cells, 24 h
  precipitation, geopotential and temperature at 13 levels):
  compute_averages over latitude and longitude (kernel 2, R 2),
  compute_statistical_moments (kernel 2, R 1), resample_in_time (weekly
  means, 2 m temperature's extremes) and resample_daily (daily means, the
  precipitation's daily sums); then each of them card against CPU on
  January, sliced out by slice_dataset."""
  import torch

  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import compute_averages
  from weatherbench2_torch.cli import compute_statistical_moments
  from weatherbench2_torch.cli import resample_daily
  from weatherbench2_torch.cli import resample_in_time
  from weatherbench2_torch.cli import slice_dataset

  out = {}
  t0 = time.perf_counter()
  times = np.arange(np.datetime64("2020-01-01", "ns"),
                    np.datetime64("2021-01-01", "ns"), np.timedelta64(6, "h"))
  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED + 9)

  def values(name, shape, g, _):
    x = torch.randn(shape, generator=g, device="cuda")
    if name == "2m_temperature":
      x = 280.0 + 10.0 * x
      x[(slice(None),) + PREP2_NAN_CELLS] = torch.nan  # no data
      return x
    if name == "total_precipitation_24hr":
      return (1e-3 * x).clamp(min=0.0)
    if name == "geopotential":
      return 49050.0 + 981.0 * x
    return 250.0 + 10.0 * x

  path = write_grid_store(os.path.join(root, "year.zarr"),
                          PREP2_YEAR_VARIABLES, times, PREP_RESOLUTION,
                          PREP_LEVELS, gen, values, 61)
  out["write_stores_s"] = time.perf_counter() - t0
  out["store_gib"] = store_gib({"year": path})
  ds = xds.open_zarr(path, lazy=True)
  blocks = -(-ds.sizes["time"] // xds.default_block(ds, "time", "cuda"))
  if xds.default_block(ds, "time", "cuda") != PREP2_BLOCK:
    raise AssertionError("the year's time block is not PREP2_BLOCK")
  n_vars = len(PREP2_YEAR_VARIABLES)
  year = [f"--input_path={path}"]
  jan = os.path.join(root, "january.zarr")
  runs = {
      "compute_averages": (
          compute_averages.main, ["--averaging_dims=latitude,longitude",
                                  "--skipna", "--time_start=2020-01-01",
                                  "--time_stop=2020-12-31"],
          blocks * n_vars),
      "compute_statistical_moments": (
          compute_statistical_moments.main, ["--start_year=2020",
                                             "--end_year=2020"],
          blocks * n_vars),
      "resample_in_time": (
          resample_in_time.main, ["--period=1w", "--mean_vars=ALL",
                                  "--min_vars=2m_temperature",
                                  "--max_vars=2m_temperature",
                                  "--add_mean_suffix"], 0),
      "resample_daily": (resample_daily.main, ["--period=1d"], 0)}
  for name, (main, flags, launches) in runs.items():
    dst = os.path.join(root, f"{name}.zarr")
    out[name] = prep2_cli(main, year + flags + [f"--output_path={dst}"],
                          launches)
    out[name]["sizes"] = finite_store(dst, {}, masked=(
        "2m_temperature", "2m_temperature_mean", "2m_temperature_min",
        "2m_temperature_max"))
    shutil.rmtree(dst)
    emit("e2e_prep2_run", run=name, **out[name])
  out["slice_january"] = prep2_cli(slice_dataset.main, year + [
      f"--output_path={jan}",
      "--sel_strings=time_start={},time_stop={}".format(*PREP2_CHECK)])
  emit("e2e_prep2_run", run="slice_dataset (1.5 degrees)",
       **out["slice_january"])
  for name, (main, flags, _) in runs.items():
    if name == "compute_averages":
      flags = flags[:2] + ["--time_start={}".format(PREP2_CHECK[0]),
                           "--time_stop={}".format(PREP2_CHECK[1])]
    out[name]["card_vs_cpu"] = twin_card_vs_cpu(
        main, [f"--input_path={jan}"] + flags, root, name)
  return out


def ensemble_mean_run(root):
  """compute_ensemble_mean of a 50-member 1.5-degree ensemble at
  e2e_ensemble's width (seven variables at 500/700/850 hPa, 21 leads),
  with NaN members; card against CPU on two variables."""
  import torch

  from weatherbench2_torch import schema, xds
  from weatherbench2_torch.cli import compute_ensemble_mean

  t0 = time.perf_counter()
  ds = schema.mock_forecast_data(
      variables_3d=list(VARIABLES_3D), variables_2d=list(VARIABLES_2D),
      levels=(500, 700, 850), spatial_resolution_in_degrees=1.5,
      time_start="2020-01-01", time_stop="2020-01-02",
      time_resolution="12 hours", lead_start="0 days", lead_stop="10 days",
      lead_resolution="12 hours", ensemble_size=ENSEMBLE_MEMBERS)
  ds = ds.isel(time=slice(0, PREP2_ENSEMBLE_INITS))
  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED + 10)
  path = os.path.join(root, "ensemble.zarr")
  template = xds.Dataset({k: xds.stub_variable(v.dims, v.sizes, np.float32)
                          for k, v in ds.variables_dict().items()},
                         coords=dict(ds.coords_dict()))
  writer = xds.RegionWriter(path, template, chunks={"time": 1})
  for i in range(ds.sizes["time"]):
    for name, v in ds.variables_dict().items():
      shape = tuple(1 if d == "time" else v.sizes[d] for d in v.dims)
      x = torch.randn(shape, generator=gen, device="cuda")
      x[(5, ...) + PREP2_NAN_CELLS] = torch.nan  # member 5 (realization)
      writer.write_array(
          name, tuple(slice(i, i + 1) if d == "time" else slice(None)
                      for d in v.dims), x.cpu().numpy())
  writer.finish()
  out = {"write_stores_s": time.perf_counter() - t0,
         "store_gib": store_gib({"ensemble": path})}
  dst = os.path.join(root, "mean.zarr")
  flags = [f"--input_path={path}", "--time_start=2020-01-01",
           "--time_stop=2020-01-02", "--skipna"]
  out["main"] = prep2_cli(compute_ensemble_mean.main,
                          flags + [f"--output_path={dst}"])
  out["main"]["sizes"] = finite_store(dst, {"time": PREP2_ENSEMBLE_INITS})
  emit("e2e_prep2_run", run="compute_ensemble_mean", **out["main"])
  shutil.rmtree(dst)
  out["card_vs_cpu"] = twin_card_vs_cpu(
      compute_ensemble_mean.main,
      flags + ["--variables=geopotential,2m_temperature"], root, "mean")
  return out


def wide_slice_run(root):
  """slice_dataset at 0.25 degrees (e2e_derived run 3's store): two levels
  and four days, the latitude reversed by the selection (a flip on the
  card), then made increasing again by a second run, which must give the
  store's own values back; card against CPU on two variables."""
  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import slice_dataset

  t0 = time.perf_counter()
  path = write_wide_store(root)
  out = {"write_stores_s": time.perf_counter() - t0,
         "store_gib": store_gib({"wide": path})}
  flags = [f"--input_path={path}", "--sel=level_list=500+850",
           "--sel_strings=time_start=2020-01-02,time_stop=2020-01-05T18",
           "--isel=latitude_step=-1"]
  flipped = os.path.join(root, "flipped.zarr")
  back = os.path.join(root, "back.zarr")
  out["main"] = prep2_cli(slice_dataset.main,
                          flags + [f"--output_path={flipped}"])
  emit("e2e_prep2_run", run="slice_dataset", **out["main"])
  out["increasing"] = prep2_cli(slice_dataset.main, [
      f"--input_path={flipped}", f"--output_path={back}",
      "--make_dims_increasing=latitude"])
  emit("e2e_prep2_run", run="slice_dataset, make_dims_increasing",
       **out["increasing"])
  src = xds.open_zarr(path, lazy=True).sel(
      level=[500, 850], time=slice("2020-01-02", "2020-01-05T18"))
  got = xds.open_zarr(back, lazy=True)
  lat = np.asarray(xds.open_zarr(flipped).coords_dict()["latitude"].data)
  if not (np.diff(lat) < 0).all():
    raise AssertionError("the selection did not reverse the latitude")
  for k in src.keys():
    if not np.array_equal(np.asarray(xds.read(got[[k]])[k].values),
                          np.asarray(xds.read(src[[k]])[k].values),
                          equal_nan=True):
      raise AssertionError(f"{k}: flipped twice is not the store's values")
  out["round_trip"] = {"compared": len(src.keys()), "equal": GATHER_EQUAL}
  shutil.rmtree(back)
  shutil.rmtree(flipped)
  out["card_vs_cpu"] = twin_card_vs_cpu(
      slice_dataset.main,
      flags + ["--keep_variables=2m_temperature,geopotential"], root,
      "slice", equal=True)
  return out


def official_runs(root):
  """index_on_valid_time of e2e_official's forecast (valid time and lead)
  and expand_climatology of its climatology over December 2020 and
  January 2021; each card against CPU, bit for bit."""
  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import expand_climatology
  from weatherbench2_torch.cli import index_on_valid_time

  t0 = time.perf_counter()
  paths = write_official_stores(root)
  out = {"write_stores_s": time.perf_counter() - t0,
         "store_gib": store_gib(paths)}
  dst = os.path.join(root, "valid.zarr")
  flags = [f"--input_path={paths['forecast']}"]
  out["index_on_valid_time"] = prep2_cli(index_on_valid_time.main,
                                         flags + [f"--output_path={dst}"])
  emit("e2e_prep2_run", run="index_on_valid_time",
       **out["index_on_valid_time"])
  valid = xds.open_zarr(dst, lazy=True)
  first = np.asarray(xds.read(valid[["2m_temperature"]].isel(time=0))[
      "2m_temperature"].values)
  if not (np.isnan(first[1:]).all() and np.isfinite(first[0]).all()):
    raise AssertionError("the first valid time is not its lead-0 forecast "
                         "alone")
  shutil.rmtree(dst)
  out["index_on_valid_time"]["card_vs_cpu"] = twin_card_vs_cpu(
      index_on_valid_time.main, flags, root, "valid", equal=True)
  dst = os.path.join(root, "expanded.zarr")
  flags = [f"--input_path={paths['climatology']}",
           f"--time_start={PREP2_EXPAND[0]}", f"--time_stop={PREP2_EXPAND[1]}"]
  out["expand_climatology"] = prep2_cli(expand_climatology.main,
                                        flags + [f"--output_path={dst}"])
  emit("e2e_prep2_run", run="expand_climatology",
       **out["expand_climatology"])
  got = xds.open_zarr(dst, lazy=True)
  clim = xds.open_zarr(paths["climatology"], lazy=True)
  day366 = xds.read(got[["2m_temperature"]].sel(
      time=slice("2020-12-31", "2020-12-31")))["2m_temperature"].values
  want = xds.read(clim[["2m_temperature"]].sel(dayofyear=366))[
      "2m_temperature"].transpose("hour", "longitude", "latitude").values
  if not np.array_equal(np.asarray(day366), np.asarray(want)):
    raise AssertionError("31 December 2020 is not the climatology's day 366")
  shutil.rmtree(dst)
  out["expand_climatology"]["card_vs_cpu"] = twin_card_vs_cpu(
      expand_climatology.main, flags, root, "expand", equal=True)
  return out


def pcf_run(root):
  """compute_probabilistic_climatological_forecasts: 30 members drawn from
  1990-2019 for the 6-hourly inits of 1 January 2020, 15-day leads every 6
  hours, 2 m temperature and 24 h precipitation at 1.5 degrees; one member
  held to the truth at its source times; card against CPU on 2 m
  temperature and the source times, bit for bit."""
  import torch

  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import (
      compute_probabilistic_climatological_forecasts as pcf)

  t0 = time.perf_counter()
  times = []
  for year in range(PCF_YEARS[0], PCF_YEARS[1] + 2):
    times.append(np.arange(np.datetime64(f"{year}-01-01", "ns"),
                           np.datetime64(f"{year}-01-25", "ns"),
                           np.timedelta64(6, "h")))
    if year <= PCF_YEARS[1]:
      times.append(np.arange(np.datetime64(f"{year}-12-24", "ns"),
                             np.datetime64(f"{year + 1}-01-01", "ns"),
                             np.timedelta64(6, "h")))
  times = np.sort(np.concatenate(times))
  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED + 11)

  def values(name, shape, g, _):
    x = torch.randn(shape, generator=g, device="cuda")
    return 280.0 + 10.0 * x if name == "2m_temperature" else (
        1e-3 * x).clamp(min=0.0)

  path = write_grid_store(os.path.join(root, "truth.zarr"),
                          dict.fromkeys(CLIM_VARIABLES, False), times,
                          PREP_RESOLUTION, (), gen, values, 128)
  out = {"write_stores_s": time.perf_counter() - t0,
         "store_gib": store_gib({"truth": path}), "times": len(times)}
  flags = [f"--input_path={path}",
           f"--climatology_start_year={PCF_YEARS[0]}",
           f"--climatology_end_year={PCF_YEARS[1]}",
           f"--initial_time_start={PCF_INITS[0]}",
           f"--initial_time_end={PCF_INITS[1]}", "--initial_time_spacing=6h",
           "--forecast_duration=15 days", "--timedelta_spacing=6h",
           f"--ensemble_size={PCF_MEMBERS}", "--add_source_time"]
  dst = os.path.join(root, "pcf.zarr")
  out["main"] = prep2_cli(pcf.main, flags + [f"--output_path={dst}"])
  out["main"]["sizes"] = finite_store(dst, {"realization": PCF_MEMBERS,
                                            "time": 4,
                                            "prediction_timedelta": 61})
  emit("e2e_prep2_run", run="compute_probabilistic_climatological_forecasts",
       **out["main"])
  got = xds.open_zarr(dst, lazy=True)
  source = np.asarray(got["source_time"].values)[7, 2]  # (lead,)
  truth = xds.open_zarr(path, lazy=True)
  pos = np.searchsorted(np.asarray(truth.coords_dict()["time"].data),
                        source.astype("datetime64[ns]"))
  member = xds.read(got[["2m_temperature"]].isel(realization=7, time=2))
  want = xds.read(truth[["2m_temperature"]].isel(time=pos))
  if not np.array_equal(np.asarray(member["2m_temperature"].values),
                        np.asarray(want["2m_temperature"].values)):
    raise AssertionError("member 7 of init 2 is not the truth at its source "
                         "times")
  shutil.rmtree(dst)
  out["card_vs_cpu"] = twin_card_vs_cpu(
      pcf.main, flags + ["--variables=2m_temperature"], root, "pcf",
      equal=True, names=["2m_temperature", "source_time"])
  return out


def e2e_prep2_phase():
  """The nine remaining data-prep twins at full width on the card, each
  group of runs in a temporary directory of its own."""
  import torch

  for cut in PREP2_CUTS:
    print(f"e2e_prep2 cut: {cut}", flush=True)
  out = {"cuts": PREP2_CUTS}
  t0 = time.perf_counter()
  for run, fn in (("year", year_runs), ("ensemble_mean", ensemble_mean_run),
                  ("slice", wide_slice_run), ("official", official_runs),
                  ("probabilistic_climatological_forecasts", pcf_run)):
    with tempfile.TemporaryDirectory(prefix=f"wb2_chip_smoke_{run}_") as root:
      out[run] = fn(root)
    torch.cuda.empty_cache()
    emit("e2e_prep2_step", run=run, seconds=time.perf_counter() - t0)
  out["launches"] = {
      "fused_deterministic_sums": 0,
      "fused_region_sums": sum(
          out["year"][name]["launches"]["fused_region_sums"]
          for name in ("compute_averages", "compute_statistical_moments"))}
  emit("e2e_prep2", **out)
  return out

def e2e_derived_phase():
  """Derived variables, the probabilistic-climatology baseline and the
  spectra pipeline, each at full width: three runs, each in a temporary
  directory of its own."""
  import torch

  out = {"cut": "run 1: the first 32 inits of January 2020 (as e2e_official); "
                "run 2: the first 4 inits x 21 leads in chunks of 2, a truth "
                "of 1-15 January of each year 1990-2020 (the only days the "
                "valid times select); run 3: the first 7 days of 2020, not "
                "the year"}
  t0 = time.perf_counter()
  for run, fn in (("run1", derived_run), ("run2", prob_clim_run),
                  ("run3", spectra_run)):
    with tempfile.TemporaryDirectory(prefix=f"wb2_chip_smoke_{run}_") as root:
      out[run] = fn(root)
    torch.cuda.empty_cache()
    emit("e2e_derived_step", run=run, seconds=time.perf_counter() - t0)
  emit("e2e_derived", **out)
  return out


# -- e2e_multi ----------------------------------------------------------------

# WB2's published 64 x 32 grid (5.625 degrees, no poles): its 32 latitudes
# split in two bands, where 121 (1.5 degrees) and 721 (0.25) do not
GRID64_LATITUDES = np.linspace(-87.1875, 87.1875, 32)
GRID64 = (64, 32)
# the kernels' rows in a rank of the 1 x 2 world on that grid, for a
# 16-init chunk of the three official configs (recorded from the world on
# the CPU): kernel 1 per three-level and surface variable; kernel 2 for
# mse (18 variable-levels and 3 wind-vector levels), ACC (both row groups
# at once) and SEEPS (NaN cells)
SPATIAL_DET_ROWS = (1008, 336)
SPATIAL_REGION_ROWS = ((7056, False), (18144, False), (336, True))
# two ranks on the one card talk over gloo (NCCL takes one rank a card)
SHARED_CARD = ["cuda:0", "cuda:0"]
CARD = "cuda"
# launches a rank makes for a 16-init chunk of the three official configs
# when it holds 8 of the inits, written down in PERF.md before the first
# run: kernel 1 as with 16 (once per variable and config); kernel 2 once
# fewer for each ACC (its rows fit one 1 GiB group)
MULTI_LAUNCHES = (16, 7)
ENSEMBLE64_MEMBERS = 10
ENSEMBLE64_VARIABLES = ("geopotential", "2m_temperature")
# bfloat16 keeps about three significant digits: an MSE moves by a few
# parts in a thousand of its largest value (a bias or a SEEPS, near zero or
# by category, can move by much more, and is only printed)
TRANSFER_MSE_RTOL = 1e-2


def multi_rank_counts(stats, expect_chunks, per_chunk=None, kernel_1=True):
  """A world's per-rank counts (rank 0 returns every rank's); raises
  unless every rank launched kernel 2, and kernel 1 where its metrics run,
  as planned where given."""
  if stats["chunks"] != expect_chunks:
    raise AssertionError(f"{stats['chunks']} chunks, expected "
                         f"{expect_chunks}")
  ranks = []
  for r, c in enumerate(stats["ranks"]):
    launches = (c["fused_deterministic_sums_launches"],
                c["fused_region_sums_launches"])
    if min(launches[not kernel_1:]) < 1 or per_chunk is not None and (
        launches != tuple(n * expect_chunks for n in per_chunk)):
      raise AssertionError(f"rank {r} launched {launches} in "
                           f"{expect_chunks} chunks, expected {per_chunk} a "
                           "chunk")
    ranks.append({"rank": r, "read_gib": c["read_bytes"] / 2**30,
                  "h2d_gib": c["h2d_bytes"] / 2**30,
                  "wait_host_s": c["wait_host_s"],
                  "gathered_gib": c["gathered_bytes"] / 2**30,
                  "fused_deterministic_sums": launches[0],
                  "fused_region_sums": launches[1]})
  return {"wall_s": stats["wall_s"], "chunks": stats["chunks"],
          "read_gib": stats["read_bytes"] / 2**30,
          "h2d_gib": stats["h2d_bytes"] / 2**30,
          "wait_host_s_max": stats["wait_host_s"], "ranks": ranks}


def equal_results(got, want, what):
  """Raise unless two runs' results are equal bit for bit."""
  n = 0
  for cname in want:
    for k in want[cname].keys():
      w = want[cname][k].values
      g = got[cname][k].transpose(*want[cname][k].dims).values
      if not np.array_equal(g, w, equal_nan=True):
        raise AssertionError(f"{what}: {cname}/{k} differs")
      n += 1
  return {"compared": n, "bit_for_bit": True}


def write_ensemble64(root, gen):
  """A 10-member ensemble of z (500, 850 hPa) and t2m on the 64 x 32 grid,
  8 12-hourly inits x 21 leads, normal members around a truth's scale."""
  from weatherbench2_torch import schema, xds

  ds = schema.mock_forecast_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature"],
      levels=(500, 850), spatial_resolution_in_degrees=5.625,
      time_start="2020-01-01", time_stop="2020-01-05",
      time_resolution="12 hours", lead_start="0 days", lead_stop="10 days",
      lead_resolution="12 hours", ensemble_size=ENSEMBLE64_MEMBERS)
  ds = ds.isel(latitude=slice(0, 32)).assign_coords(
      latitude=GRID64_LATITUDES)
  ds = ds.copy(data={k: gen.standard_normal(v.shape, dtype=np.float32)
                     for k, v in ds.variables_dict().items()})
  path = os.path.join(root, "ensemble64.zarr")
  xds.to_zarr(ds, path)
  return path


def ensemble64_run(forecast, truth, out_dir, device=None, mesh=None):
  """The ensemble spread and skill (the two metrics spread/skill plots
  read) of the 64 x 32 ensemble, three regions, chunks of 4 inits."""
  from weatherbench2_torch import config, evaluation, metrics

  ens = dict(ensemble_dim="realization")
  cfgs = {"spread_skill": config.Eval(
      metrics={"ensemble_stddev": metrics.EnsembleStddevSqrtBeforeTimeAvg(
          **ens),
               "ensemble_mean_rmse": (
                   metrics.EnsembleMeanRMSESqrtBeforeTimeAvg(**ens))},
      regions=three_regions())}
  dc = config.Data(
      selection=config.Selection(variables=list(ENSEMBLE64_VARIABLES),
                                 levels=[500, 850],
                                 time_slice=slice("2020-01-01",
                                                  "2020-01-04T12")),
      paths=config.Paths(forecast=forecast, obs=truth, output_dir=out_dir),
      by_init=True)
  return evaluation.evaluate_with_mesh(dc, cfgs,
                                       input_chunks={"init_time": 4},
                                       device=device, mesh=mesh)


def spatial_rank(devices, grid_argv, official_argv, ensemble_args, n_lat):
  """Every rank of the 1 x 2 batch x spatial world on ``devices``: the
  official configs on the 64 x 32 grid, the ensemble, and the refusal of
  the official grid's ``n_lat`` latitudes (before any collective, in both
  ranks)."""
  from weatherbench2_torch.cli import evaluate as cli
  from weatherbench2_torch.parallel import mesh as mesh_lib

  mesh = mesh_lib.make_mesh(axis_names=("batch", "spatial"),
                            devices=devices, axis_sizes=[1, 2])
  out = {"official": cli.run(cli.build_parser().parse_args(grid_argv), mesh),
         "ensemble": ensemble64_run(*ensemble_args, mesh=mesh)}
  try:
    cli.run(cli.build_parser().parse_args(official_argv), mesh)
  except ValueError as err:  # the refusal this world checks
    out["refusal"] = str(err)
  if f"does not divide the latitude size {n_lat}" not in out.get(
      "refusal", ""):
    raise AssertionError(f"{n_lat} latitudes were not refused: {out}")
  return out


def dying_rank(devices, argv, ckpt):
  """A rank of a 2-rank world on ``devices``; rank 0 dies right after its
  second state file is in place, which ends the world."""
  import torch.distributed as dist

  from weatherbench2_torch.cli import evaluate as cli

  if dist.get_rank() == 0:
    real, states = os.replace, []

    def replace(src, dst):
      real(src, dst)
      if dst.startswith(ckpt):
        states.append(dst)
        if len(states) == 2:
          os._exit(9)  # the process dies here, with no clean-up at all

    os.replace = replace
  cli.run_rank(argv, devices)


def world_of_one_rank(devices, full_argv, resume_argv):
  """The one rank of a world of one on ``devices``: run 1's configuration,
  then a killed run resumed from its state file."""
  from weatherbench2_torch.cli import evaluate as cli

  return cli.run_rank(full_argv, devices), cli.run_rank(resume_argv, devices)


def relative_deviation(got, want):
  """{metric: max |got - want| / max |want|} over the variables of every
  config (of a variable, per metric)."""
  worst = {}
  for cname in want:
    names = [str(m) for m in np.asarray(
        want[cname].coords_dict()["metric"].data)]
    for k in want[cname].keys():
      for i, m in enumerate(names):
        w = np.asarray(want[cname][k].isel(metric=i).values, np.float64)
        g = np.asarray(got[cname][k].isel(metric=i).transpose(
            *want[cname][k].isel(metric=i).dims).values, np.float64)
        if np.isfinite(w).any():
          worst[m] = max(worst.get(m, 0.0), float(
              np.nanmax(np.abs(g - w)) / np.nanmax(np.abs(w))))
  return worst


def visualization_card_vs_cpu(bf16, f32, ensemble):
  """compute_relative_metrics and compute_spread_skill_ratio on results
  whose payloads are on the card, against the same on the host; and the
  plotting functions' named ImportError where matplotlib is absent."""
  import torch

  from weatherbench2_torch import visualization, xds

  card = torch.device(CARD)
  pair = {"float32": f32["deterministic"], "bfloat16": bf16["deterministic"]}
  rel_card = visualization.compute_relative_metrics(
      xds.to_device(pair, card), "float32", "mse")["bfloat16"]
  rel_cpu = visualization.compute_relative_metrics(pair, "float32",
                                                   "mse")["bfloat16"]
  out = {"relative_mse": compare_results({"r": rel_card}, {"r": rel_cpu},
                                         "relative metrics, card vs CPU")}
  ratios = {}
  for v in ensemble.keys():
    got = visualization.compute_spread_skill_ratio(
        xds.to_device(ensemble[v], card))
    want = visualization.compute_spread_skill_ratio(ensemble[v])
    ratios[v] = hold(np.asarray(got.values), np.asarray(want.values),
                     f"spread/skill of {v}, card vs CPU")
    ratios[v]["mean"] = float(np.nanmean(want.values))
  out["spread_skill"] = ratios
  try:
    import matplotlib  # noqa: F401
  except ImportError:
    try:
      visualization.plot_timeseries(pair, "mse", "geopotential", level=500)
    except ImportError as err:  # the named error this check wants
      out["plot_without_matplotlib"] = str(err)
    if "matplotlib" not in out.get("plot_without_matplotlib", ""):
      raise AssertionError("plotting without matplotlib did not name it")
  else:
    out["plot_without_matplotlib"] = "matplotlib is installed here"
  return out


def e2e_multi_phase():
  """Multi-rank evaluation and the bfloat16 transfer mode on the card."""
  import torch

  from weatherbench2_torch import xds
  from weatherbench2_torch.cli import evaluate as cli
  from weatherbench2_torch.parallel import mesh as mesh_lib

  out = {"configs": OFFICIAL_CONFIGS.split(","), "inits": OFFICIAL_INITS,
         "shared_card_backend": mesh_lib.backend_for(SHARED_CARD),
         "world1_backend": mesh_lib.backend_for(["cuda:0"]),
         "predicted_launches_per_rank_chunk": dict(zip(
             ("fused_deterministic_sums", "fused_region_sums"),
             MULTI_LAUNCHES)), "tolerance": E2E_TOLERANCE}
  steps = {}
  with tempfile.TemporaryDirectory(prefix="wb2_chip_smoke_multi_") as root:
    t0 = time.perf_counter()
    paths = write_official_stores(os.path.join(root, "official"))
    grid = write_official_stores(os.path.join(root, "grid64"),
                                 resolution=5.625,
                                 latitudes=GRID64_LATITUDES)
    ensemble = write_ensemble64(root, np.random.default_rng(SEED + 8))
    steps["write_stores_s"] = time.perf_counter() - t0
    configs = f"--eval_configs={OFFICIAL_CONFIGS}"
    chunks = "--input_chunks=init_time=16"

    def args(out_dir, *more, stop="2020-01-16", stores=paths):
      return official_args(stores, os.path.join(root, out_dir), stop,
                           configs, chunks, *more)

    # (1) the main path without a mesh (as a world of one in step 5)
    t0 = time.perf_counter()
    out["single"] = run_cli(args("single"), 2, OFFICIAL_LAUNCHES)
    single = open_official_results(os.path.join(root, "single"),
                                   OFFICIAL_INITS)
    steps["single_s"] = time.perf_counter() - t0

    # (2) two gloo ranks on the one card, a batch world
    t0 = time.perf_counter()
    world2 = mesh_lib.run_ranks(cli.run_rank, 2, devices=SHARED_CARD,
                                args=(args("world2", "--n_devices=2"),
                                      SHARED_CARD), timeout=600)
    out["world2"] = multi_rank_counts(world2, 2, MULTI_LAUNCHES)
    out["world2_vs_single"] = compare_results(
        open_official_results(os.path.join(root, "world2"), OFFICIAL_INITS),
        single, "2 ranks against no mesh")
    steps["world2_s"] = time.perf_counter() - t0

    # (3) a 1 x 2 batch x spatial world on the 64 x 32 grid, against one
    # device; the 121 latitudes of 1.5 degrees refused
    t0 = time.perf_counter()
    # at 64 x 32 ACC's rows of 16 inits fit one group, as 8 do at 121 x 240
    grid_single = run_cli(args("grid_single", stores=grid), 2,
                          MULTI_LAUNCHES)
    t1 = time.perf_counter()
    cli.main(args("grid_cpu", "--device=cpu", stores=grid))
    grid_cpu_s = time.perf_counter() - t1
    ens_cpu = ensemble64_run(ensemble, grid["truth"],
                             os.path.join(root, "ens_cpu"), device="cpu")
    n_lat = xds.open_zarr(paths["truth"]).sizes["latitude"]
    spatial = mesh_lib.run_ranks(
        spatial_rank, 2, devices=SHARED_CARD,
        args=(SHARED_CARD, args("grid_world", "--n_devices=2", stores=grid),
              args("refused", "--n_devices=2"),
              (ensemble, grid["truth"], os.path.join(root, "ens_world")),
              n_lat), timeout=600)
    out["spatial_single"] = grid_single
    out["spatial"] = multi_rank_counts(spatial["official"], 2)
    out["spatial_vs_single"] = compare_results(
        open_official_results(os.path.join(root, "grid_world"),
                              OFFICIAL_INITS, grid=GRID64),
        open_official_results(os.path.join(root, "grid_single"),
                              OFFICIAL_INITS, grid=GRID64),
        "1 x 2 world against one device, 64 x 32")
    # and against the CPU, where no kernel runs
    out["spatial_vs_cpu"] = compare_results(
        open_official_results(os.path.join(root, "grid_world"),
                              OFFICIAL_INITS, grid=GRID64),
        open_official_results(os.path.join(root, "grid_cpu"),
                              OFFICIAL_INITS, grid=GRID64),
        "1 x 2 world against the CPU, 64 x 32")
    out["spatial_cpu_wall_s"] = grid_cpu_s
    out["spatial_refusal"] = spatial["refusal"]
    # the probabilistic plan: kernel 2 only
    out["ensemble_spatial"] = multi_rank_counts(spatial["ensemble"], 2,
                                                kernel_1=False)
    ens_card = xds.open_netcdf(os.path.join(root, "ens_world",
                                            "spread_skill.nc"))
    ens_host = xds.open_netcdf(os.path.join(root, "ens_cpu",
                                            "spread_skill.nc"))
    out["ensemble_card_vs_cpu"] = compare_results(
        {"e": ens_card}, {"e": ens_host}, "ensemble, 1 x 2 world vs CPU")
    out["ensemble_cpu_wall_s"] = ens_cpu["wall_s"]
    steps["spatial_s"] = time.perf_counter() - t0

    # (4) a 2-rank world killed after its second chunk
    t0 = time.perf_counter()
    more = ("--eval_configs=deterministic", "--input_chunks=init_time=8")
    ckpt = os.path.join(root, "state")
    resumable = official_args(paths, os.path.join(root, "resumed"),
                              "2020-01-16", *more, f"--checkpoint_path={ckpt}",
                              "--checkpoint_every=1")
    killed = official_args(paths, os.path.join(root, "killed"), "2020-01-16",
                           *more, f"--checkpoint_path={ckpt}",
                           "--checkpoint_every=1", "--n_devices=2")
    try:
      mesh_lib.run_ranks(dying_rank, 2, devices=SHARED_CARD,
                         args=(SHARED_CARD, killed, ckpt), timeout=600)
    except RuntimeError as err:  # the death this step causes
      out["killed"] = str(err)
    if "rank 0: exit code 9" not in out.get("killed", ""):
      raise AssertionError(f"the world did not die as planned: {out}")
    state = streaming_state(ckpt + ".deterministic")
    steps["killed_s"] = time.perf_counter() - t0

    # (5) a world of one on the card (NCCL): run 1's configuration, equal
    # to step 1 bit for bit, then the killed run resumed as one rank
    t0 = time.perf_counter()
    world1, resumed = mesh_lib.run_ranks(
        world_of_one_rank, 1, devices=SHARED_CARD[:1],
        args=(SHARED_CARD[:1], args("world1", "--n_devices=1"),
              resumable + ["--n_devices=1"]), timeout=600)
    out["world1"] = multi_rank_counts(world1, 2, OFFICIAL_LAUNCHES)
    out["world1_vs_single"] = equal_results(
        open_official_results(os.path.join(root, "world1"), OFFICIAL_INITS),
        single, "--n_devices=1 against no mesh")
    out["kill_and_resume"] = {
        "state": state, "resumed": multi_rank_counts(resumed, 2),
        "resumed_vs_world2": compare_results(
            {"deterministic": xds.open_netcdf(os.path.join(
                root, "resumed", "deterministic.nc"))},
            {"deterministic": xds.open_netcdf(os.path.join(
                root, "world2", "deterministic.nc"))},
            "resumed as one rank against the 2-rank world")}
    steps["world1_and_resume_s"] = time.perf_counter() - t0

    # (6) the bfloat16 transfer mode on run 1's configuration; card
    # against CPU on the first 8 inits (one chunk)
    t0 = time.perf_counter()
    os.environ["WB2_TRANSFER_DTYPE"] = "bfloat16"
    try:
      bf16 = run_cli(args("bf16"), 2, OFFICIAL_LAUNCHES)
      first8 = ("--input_chunks=init_time=8",)
      bf16_first = run_cli(args("bf16_first8", *first8, stop="2020-01-04T12"),
                           1, MULTI_LAUNCHES)
      cli.main(args("bf16_first8_cpu", *first8, "--device=cpu",
                    stop="2020-01-04T12"))
    finally:
      del os.environ["WB2_TRANSFER_DTYPE"]
    bf16_results = open_official_results(os.path.join(root, "bf16"),
                                         OFFICIAL_INITS)
    out["bfloat16"] = {
        "run": bf16, "h2d_over_float32": bf16["h2d_gib"]
        / out["single"]["h2d_gib"],
        "max_relative_deviation_from_float32_by_metric": relative_deviation(
            bf16_results, single),
        "first8_card": bf16_first,
        "first8_card_vs_cpu": compare_results(
            open_official_results(os.path.join(root, "bf16_first8"), 8),
            open_official_results(os.path.join(root, "bf16_first8_cpu"), 8),
            "bfloat16, card vs CPU")}
    deviation = out["bfloat16"][
        "max_relative_deviation_from_float32_by_metric"]
    if not 0 < deviation["mse"] < TRANSFER_MSE_RTOL:
      raise AssertionError(f"bfloat16 deviation {out['bfloat16']}")
    steps["bfloat16_s"] = time.perf_counter() - t0

    # (7) the visualization's computing functions, card against CPU
    ens_vars = xds.open_netcdf(os.path.join(root, "ens_world",
                                            "spread_skill.nc"))
    out["visualization"] = visualization_card_vs_cpu(
        bf16_results, single, ens_vars)
    torch.cuda.empty_cache()
  out["steps"] = steps
  emit("e2e_multi", **out)
  return out


def streaming_state(path):
  from weatherbench2_torch.parallel import streaming

  state = streaming.StreamingState.load(path)
  if (state.chunk_index, state.chunk_size, state.total) != (
      2, 8, OFFICIAL_INITS):
    raise AssertionError(f"state at chunk {state.chunk_index} of "
                         f"{state.chunk_size} in {state.total}")
  return {"chunk_index": state.chunk_index, "bytes": os.path.getsize(path)}



PHASES = {"kernels": kernels_phase, "e2e": e2e_phase, "e2e025": e2e025_phase,
          "e2e_official": e2e_official_phase,
          "e2e_ensemble": e2e_ensemble_phase,
          "e2e_derived": e2e_derived_phase, "e2e_prep": e2e_prep_phase,
          "e2e_prep2": e2e_prep2_phase, "e2e_multi": e2e_multi_phase}


def main(argv):
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

  # every phase with no arguments (as the contract runs it); a list of phase
  # names runs those only and prints no kernel summary
  wanted = set(argv) or set(PHASES)
  if not wanted <= set(PHASES):
    print(f"chip_smoke: phases are {PHASES}", file=sys.stderr)
    return 2
  results, seconds = {}, {}
  for name in PHASES:
    if name in wanted:
      t0 = time.perf_counter()
      results[name] = PHASES[name]()
      seconds[f"{name}_s"] = time.perf_counter() - t0
  emit("times", **seconds, total_s=time.perf_counter() - t_start)
  if wanted != set(PHASES):
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0
  cases = results["kernels"]
  e2e, e2e13 = results["e2e"]
  e2e025 = results["e2e025"]
  official_run = results["e2e_official"]
  ensemble_run = results["e2e_ensemble"]
  derived_runs = results["e2e_derived"]
  prep2 = results["e2e_prep2"]
  multi = results["e2e_multi"]

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
        "launches_e2e_official": official_run["main"]["launches"][name],
        "launches_e2e_ensemble": sum(
            ensemble_run[run]["launches"][name] for run in ENSEMBLE_RUNS),
        "launches_e2e_derived": sum(
            derived_runs[run]["main"]["launches"][name]
            for run in ("run1", "run2")),
        "launches_e2e_prep2": prep2["launches"][name],
        # both ranks of the 2-rank world on the card
        "launches_e2e_multi": sum(r[name] for r in multi["world2"]["ranks"]),
        "max_abs_err": max(v["max_abs_err"] for v in c["errors"].values()),
        "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"], "library_call": c["library_call"],
        "official_shape": o["shape"] + [o["regions"]],
        "official_ms": o["kernel_ms"], "official_bound_ms": o["bound_ms"],
        "official_library_ms": o["library_ms"]})
  print(json.dumps({"kernels": summary}), flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))

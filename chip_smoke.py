#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold it to its references.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits non-zero without the final line):

  device   the card as nvidia-smi and torch report it, torch/CUDA versions;
  build    nvcc build of csrc/reductions.cu (ptxas register report on
           stderr);
  kernels  each CUDA kernel against its plain PyTorch version on the card,
           at the main path's shapes and the official 0.25-degree shape,
           without and with NaNs; CUDA-event medians of the kernel, the
           plain version and one torch.matmul yardstick, beside the bound;
  e2e      the bench suite (MSE/RMSE/Bias/ACC of z500/700/850 and t2m, three
           regions, by init) through evaluation.evaluate_with_mesh at
           240x121 over January 2020 (62 inits x 21 leads), with the
           kernels' launch counters read around the run, then the first 16
           inits on the card and on the CPU, compared.

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
RTOL = 1e-5
TIMED_LAUNCHES = 25
SEED = 20200101
SOURCE = "weatherbench2_torch/csrc/reductions.cu"


def emit(phase, **fields):
  print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


# -- kernels ------------------------------------------------------------------


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
      w, [r.mask_weights(lat, lon) for r in regions], n_lon)


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


def det_inputs(b, l, gen, nans):
  import torch

  f = torch.randn(b, l, generator=gen, device="cuda")
  t = torch.randn(b, l, generator=gen, device="cuda")
  c = 0.3 * torch.randn(b, l, generator=gen, device="cuda")
  if nans:
    f[1] = float("nan")  # whole NaN rows
    t[b // 2] = float("nan")
    for x, p in ((f, 0.01), (t, 0.01), (c, 0.005)):
      x[torch.rand(b, l, generator=gen, device="cuda") < p] = float("nan")
  return f, t, c


def det_scale(f, t, c, w):
  """Σ_l |W·stat| of each output: the magnitude the error is held to."""
  import torch

  nan = torch.isnan(f) | torch.isnan(t)
  if c is not None:
    nan |= torch.isnan(c)
  f0 = torch.where(nan, 0.0, f)
  t0 = torch.where(nan, 0.0, t)
  c0 = torch.zeros_like(f0) if c is None else torch.where(nan, 0.0, c)
  aw = w.abs().T
  stats = (f0 - t0, (f0 - t0) ** 2, f0 - t0, (f0 - c0) * (t0 - c0),
           (f0 - c0) ** 2, (t0 - c0) ** 2)
  sums = torch.stack([s.abs() @ aw for s in stats]).permute(0, 2, 1)
  ones = torch.ones_like(f0)
  return sums, (ones @ aw).T, (ones @ (w > 0).float().T).T


def region_scale(x, w):
  import torch

  x0 = torch.nan_to_num(x.abs())
  ones = torch.ones_like(x0)
  return (x0 @ w.abs().T).T, (ones @ w.abs().T).T, (ones @ (w > 0).float().T).T


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


def kernel_case(name, shape, n_regions, grid, nans, with_clim, gen):
  """One kernel at one shape against its plain version; timings."""
  import torch

  from weatherbench2_torch import ops

  rows, cols = shape
  w = torch.as_tensor(region_weights(*grid, n_regions), device="cuda")
  assert w.shape == (n_regions, cols)
  if name == "fused_deterministic_sums":
    sets = [det_inputs(rows, cols, gen, nans) for _ in range(2)]
    if not with_clim:
      sets = [(f, t, None) for f, t, _ in sets]
    kernel = lambda f, t, c: ops.fused_deterministic_sums(f, t, c, w)
    plain = lambda f, t, c: ops.fused_deterministic_sums_plain(f, t, c, w)
    library = lambda f, t, c: torch.matmul(f, w.T)
    scale = det_scale(*sets[0], w)
    names = ("sums", "wsum_valid", "nan_w")
    n_in = 3 if with_clim else 2
    stat_rows = 8
    flops_per_cell = 16 * n_regions + 12
  else:
    sets = []
    for _ in range(2):
      x = torch.randn(rows, cols, generator=gen, device="cuda")
      if nans:
        x[0] = float("nan")
        x[torch.rand(rows, cols, generator=gen, device="cuda") < 0.01] = (
            float("nan"))
      sets.append((x,))
    kernel = lambda x: ops.fused_region_sums(x, w)
    plain = lambda x: ops.fused_region_sums_plain(x, w)
    library = lambda x: torch.matmul(x, w.T)
    scale = region_scale(sets[0][0], w)
    names = ("sums", "wsum_valid", "nan_w")
    n_in = 1
    stat_rows = 3
    flops_per_cell = 6 * n_regions + 3
  got = kernel(*sets[0])
  torch.cuda.synchronize()
  report = compare(got, plain(*sets[0]), scale, names)
  nbytes = 4 * (n_in * rows * cols + n_regions * cols
                + stat_rows * n_regions * rows)
  flops = rows * cols * flops_per_cell
  bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
  result = {
      "kernel": name, "shape": list(shape), "regions": n_regions,
      "nans": nans, "clim": with_clim if n_in != 1 else None,
      "errors": report,
      "tolerance": f"|kernel-plain| <= {RTOL}*(|plain| + sum|W*stat|): "
                   "both float32, summed in another order",
      "kernel_ms": cuda_time_ms(kernel, sets),
      "plain_ms": cuda_time_ms(plain, sets),
      "library_ms": cuda_time_ms(library, sets),
      "library_call": "torch.matmul(x, W.T), fp32, TF32 off: the weighted "
                      "sums of one statistic only, a yardstick",
      "bound_ms": bound_ms,
      "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                   >= flops / FP32_FLOPS_PER_S else "operations"),
      "bound_basis": f"{nbytes} bytes at {HBM_BYTES_PER_S:.3g} B/s, "
                     f"{flops} flop at {FP32_FLOPS_PER_S:.3g} flop/s "
                     "(H100 SXM data sheet)",
  }
  emit("kernels", **result)
  del sets
  torch.cuda.empty_cache()
  return result


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
        True, gen)
    cases[("region", "main", nans)] = kernel_case(
        "fused_region_sums", (4032, 240 * 121), 3, bench, nans, None, gen)
    cases[("region", "official", nans)] = kernel_case(
        "fused_region_sums", (126, 1440 * 721), 13, official, nans, None,
        gen)
  after = (ops.fused_deterministic_sums.launches,
           ops.fused_region_sums.launches)
  emit("kernels", launches_while_comparing={
      "fused_deterministic_sums": after[0] - before[0],
      "fused_region_sums": after[1] - before[1]})
  return cases


# -- e2e ----------------------------------------------------------------------


def write_stores(root):
  """Random January 2020 stores at 240x121, written block by block."""
  from weatherbench2_torch import schema, xds

  specs = dict(variables_3d=["geopotential"], variables_2d=["2m_temperature"],
               levels=(500, 700, 850), spatial_resolution_in_degrees=1.5)
  truth = schema.mock_truth_data(time_start="2020-01-01",
                                 time_stop="2020-02-11",
                                 time_resolution="6 hours", **specs)
  forecast = schema.mock_forecast_data(
      time_start="2020-01-01", time_stop="2020-02-01",
      time_resolution="12 hours", lead_start="0 days", lead_stop="10 days",
      lead_resolution="12 hours", **specs)
  clim = schema.mock_hourly_climatology_data(hour_interval=6, **specs)
  rng = np.random.default_rng(SEED)
  paths = {}
  for name, ds, dim, block, chunks in (
      ("truth", truth, "time", 124, {"time": 124}),
      ("forecast", forecast, "time", 16,
       {"time": 16, "prediction_timedelta": -1}),
      ("climatology", clim, "dayofyear", 92, {"dayofyear": 92})):
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


def bench_suite(paths, out_dir, time_slice):
  from weatherbench2_torch import config, metrics, xds
  from weatherbench2_torch.regions import ExtraTropicalRegion, SliceRegion

  data_config = config.Data(
      selection=config.Selection(
          variables=["geopotential", "2m_temperature"],
          levels=[500, 700, 850], time_slice=time_slice),
      paths=config.Paths(forecast=paths["forecast"], obs=paths["truth"],
                         climatology=paths["climatology"],
                         output_dir=out_dir),
      by_init=True)
  eval_configs = {"deterministic": config.Eval(
      metrics={"mse": metrics.MSE(), "rmse": metrics.RMSESqrtBeforeTimeAvg(),
               "bias": metrics.Bias(),
               "acc": metrics.ACC(
                   climatology=xds.open_zarr(paths["climatology"]))},
      regions={"global": SliceRegion(),
               "tropics": SliceRegion(lat_slice=slice(-20, 20)),
               "extra-tropics": ExtraTropicalRegion()})}
  return data_config, eval_configs


def check_results(path, n_leads):
  from weatherbench2_torch import xds

  ds = xds.open_netcdf(path)
  shapes = {k: tuple(ds[k].shape) for k in ds.keys()}
  want = {"geopotential": (4, 3, n_leads, 3), "2m_temperature": (4, 3, n_leads)}
  if shapes != want:
    raise AssertionError(f"results shapes {shapes}, expected {want}")
  for k in ds.keys():
    if not np.isfinite(ds[k].values).all():
      raise AssertionError(f"non-finite results in {k}")
  return ds


def profiled_run(paths, root, time_slice):
  """The same run under torch.profiler: device time by kind, and the
  device's busy share of the wall (kernels and copies on either stream)."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  from weatherbench2_torch import evaluation

  dc, cfgs = bench_suite(paths, os.path.join(root, "profiled"), time_slice)
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    stats = evaluation.evaluate_with_mesh(dc, cfgs,
                                          input_chunks={"init_time": 16})
    torch.cuda.synchronize()
  by_name = {}
  for e in prof.key_averages():
    us = getattr(e, "self_device_time_total", 0) or 0
    if us > 0:
      by_name[e.key] = us
  copy_us = sum(v for k, v in by_name.items() if k.lower().startswith(
      ("memcpy", "memset")))
  kernel_us = sum(by_name.values()) - copy_us
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
  return {
      "wall_s": stats["wall_s"],
      "device_kernel_s": kernel_us / 1e6,
      "device_copy_s": copy_us / 1e6,
      "kernel_busy_share": kernel_us / 1e6 / stats["wall_s"],
      "top_device_ops_ms": {k: v / 1e3 for k, v in top},
  }


def e2e_phase():
  import torch

  from weatherbench2_torch import evaluation, ops, xds

  out = {}
  with tempfile.TemporaryDirectory(prefix="wb2_chip_smoke_") as root:
    t0 = time.perf_counter()
    paths = write_stores(root)
    out["write_stores_s"] = time.perf_counter() - t0
    out["store_gib"] = sum(
        os.path.getsize(os.path.join(d, f))
        for p in paths.values() for d, _, fs in os.walk(p) for f in fs) / 2**30
    january = slice("2020-01-01", "2020-01-31")
    dc, cfgs = bench_suite(paths, os.path.join(root, "gpu"), january)

    # the main path: counters read just around it
    ops.fused_deterministic_sums.launches = 0
    ops.fused_region_sums.launches = 0
    torch.cuda.synchronize()
    stats = evaluation.evaluate_with_mesh(dc, cfgs,
                                          input_chunks={"init_time": 16})
    launches = {"fused_deterministic_sums":
                ops.fused_deterministic_sums.launches,
                "fused_region_sums": ops.fused_region_sums.launches}
    chunks = stats["chunks"]
    if launches != {"fused_deterministic_sums": 2 * chunks,
                    "fused_region_sums": chunks}:
      raise AssertionError(f"launches {launches} for {chunks} chunks: "
                           "expected 2 and 1 per chunk")
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

    # the first 16 inits, on the card and on the CPU
    first16 = slice("2020-01-01", "2020-01-08")
    walls = {}
    results = {}
    for dev in ("cuda", "cpu"):
      dcx, cfgx = bench_suite(paths, os.path.join(root, f"first16_{dev}"),
                              first16)
      s = evaluation.evaluate_with_mesh(dcx, cfgx, device=dev,
                                        input_chunks={"init_time": 16})
      walls[dev] = s["wall_s"]
      results[dev] = check_results(
          os.path.join(root, f"first16_{dev}", "deterministic.nc"), 21)
    errs = {}
    for k in results["cpu"].keys():
      want = np.asarray(results["cpu"][k].values, np.float64)
      got = np.asarray(results["cuda"][k].transpose(
          *results["cpu"][k].dims).values, np.float64)
      err = np.abs(got - want)
      bound = RTOL * np.abs(want) + RTOL * np.abs(want).max()
      errs[k] = {"max_abs_err": float(err.max()),
                 "max_err_over_bound": float((err / bound).max())}
      if (err > bound).any():
        raise AssertionError(f"card vs CPU results differ in {k}: {errs[k]}")
    out["first16"] = {
        "wall_s": walls, "errors": errs,
        "tolerance": f"rtol={RTOL} + atol={RTOL}*max|cpu| per variable: "
                     "float32 sums in another order"}
  emit("e2e", **out)
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
  e2e = e2e_phase()
  t_e2e = time.perf_counter() - t0

  summary = []
  for name, key, replaces in (
      ("fused_deterministic_sums", ("det", "main", False, False),
       "weatherbench2_tpu/ops/reductions.py:151"),
      ("fused_region_sums", ("region", "main", False),
       "weatherbench2_tpu/ops/reductions.py:366")):
    c = cases[key]
    summary.append({
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": replaces, "launches": e2e["launches"][name],
        "max_abs_err": max(v["max_abs_err"] for v in c["errors"].values()),
        "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"]})
  emit("times", kernels_s=t_kernels, e2e_s=t_e2e,
       total_s=time.perf_counter() - t_start)
  print(json.dumps({"kernels": summary}), flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())

"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

  python3 portbench/run.py --workload det15-lz4 --seed 7 --seconds 10 \
      --trace 0

A cell names a configuration (``portbench/configs/``) and a traffic mix
(``portbench/traffic/``); the configuration names its job kind
(``portbench/jobs/<kind>.py``) and its reference
(``portbench/reference/<kind>.py``); a per-layer metric ``<name>[.<form>]``
is read by ``portbench/metrics/<name>.py``.  A run:

1. set-up (``setup_s``, from the start of this script): imports and the
   CUDA context, the benchmark's codec, the cell's stores drawn on the card
   from ``--seed`` and written under ``$TMPDIR`` by the benchmark's own
   writer, one warm-up job at the cell's shapes (which builds the port's
   kernels and codec into the checkout's ``build/``);
2. the window: whole jobs back to back, each writing its results into a
   fresh directory; it closes at the end of the first job that ends after
   ``--seconds``.  The rate is the work of every job completed over the
   whole window; ``job_peak_hbm_gib`` the most device memory allocated at
   once in it.  With ``--trace 1`` the window runs under
   ``torch.profiler`` and the per-layer metrics are reported instead of the
   end-to-end ones;
3. after the window, the last job's results are held to the reference.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``,
``breakdown`` too) and, last, ``checks``: each number compared with its
limit, also printed as the last lines of standard error.  Without a CUDA
card, or with JAX loaded, the run exits non-zero and prints no result.
"""
import time

T0 = time.perf_counter()

# pylint: disable=wrong-import-position
import argparse
import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
  if p not in sys.path:
    sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "weatherbench2_tpu")


def load_module(path: Path, name: str):
  spec = importlib.util.spec_from_file_location(name, path)
  if spec is None:
    raise FileNotFoundError(path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


class Cell:
  """One workload of ``BENCHMARK.json`` with its files, found by name."""

  def __init__(self, workload: str, bench_path: Path = ROOT / "BENCHMARK.json",
               config: dict = None, traffic: dict = None):
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
      raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    self.name = workload
    self.entry = cells[workload]
    self.chips = int(self.entry["chips"])
    files = {c["name"]: c["file"] for c in bench["configs"]}
    self.config = config or json.loads(
        (ROOT / files[self.entry["config"]]).read_text())
    self.traffic = traffic or json.loads(
        (HERE / "traffic" / f"{self.entry['traffic']}.json").read_text())
    kind = self.config["job"]
    self.job = load_module(HERE / "jobs" / f"{kind}.py", f"job_{kind}")
    self.reference = load_module(HERE / "reference" / f"{kind}.py",
                                 f"reference_{kind}")
    self.end_to_end = [m for m in bench["end_to_end"]
                       if workload in m.get("workloads", [workload])]
    self.per_layer = [m for m in bench["per_layer"]
                      if workload in m["workloads"]]
    self.limits = dict(self.config["limits"])


def chip_error(chips: int):
  """Why this machine cannot run the cell, or None."""
  import torch

  if not torch.cuda.is_available():
    return "no CUDA device: torch.cuda.is_available() is false"
  if torch.cuda.device_count() < chips:
    return (f"the cell needs {chips} CUDA devices; "
            f"torch.cuda.device_count() is {torch.cuda.device_count()}")
  return None


def forbidden_modules() -> list:
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN))


def _read_metric(spec, ctx):
  base = spec["name"].split(".")[0]
  reader = load_module(HERE / "metrics" / f"{base}.py", f"metric_{base}")
  return reader.read(ctx)


def write_inputs(cell: Cell, seed: int, device, root: str, info=None):
  """Draw the cell's fields from ``seed`` on ``device`` and write its
  stores under ``root``; (layout, store paths).  ``info`` receives the
  bytes written and their decoded size."""
  from harness import fields as fields_lib
  from harness import stores as stores_lib

  layout = fields_lib.Layout(cell.config, cell.traffic)
  fields = fields_lib.Fields(layout, seed, device)
  stores = stores_lib.write_stores(os.path.join(root, "stores"), fields,
                                   cell.traffic["compressor"],
                                   min(8, os.cpu_count() or 1))
  if info is not None:
    info.update(store_bytes=stores["bytes"], raw_bytes=stores["raw_bytes"])
  return layout, stores["paths"]


def check_outputs(cell: Cell, layout, seed: int, device, out_dir: str):
  """The results a job wrote into ``out_dir`` held to the reference."""
  from harness import compare as compare_lib

  expected = cell.reference.Reference(layout, seed, device).results()
  return compare_lib.compare(cell.job.outputs(layout, out_dir), expected)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0, scratch: str = None):
  """Set-up, window and check of one run; (result line, checks)."""
  import torch

  from harness import compare as compare_lib
  from harness import trace as trace_lib
  from weatherbench2_torch.xds import io_zarr

  on_card = torch.device(device).type == "cuda"
  job_device = None if on_card else device
  root = tempfile.mkdtemp(prefix="portbench-", dir=scratch)
  try:
    notes = {"start_s": time.perf_counter() - t0}
    layout, paths = write_inputs(cell, seed, device, root, notes)
    # the stores on disk before the window: no writeback of them inside it
    os.sync()
    notes["inputs_s"] = time.perf_counter() - t0 - notes["start_s"]
    cell.job.run(layout, paths, os.path.join(root, "warmup"), job_device)
    shutil.rmtree(os.path.join(root, "warmup"), ignore_errors=True)
    if on_card:
      torch.cuda.synchronize()
    gc.collect()

    # -- the window --------------------------------------------------------
    if on_card:
      torch.cuda.reset_peak_memory_stats()
    decode0 = (io_zarr.DECODES.bytes, io_zarr.DECODES.seconds)
    prof = None
    span = lambda name: contextlib.nullcontext()
    with contextlib.ExitStack() as stack:
      if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = stack.enter_context(profile(activities=activities))
        stack.enter_context(record_function(trace_lib.WINDOW))
        span = record_function
      start = time.perf_counter()
      cpu0 = time.process_time()
      setup_s = start - t0
      jobs, failed, last_out = [], 0, None
      while True:
        out = os.path.join(root, f"job{len(jobs) + failed}")
        try:
          with span(trace_lib.JOB):
            stats = cell.job.run(layout, paths, out, job_device)
          jobs.append(stats)
          if last_out is not None:
            # not the last job: its results go before the kernel writes
            # them back, so no job's writeback lands in a later job
            shutil.rmtree(last_out, ignore_errors=True)
          last_out = out
        except Exception:  # pylint: disable=broad-except
          failed += 1
          traceback.print_exc()
        if time.perf_counter() - start >= seconds:
          break
        gc.collect()
      if on_card:
        torch.cuda.synchronize()
      end = time.perf_counter()
      cpu_s = time.process_time() - cpu0
    window_s = end - start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    decodes = (io_zarr.DECODES.bytes - decode0[0],
               io_zarr.DECODES.seconds - decode0[1])
    completed = len(jobs)
    walls = [s.get("wall_s") for s in jobs]
    work = completed * cell.job.inits(layout)
    loaded = forbidden_modules()
    if loaded:
      raise RuntimeError(f"modules loaded in this process: {loaded}")

    # -- metrics -----------------------------------------------------------
    metrics = {}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {}
    if trace:
      tr = trace_lib.Trace(prof)
      del prof
      ctx = {"jobs": jobs, "inits": work, "window_s": window_s,
             "trace": tr, "decodes": decodes, "peak_bytes": peak,
             "step_bytes": completed * cell.job.step_bytes(layout)}
      for spec in cell.per_layer:
        value = _read_metric(spec, ctx)
        if value is not None:
          metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
      device_info["busy_s"] = tr.busy_s()
      device_info["window_s"] = tr.window_s
      result["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_gaps()}
    else:
      for spec in cell.end_to_end:
        if spec["name"] == "setup_s":
          value = setup_s
        elif spec["unit"] == f"{cell.job.UNIT}/s":
          value = work / window_s
        elif spec["name"] == "job_peak_hbm_gib":
          value = peak / 2**30
        else:
          raise ValueError(f"no measure for end-to-end metric {spec}")
        metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}

    # -- correctness: the last job's results against the reference --------
    jobs.clear()
    gc.collect()
    if on_card:
      torch.cuda.empty_cache()
    if last_out is None:
      tally = compare_lib.Tally()
      tally.miss(1, "no job completed")
    else:
      tally = check_outputs(cell, layout, seed, device, last_out)
    checks = {"worst_gap": {"value": tally.worst_gap,
                            "limit": cell.limits["worst_gap"]},
              "mismatched": {"value": tally.mismatched,
                             "limit": cell.limits["mismatched"]}}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    line = {"correct": correct, "attempted": completed + failed,
            "failed": failed, "metrics": metrics, "device": device_info,
            **result}
    line["checks"] = checks
    notes.update(where=tally.where, compared=tally.compared,
                 notes=tally.notes, job_walls=walls, window_s=window_s,
                 cpu_s=cpu_s)
    return line, notes
  finally:
    shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seed", type=int, required=True)
  parser.add_argument("--seconds", type=float, required=True)
  parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  cell = Cell(args.workload)
  err = chip_error(cell.chips)
  if err:
    print(err, file=sys.stderr)
    return 2
  line, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace))
  loaded = forbidden_modules()
  if loaded:
    print(f"modules loaded in this process: {loaded}", file=sys.stderr)
    return 4
  print(json.dumps(notes), file=sys.stderr)
  for name, check in line["checks"].items():
    print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(line))
  return 0


if __name__ == "__main__":
  sys.exit(main())

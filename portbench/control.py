"""The readings that a cell's limits are set from: the program's and its
lower-precision control's, over many seeds, at the cell's own size.

  python3 portbench/control.py --workload det15-lz4 --seeds 1,2,3 \
      --control_seeds 3

For each seed the cell's stores are written as a run writes them, then one
job of the program runs and its results are held to the reference; for
the first ``--control_seeds`` seeds the control runs too: the same job
with the program's own lower-precision path switched on
(``WB2_TRANSFER_DTYPE=bfloat16``: float payloads cross to the card as
bfloat16), held to the same reference.  One JSON line per seed and mode,
then a summary: the largest reading of the program (the lower reading)
and the smallest of the control (the upper one), each number apart.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import run

CONTROL_ENV = {"WB2_TRANSFER_DTYPE": "bfloat16"}


def readings(cell, seed, device, modes, scratch=None):
  """{mode: tally} of one seed: the stores written once, one job each."""
  root = tempfile.mkdtemp(prefix="portbench-control-", dir=scratch)
  out = {}
  try:
    layout, paths = run.write_inputs(cell, seed, device, root)
    job_device = None if device == "cuda" else device
    for mode in modes:
      saved = {k: os.environ.get(k) for k in CONTROL_ENV}
      if mode == "control":
        os.environ.update(CONTROL_ENV)
      try:
        out_dir = os.path.join(root, mode)
        t0 = time.perf_counter()
        cell.job.run(layout, paths, out_dir, job_device)
        job_s = time.perf_counter() - t0
        tally = run.check_outputs(cell, layout, seed, device, out_dir)
        out[mode] = (tally, job_s)
      except Exception as err:  # pylint: disable=broad-except
        # a control that crashes has failed and sets no upper reading
        out[mode] = (err, 0.0)
      finally:
        for k, v in saved.items():
          if v is None:
            os.environ.pop(k, None)
          else:
            os.environ[k] = v
        shutil.rmtree(os.path.join(root, mode), ignore_errors=True)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  return out


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seeds", required=True)
  parser.add_argument("--control_seeds", type=int, default=3)
  args = parser.parse_args(argv)
  cell = run.Cell(args.workload)
  err = run.chip_error(cell.chips)
  if err:
    print(err, file=sys.stderr)
    return 2
  seeds = [int(s) for s in args.seeds.split(",")]
  worst = {"program": {}, "control": {}}
  for i, seed in enumerate(seeds):
    modes = ["program"] + (["control"] if i < args.control_seeds else [])
    for mode, (tally, job_s) in readings(cell, seed, "cuda", modes).items():
      if isinstance(tally, Exception):
        print(json.dumps({"seed": seed, "mode": mode, "error": repr(tally)}))
        continue
      line = {"seed": seed, "mode": mode, "worst_gap": tally.worst_gap,
              "where": tally.where, "mismatched": tally.mismatched,
              "compared": tally.compared, "job_s": job_s,
              "notes": tally.notes}
      print(json.dumps(line), flush=True)
      for name in ("worst_gap", "mismatched"):
        worst[mode].setdefault(name, []).append(line[name])
  summary = {"lower": {k: max(v) for k, v in worst["program"].items()},
             "upper": {k: min(v) for k, v in worst["control"].items()},
             "seeds": len(seeds), "control_seeds": len(
                 worst["control"].get("worst_gap", []))}
  print(json.dumps(summary))
  loaded = run.forbidden_modules()
  if loaded:
    print(f"modules loaded in this process: {loaded}", file=sys.stderr)
    return 4
  return 0


if __name__ == "__main__":
  sys.exit(main())

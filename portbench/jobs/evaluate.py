"""Job kind ``evaluate``: one in-process call of the port's evaluation CLI,
``weatherbench2_torch.cli.evaluate.main(argv)``, over a cell's stores.

``argv`` builds the CLI's flags from the configuration and the traffic
mix; ``inits`` is the work one job completes; ``run`` calls the entry and
returns the counts it returns (its ``stats``).  A job whose results files
are missing failed.
"""
from __future__ import annotations

import os

import numpy as np

UNIT = "inits"  # the work a job completes, counted by ``inits``

RESULT_FORMAT = {"deterministic_spatial": "zarr",
                 "probabilistic_spatial": "zarr",
                 "ensemble_binary_spatial": "zarr",
                 "probabilistic_spatial_histograms": "zarr"}


def _stamp(t) -> str:
  return str(np.datetime64(t, "m"))


def argv(layout, paths: dict, out_dir: str, device=None) -> list:
  """The CLI's arguments for one job of the cell."""
  cfg, traffic = layout.config, layout.traffic
  args = [
      f"--forecast_path={paths['forecast']}",
      f"--obs_path={paths['truth']}",
      f"--climatology_path={paths['climatology']}",
      f"--output_dir={out_dir}",
      "--eval_configs=" + ",".join(cfg["eval_configs"]),
      "--variables=" + ",".join(layout.variables),
      "--levels=" + ",".join(str(int(v)) for v in layout.levels),
      f"--time_start={_stamp(layout.inits[0])}",
      f"--time_stop={_stamp(layout.inits[-1])}",
      f"--input_chunks={traffic['input_chunks']}",
      *cfg["flags"],
  ]
  if device is not None:
    args.append(f"--device={device}")
  return args


def inits(layout) -> int:
  """Forecast inits one job scores."""
  return len(layout.inits)


def outputs(layout, out_dir: str) -> dict:
  """{eval config: results path} that a job writes."""
  return {name: os.path.join(
      out_dir, f"{name}.{'zarr' if RESULT_FORMAT.get(name) else 'nc'}")
          for name in layout.config["eval_configs"]}


def run(layout, paths: dict, out_dir: str, device=None) -> dict:
  """Run one job; its counts.  Raises if a results file is missing."""
  from weatherbench2_torch.cli import evaluate

  stats = evaluate.main(argv(layout, paths, out_dir, device))
  missing = [p for p in outputs(layout, out_dir).values()
             if not os.path.exists(p)]
  if missing:
    raise RuntimeError(f"the job wrote no {missing}")
  return dict(stats or {})


def step_bytes(layout) -> int:
  """Bytes of the distinct float32 elements one job's metrics need, each
  read once: the forecast; the truth at the distinct valid times; the
  climatology rows at the distinct (day of year, hour) pairs of the valid
  times (the means for ACC, the SEEPS wet thresholds and the per-cell dry
  fraction, or the quantile thresholds)."""
  from harness.fields import day_of_year, hour_of_day

  cfg = layout.config
  cells = len(layout.lon) * len(layout.lat)
  var_levels = sum(layout.n_levels(v) for v in layout.variables)
  members = layout.members or 1
  valid = (layout.inits[:, None] + layout.leads[None, :]).ravel()
  pairs = len({(d, h) for d, h in zip(day_of_year(valid),
                                       hour_of_day(valid))})
  elements = len(layout.inits) * members * len(layout.leads) * var_levels
  elements += len(np.unique(valid)) * var_levels
  clim = cfg["climatology"]
  if any(c.startswith("deterministic") for c in cfg["eval_configs"]):
    elements += pairs * var_levels  # ACC's climatological means
  if clim.get("seeps"):
    elements += pairs + 1
  if clim.get("quantiles"):
    elements += len(clim["quantiles"]) * pairs * var_levels
  return 4 * elements * cells

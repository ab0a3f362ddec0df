"""Job kind ``evaluate_spatial``: the per-cell configs of the ensemble
command (``probabilistic_spatial``, ``probabilistic_spatial_histograms``),
one in-process call of ``weatherbench2_torch.cli.evaluate.main(argv)`` as
in the kind ``evaluate``, whose flags, work, results files and run it
takes whole.  Only the bytes the step needs differ: these configs read no
climatology.
"""
from __future__ import annotations

import numpy as np

# pylint: disable-next=unused-import
from jobs.evaluate import UNIT, argv, inits, outputs, run  # noqa: F401


def step_bytes(layout) -> int:
  """Bytes of the distinct float32 elements one job's metrics need, each
  read once: the forecast, and the truth at the distinct valid times."""
  cells = len(layout.lon) * len(layout.lat)
  var_levels = sum(layout.n_levels(v) for v in layout.variables)
  valid = (layout.inits[:, None] + layout.leads[None, :]).ravel()
  elements = (len(layout.inits) * layout.members * len(layout.leads)
              + len(np.unique(valid))) * var_levels
  return 4 * elements * cells

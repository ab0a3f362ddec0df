"""Device resolution for every entry point of the port.

The port runs on a CUDA card unless the caller asks for the CPU: there is
no silent fallback, so a run that was meant for the card cannot quietly
measure or compute on the host instead.
"""
from __future__ import annotations

import torch

# Region reductions and parity comparisons need IEEE float32: TF32 keeps
# about three decimal digits, far outside the tolerances the port is held to.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device=None) -> torch.device:
  """The torch device an entry point runs on.

  ``None`` means the CUDA card.  Without one this raises rather than
  falling back: pass ``device="cpu"`` to run on the host on purpose.
  """
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "no CUDA device is available; pass device='cpu' to run the port "
        "on the host"
    )
  return dev

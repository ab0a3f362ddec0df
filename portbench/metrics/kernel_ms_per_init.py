"""kernel_ms_per_init: device time of the port's own reduction kernels
(``csrc/reductions.cu``: every ``pass1_*`` kernel, by the profiler's
kernel name) per init scored, in ms."""
import re

KERNELS = re.compile(r"\bpass1_(scalar|vec4|stream|mma)\b")


def read(ctx):
  trace = ctx["trace"]
  if trace is None or not ctx["inits"]:
    return None
  ns = sum(e - s for name, s, e in trace.kernels if KERNELS.search(name))
  if ns == 0:
    return None
  return ns / 1e6 / ctx["inits"]

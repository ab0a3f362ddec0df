"""step_roofline: the least time the window's jobs could take on the
device, each distinct float32 element of forecast, truth and climatology
their metrics need read once from HBM at the data sheet's rate
(``jobs/<kind>.step_bytes``), over the union of the device's kernel
intervals in the traced window, in %.  The same work whatever implements
it."""
from harness import peaks


def read(ctx):
  trace = ctx["trace"]
  if trace is None or not ctx["step_bytes"]:
    return None
  busy = trace.kernel_union_s()
  if busy <= 0:
    return None
  return 100.0 * ctx["step_bytes"] / peaks.HBM_BYTES_PER_S / busy

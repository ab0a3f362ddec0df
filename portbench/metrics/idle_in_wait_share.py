"""idle_in_wait_share: of the time in the traced window in which the
device ran no kernel, copy or set, the share in which the main thread
stood in a ``wb2.wait_host`` span (waiting for a chunk the prefetch
threads prepare), in %.  The spans' stamps (``time.time_ns()``) are on the
clock of the trace's own.  Nothing to read where the program keeps no
spans."""
from harness.trace import union_seconds


def read(ctx):
  trace = ctx["trace"]
  if trace is None:
    return None
  waits = [(max(sp["start_ns"], trace.start), min(sp["end_ns"], trace.end))
           for s in ctx["jobs"] for sp in s.get("spans", ())
           if sp["name"] == "wb2.wait_host"]
  waits = [(a, b) for a, b in waits if b > a]
  if not waits:
    return None
  busy = [(s, e) for _, s, e in trace.kernels + trace.copies]
  busy_s = union_seconds(busy)
  idle_s = trace.window_s - busy_s
  if idle_s <= 0:
    return None
  # idle and waiting: |waits U busy| - |busy|
  return 100.0 * (union_seconds(waits + busy) - busy_s) / idle_s

"""inits_per_s: inits of the window's completed jobs over the whole traced
window, in inits/s: the cell's rate where its runs spread too widely for
it to carry a bound end to end, read under the profiler."""


def read(ctx):
  if not ctx["inits"] or ctx["window_s"] <= 0:
    return None
  return ctx["inits"] / ctx["window_s"]

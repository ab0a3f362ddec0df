"""generic_ms_per_init: seconds of the streaming engine's per-metric loop,
the metrics that no fused tier takes (``Spatial*`` maps, rank histograms,
configs without regions), per init scored, in ms: ``stats["generic_s"]``,
on the card the compute stream's time between CUDA events recorded around
the loop's launches in each chunk.  Nothing to read where the program does
not count it."""


def read(ctx):
  secs = [s["generic_s"] for s in ctx["jobs"] if "generic_s" in s]
  if not secs or not ctx["inits"]:
    return None
  return 1e3 * sum(secs) / ctx["inits"]

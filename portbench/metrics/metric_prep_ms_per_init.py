"""metric_prep_ms_per_init: seconds the prefetch threads spent in the
metrics' own ``prepare_chunk`` (``stats["metric_prep_s"]``: a rank
histogram's tie-breaking draws, the climatology gathers of ACC, SEEPS and
the quantile thresholds; a part of ``prepare_s``, summed over the threads)
per init scored, in ms.  Nothing to read where the program does not count
it."""


def read(ctx):
  secs = [s["metric_prep_s"] for s in ctx["jobs"] if "metric_prep_s" in s]
  if not secs or not ctx["inits"]:
    return None
  return 1e3 * sum(secs) / ctx["inits"]

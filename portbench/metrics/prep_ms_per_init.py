"""prep_ms_per_init: seconds the streaming engine's prefetch threads spent
preparing chunks (``stats["prepare_s"]``: reads, decode, truth dedup,
climatology gathers, slicing, padding, pinning and the copies' launch,
summed over the threads) per init scored, in ms.  Its self time is this
less ``read_ms_per_init``, the decode and ``pin_ms_per_init``.  Nothing to
read where the program does not count it."""


def read(ctx):
  secs = [s["prepare_s"] for s in ctx["jobs"] if "prepare_s" in s]
  if not secs or not ctx["inits"]:
    return None
  return 1e3 * sum(secs) / ctx["inits"]

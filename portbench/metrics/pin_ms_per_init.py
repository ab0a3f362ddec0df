"""pin_ms_per_init: seconds the prefetch threads spent staging chunks in
pinned host memory for their copies to the card (``stats["pin_s"]``, the
``pin_memory()`` calls of ``xds.to_device``, summed over the threads) per
init scored, in ms.  Nothing to read where the program does not count
them."""


def read(ctx):
  secs = [s["pin_s"] for s in ctx["jobs"] if "pin_s" in s]
  if not secs or not ctx["inits"]:
    return None
  return 1e3 * sum(secs) / ctx["inits"]

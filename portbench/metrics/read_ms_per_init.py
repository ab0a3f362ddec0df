"""read_ms_per_init: seconds the Zarr layer spent opening and reading chunk
files (``stats["read_s"]``, summed over the prefetch threads; decoding is
not in it) per init scored, in ms.  Nothing to read where the program does
not count them."""


def read(ctx):
  secs = [s["read_s"] for s in ctx["jobs"] if "read_s" in s]
  if not secs or not ctx["inits"]:
    return None
  return 1e3 * sum(secs) / ctx["inits"]

"""read_mib_per_init: chunk-file bytes the Zarr layer read
(``stats["read_bytes"]``, file bytes as stored) per init scored, in MiB.
A count."""


def read(ctx):
  if not ctx["inits"]:
    return None
  return sum(s.get("read_bytes", 0) for s in ctx["jobs"]) / 2**20 / (
      ctx["inits"])

"""write_direct_share: share of the bytes of the results' Zarr chunks
encoded (decoded size, ``stats["encode_bytes"]``) that were encoded
straight from the results, with no staged chunk
(``stats["write_direct_bytes"]``), summed over the window's jobs, in %.
Nothing to read where the program does not count them, or encodes
nothing."""


def read(ctx):
  jobs = [s for s in ctx["jobs"]
          if "write_direct_bytes" in s and "encode_bytes" in s]
  encoded = sum(s["encode_bytes"] for s in jobs)
  if encoded <= 0:
    return None
  return 100.0 * sum(s["write_direct_bytes"] for s in jobs) / encoded

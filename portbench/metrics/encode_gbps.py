"""encode_gbps: bytes of the results' Zarr chunks encoded (decoded size,
``stats["encode_bytes"]``) over the seconds their encoding took
(``stats["encode_s"]``), summed over the window's jobs, in GB/s: the rate
of the writer's codec on one thread.  Nothing to read where the program
does not count it, or encodes nothing."""


def read(ctx):
  jobs = [s for s in ctx["jobs"] if "encode_s" in s and "encode_bytes" in s]
  seconds = sum(s["encode_s"] for s in jobs)
  if seconds <= 0:
    return None
  return sum(s["encode_bytes"] for s in jobs) / seconds / 1e9

"""d2h_share: share of the jobs' wall in which the main thread copied the
accumulators to the host at the end of a stream (``stats["d2h_s"]``, a
part of ``wait_device_s``, over ``stats["wall_s"]``), in %.  Nothing to
read where the program does not count it."""


def read(ctx):
  jobs = [s for s in ctx["jobs"] if "d2h_s" in s]
  wall = sum(s.get("wall_s", 0.0) for s in jobs)
  if wall <= 0:
    return None
  return 100.0 * sum(s["d2h_s"] for s in jobs) / wall

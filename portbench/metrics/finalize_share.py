"""finalize_share: share of the jobs' wall spent turning accumulators into
results (``stats["finalize_s"]`` over ``stats["wall_s"]``, summed over the
window's jobs), in %."""


def read(ctx):
  wall = sum(s.get("wall_s", 0.0) for s in ctx["jobs"])
  if wall <= 0:
    return None
  return 100.0 * sum(s.get("finalize_s", 0.0) for s in ctx["jobs"]) / wall

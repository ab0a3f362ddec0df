"""lead_refill_share: share of the jobs' wall in which the main thread waited
for the first chunk of every lead slice after a stream's first
(``stats["lead_refill_s"]`` over ``stats["wall_s"]``, summed over the
window's jobs), in %: the pipeline fills that only a prefetch across lead
slices could hide.  Nothing to read where the program does not count it."""


def read(ctx):
  jobs = [s for s in ctx["jobs"] if "lead_refill_s" in s]
  wall = sum(s.get("wall_s", 0.0) for s in jobs)
  if wall <= 0:
    return None
  return 100.0 * sum(s["lead_refill_s"] for s in jobs) / wall

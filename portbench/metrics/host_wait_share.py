"""host_wait_share: share of the jobs' wall in which the streaming engine's
main thread waited for host preparation (reads, decode, pinning, copies;
``stats["wait_host_s"]`` over ``stats["wall_s"]``), in %."""


def read(ctx):
  wall = sum(s.get("wall_s", 0.0) for s in ctx["jobs"])
  if wall <= 0:
    return None
  return 100.0 * sum(s.get("wait_host_s", 0.0) for s in ctx["jobs"]) / wall

"""offload_share: share of the streaming engine's preparation thread-seconds
(``stats["prepare_s"]``) that a chunk's payload tasks ran on a prefetch
thread other than their chunk's own (``stats["offload_s"]``), in %: how
much of a chunk's reads, decodes and pinning the idle prefetch threads
took.  Nothing to read where the program does not count it."""


def read(ctx):
  jobs = [s for s in ctx["jobs"] if "offload_s" in s]
  prepare = sum(s.get("prepare_s", 0.0) for s in jobs)
  if not jobs or prepare <= 0:
    return None
  return 100.0 * sum(s["offload_s"] for s in jobs) / prepare

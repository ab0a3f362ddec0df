"""fill_wait_share: share of the jobs' wall in which the main thread waited
for the first chunk of a stream (the ``wb2.wait_host`` spans of
``ordinal`` 0 in ``stats["spans"]``), over ``stats["wall_s"]``, in %: the
part of ``host_wait_share`` that prefetching within a job cannot hide.
Nothing to read where the program keeps no spans."""


def read(ctx):
  jobs = [s for s in ctx["jobs"] if s.get("spans")]
  wall = sum(s.get("wall_s", 0.0) for s in jobs)
  if wall <= 0:
    return None
  ns = sum(sp["end_ns"] - sp["start_ns"] for s in jobs for sp in s["spans"]
           if sp["name"] == "wb2.wait_host" and sp.get("ordinal") == 0)
  return 100.0 * ns / 1e9 / wall

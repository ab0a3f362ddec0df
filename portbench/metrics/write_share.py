"""write_share: share of the jobs' wall in which the results files were
written (the ``wb2.write`` spans in ``stats["spans"]``, one a file, over
``stats["wall_s"]``), in %.  Nothing to read where the program keeps no
spans."""


def read(ctx):
  jobs = [s for s in ctx["jobs"] if s.get("spans")]
  wall = sum(s.get("wall_s", 0.0) for s in jobs)
  if wall <= 0:
    return None
  ns = sum(sp["end_ns"] - sp["start_ns"] for s in jobs for sp in s["spans"]
           if sp["name"] == "wb2.write")
  return 100.0 * ns / 1e9 / wall

"""results_mib_per_init: bytes of the results files as stored
(``stats["write_bytes"]``: every chunk and metadata file of a Zarr store,
a netCDF file's size) per init scored, in MiB.  A count: what a job leaves
on disk for each init it scores.  Nothing to read where the program does
not count it."""


def read(ctx):
  sizes = [s["write_bytes"] for s in ctx["jobs"] if "write_bytes" in s]
  if not sizes or not ctx["inits"]:
    return None
  return sum(sizes) / 2**20 / ctx["inits"]

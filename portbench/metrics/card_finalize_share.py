"""card_finalize_share: share of the bytes copied back at the end of a
stream (the ``wb2.d2h`` spans' ``bytes``: the temporal means, and any
per-time results) that are temporal means the finalize stacked by metric
on the device (``stats["finalize_device_bytes"]``), summed over the
window's jobs, in %.  Nothing to read where the program does not count
them."""


def read(ctx):
  jobs = [s for s in ctx["jobs"]
          if "finalize_device_bytes" in s and s.get("spans")]
  copied = sum(sp.get("bytes", 0) for s in jobs for sp in s["spans"]
               if sp["name"] == "wb2.d2h")
  if copied <= 0:
    return None
  return 100.0 * sum(s["finalize_device_bytes"] for s in jobs) / copied

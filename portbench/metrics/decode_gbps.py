"""decode_gbps: bytes the Zarr layer decoded over the seconds its decoding
took, summed over the decoding threads (``io_zarr.DECODES`` over the
window): the rate per decoding thread, in GB/s.  Nothing to read where no
chunk is compressed."""


def read(ctx):
  decoded, seconds = ctx["decodes"]
  if decoded <= 0 or seconds <= 0:
    return None
  return decoded / seconds / 1e9

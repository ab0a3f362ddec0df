"""Published peaks of the card the benchmark runs on."""

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12

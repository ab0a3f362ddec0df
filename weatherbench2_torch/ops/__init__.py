"""Fused reductions of the port: hand-written CUDA kernels + plain versions."""
from .reductions import (
    N_STATS,
    STAT_NAMES,
    fused_deterministic_metrics,
    fused_deterministic_sums,
    fused_deterministic_sums_plain,
    fused_region_sums,
    fused_region_sums_plain,
    make_region_weight_matrix,
)

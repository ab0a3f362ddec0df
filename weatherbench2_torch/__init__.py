"""weatherbench2_torch: the PyTorch/CUDA port of weatherbench2_tpu.

Deterministic forecast verification on one NVIDIA H100: a labeled-array
layer with plain-numpy Zarr/NetCDF IO, the streaming evaluation engine, and
the fused region reductions as hand-written CUDA kernels.  Entry point:
``weatherbench2_torch.evaluation.evaluate_with_mesh``.  Every entry point
runs on the card unless the caller passes ``device="cpu"``.
"""

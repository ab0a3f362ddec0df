"""Command-line entry points of the port (``python -m weatherbench2_torch.cli.<name>``)."""

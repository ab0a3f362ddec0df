"""Streaming evaluation engine of the port and its meshes of ranks."""

"""Streaming evaluation engine of the port (one device)."""

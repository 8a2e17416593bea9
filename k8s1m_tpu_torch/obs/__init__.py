"""Metrics of the port (a registry of its own)."""

"""Utilities of the port: timing helpers (``benchmarking``)."""

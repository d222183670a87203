"""Synthetic data for the port (copies of ``repro/data``'s numpy-only
modules)."""

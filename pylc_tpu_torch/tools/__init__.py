"""Measurement scripts of the port; each runs as ``python -m``."""

"""Measurement entry points of the port, each run with ``python -m``."""

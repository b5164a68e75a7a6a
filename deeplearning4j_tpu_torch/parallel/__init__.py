"""Parallel building blocks of the port (single-device parts so far)."""

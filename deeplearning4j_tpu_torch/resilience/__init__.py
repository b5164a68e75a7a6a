"""Resilience types of the port (typed errors so far)."""

"""Utilities of the port: `crash_reporting` (the OOM crash dump)."""

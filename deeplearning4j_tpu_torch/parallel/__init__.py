"""Parallel building blocks of the port: ParallelInference and the
single-device parts of ring attention so far."""

"""Resilience types of the port: typed errors and the circuit breaker so
far."""

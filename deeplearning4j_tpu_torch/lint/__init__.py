"""Lints of the port, the twins of the JAX package's `scripts/check_*.py`
pointed at `deeplearning4j_tpu_torch/` and its tests
(`tests/test_torch_*.py`). Each runs as `python -m
deeplearning4j_tpu_torch.lint.<name>` and exits 1 on a violation:

- `fastpath`       — registry and event calls behind the enabled guard;
  no capture and no host sync reachable from the steady-state paths of
  ParallelInference, the GenerationServer loop and the FleetRouter;
- `fault_coverage` — every fault site the port fires is driven by a
  port test; a declared site it does not fire yet is listed with the
  ROADMAP item that brings its firing code;
- `event_coverage` — the same for the ops-event kinds.

Each parses the sources it checks (AST and text) and imports none of
them.
"""

"""Resilience of the port: typed errors, retry/backoff, circuit breaking
and deterministic fault injection — the serving half of
`deeplearning4j_tpu/resilience/`.

Pieces:
- `errors` — the typed degradation errors (a copy of the JAX package's);
- `policy` — `RetryPolicy` (exponential backoff + seeded jitter,
  attempt/deadline budgets, OOM-never-retries classifier) and
  `CircuitBreaker` (closed/open/half-open with cooldown), with their
  `dl4j.resilience.*` monitoring hooks (a copy);
- `faults` — seeded `FaultPlan` injection at named sites, one
  module-attribute check per site when off (a copy);
- `health_snapshot()` — the `GET /health` payload.

The training half (`guardian`, `watchdog`, `integrity`, `trainer`)
comes with ROADMAP A14; until then, and until the multi-host
coordinator (A15) and the fleet router (A9), their sections of
`health_snapshot()` report None.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.resilience.errors import (  # noqa: F401
    CheckpointIntegrityError, CircuitOpenError, DistributedInitError,
    DivergenceError, FatalTrainingError, FleetDeadError,
    InferenceOverloadedError, InferenceTimeoutError, InjectedFault,
    MemoryPressureError, PeerDesyncError, PeerLostError,
    PreemptionSignal, ReplayDivergedError, ResilienceError,
    RetryExhaustedError, ServerDeadError, TransientError)
from deeplearning4j_tpu_torch.resilience.faults import (  # noqa: F401
    CACHE_GROW, CHECKPOINT_CORRUPT, CHECKPOINT_RESTORE, CHECKPOINT_SAVE,
    COMM_ALLREDUCE, COMM_BARRIER, DATA_NEXT, EVAL_FORWARD,
    EXECUTABLES_LOAD, GENERATION_ADMIT, GENERATION_STEP, HOST_PREEMPT,
    INFERENCE_COLLECTOR, INFERENCE_FORWARD, REPLICA_RESTART,
    ROUTER_DISPATCH, SERVING_DISPATCH, TRAIN_DISPATCH, FaultPlan,
    clear_plan, install_plan)
from deeplearning4j_tpu_torch.resilience.policy import (  # noqa: F401
    CircuitBreaker, RetryPolicy, default_classifier)

__all__ = [
    "ResilienceError", "TransientError", "RetryExhaustedError",
    "CircuitOpenError", "InferenceTimeoutError",
    "InferenceOverloadedError", "InjectedFault", "FatalTrainingError",
    "DivergenceError", "CheckpointIntegrityError",
    "DistributedInitError", "PeerLostError", "PeerDesyncError",
    "PreemptionSignal", "ServerDeadError", "FleetDeadError",
    "MemoryPressureError", "ReplayDivergedError",
    "RetryPolicy", "CircuitBreaker", "default_classifier",
    "FaultPlan", "install_plan", "clear_plan",
    "DATA_NEXT", "TRAIN_DISPATCH", "CHECKPOINT_SAVE",
    "CHECKPOINT_RESTORE", "CHECKPOINT_CORRUPT", "EVAL_FORWARD",
    "INFERENCE_FORWARD", "INFERENCE_COLLECTOR",
    "COMM_ALLREDUCE", "COMM_BARRIER", "HOST_PREEMPT",
    "GENERATION_STEP", "GENERATION_ADMIT", "CACHE_GROW",
    "EXECUTABLES_LOAD", "SERVING_DISPATCH",
    "ROUTER_DISPATCH", "REPLICA_RESTART",
    "health_snapshot",
]


def health_snapshot():
    """The `GET /health` payload: overall status plus the serving
    (GenerationServer) and SLO-tracker snapshots, with the guardian,
    watchdog, distributed and fleet sections None until their slices
    land. Status ladder as in the JAX package: a dead serving loop makes
    the process `serving_dead`; a serving memory-pressure degradation or
    an SLO breach reports `degraded`."""
    import sys
    # serving states come from sys.modules, never a fresh import: a
    # health tick must not pull the server (and torch's CUDA) in
    ssnap = None
    _gen = sys.modules.get("deeplearning4j_tpu_torch.generation.server")
    if _gen is not None:
        try:
            ssnap = [s.serving_state() for s in list(_gen._SERVERS)]
        except Exception:  # noqa: BLE001 — health must always answer
            ssnap = None
    slosnap = None
    _slo = sys.modules.get("deeplearning4j_tpu_torch.monitoring.slo")
    if _slo is not None and _slo.ACTIVE is not None:
        try:
            slosnap = _slo.ACTIVE.snapshot()
        except Exception:  # noqa: BLE001 — health must always answer
            slosnap = None
    status = "ok"
    if ssnap and any(s["state"] == "degraded" for s in ssnap):
        status = "degraded"
    if slosnap is not None and slosnap.get("violated"):
        status = "degraded"
    if ssnap and any(s["state"] == "dead" for s in ssnap):
        status = "serving_dead"
    return {"status": status, "guardian": None, "watchdog": None,
            "distributed": None, "serving": ssnap, "fleet": None,
            "slo": slosnap}

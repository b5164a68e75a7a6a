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

The training half: `guardian` (`TrainingGuardian`, the device-side
verdict and the escalation ladder), `watchdog` (`StallWatchdog`),
`integrity` (checkpoint manifests) and `trainer`
(`FaultTolerantTrainer`). `health_snapshot()` reports the installed
guardian's, watchdog's and multi-host coordinator's snapshots (the last
with its peer table); the serving and fleet sections read
`generation/server.py` and `generation/fleet.py`.
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
    "TrainingGuardian", "StallWatchdog", "FaultTolerantTrainer",
]

#: the training half, loaded on first use (guardian imports the nn
#: core's updaters, and the nn core imports this package)
_LAZY = {"TrainingGuardian": ("guardian", "TrainingGuardian"),
         "StallWatchdog": ("watchdog", "StallWatchdog"),
         "FaultTolerantTrainer": ("trainer", "FaultTolerantTrainer"),
         "guardian": ("guardian", None), "watchdog": ("watchdog", None),
         "integrity": ("integrity", None), "trainer": ("trainer", None)}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib
    mod, attr = _LAZY[name]
    m = importlib.import_module(f"{__name__}.{mod}")
    return m if attr is None else getattr(m, attr)


def health_snapshot():
    """The `GET /health` payload: overall status plus the installed
    guardian's, watchdog's and multi-host coordinator's snapshots and the
    serving (GenerationServer), fleet (FleetRouter) and SLO-tracker
    snapshots (None when not installed). Status ladder as in the JAX
    package: a latched stall makes the process `stalled`, a lost peer
    `peer_lost`, an exhausted guardian `diverged`, a dead serving loop or
    a fleet latched dead `serving_dead`; a guardian mid-escalation, a
    pending preemption, a serving memory-pressure degradation, a fleet
    with a replica out of the healthy pool, or an SLO breach reports
    `degraded`. The coordinator's snapshot carries the per-process peer
    table (heartbeat step and age, steps/s, exchange bytes, preempt flags,
    lost verdicts)."""
    import sys
    # the training half from sys.modules: nothing is installed unless
    # its module was loaded
    gsnap = wsnap = None
    _g = sys.modules.get("deeplearning4j_tpu_torch.resilience.guardian")
    if _g is not None and _g.ACTIVE is not None:
        gsnap = _g.ACTIVE.snapshot()
    _w = sys.modules.get("deeplearning4j_tpu_torch.resilience.watchdog")
    if _w is not None and _w.ACTIVE is not None:
        wsnap = _w.ACTIVE.snapshot()
    csnap = None
    _c = sys.modules.get("deeplearning4j_tpu_torch.parallel.coordination")
    if _c is not None and _c.ACTIVE is not None:
        try:
            csnap = _c.ACTIVE.snapshot()
        except Exception:  # noqa: BLE001 — health must always answer
            csnap = None
    # serving states come from sys.modules, never a fresh import: a
    # health tick must not pull the server (and torch's CUDA) in
    ssnap = None
    _gen = sys.modules.get("deeplearning4j_tpu_torch.generation.server")
    if _gen is not None:
        try:
            ssnap = [s.serving_state() for s in list(_gen._SERVERS)]
        except Exception:  # noqa: BLE001 — health must always answer
            ssnap = None
    # fleet routers: each router's replica healths and autoscale signal,
    # from sys.modules for the same reason
    fsnap = None
    _fl = sys.modules.get("deeplearning4j_tpu_torch.generation.fleet")
    if _fl is not None:
        try:
            fsnap = [r.fleet_state() for r in list(_fl._ROUTERS)]
        except Exception:  # noqa: BLE001 — health must always answer
            fsnap = None
    slosnap = None
    _slo = sys.modules.get("deeplearning4j_tpu_torch.monitoring.slo")
    if _slo is not None and _slo.ACTIVE is not None:
        try:
            slosnap = _slo.ACTIVE.snapshot()
        except Exception:  # noqa: BLE001 — health must always answer
            slosnap = None
    status = "ok"
    if gsnap is not None and gsnap["status"] == "degraded":
        status = "degraded"
    if ssnap and any(s["state"] == "degraded" for s in ssnap):
        status = "degraded"
    if fsnap and any(f["state"] == "degraded" for f in fsnap):
        status = "degraded"
    if slosnap is not None and slosnap.get("violated"):
        status = "degraded"
    if csnap is not None and (csnap["preempt_requested"]
                              or csnap["preempted"]):
        status = "degraded"
    if wsnap is not None and wsnap["stalled"]:
        status = "stalled"
    if csnap is not None and csnap["lost"]:
        status = "peer_lost"
    if gsnap is not None and gsnap["status"] == "diverged":
        status = "diverged"
    if ssnap and any(s["state"] == "dead" for s in ssnap):
        status = "serving_dead"
    if fsnap and any(f["state"] == "dead" for f in fsnap):
        status = "serving_dead"
    return {"status": status, "guardian": gsnap, "watchdog": wsnap,
            "distributed": csnap, "serving": ssnap, "fleet": fsnap,
            "slo": slosnap}

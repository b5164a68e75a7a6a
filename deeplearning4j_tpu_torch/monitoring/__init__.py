"""Unified host-side metrics + span tracing: the monitoring subsystem of
the port, the counterpart of `deeplearning4j_tpu/monitoring/`.

Dependency-free (the standard library; `memory.py` reads `torch.cuda`),
disabled by default. Every metric name is the JAX package's, so
dashboards and tests read the same series from both packages.

    from deeplearning4j_tpu_torch import monitoring
    monitoring.enable()
    ... serve ...
    print(monitoring.get_registry().prometheus_text())

`state`, `registry`, `tracing`, `steps`, `events`, `requests`, `slo`,
`stragglers` and `cluster` are copies of the JAX package's modules,
which import no jax, with their imports (lazy ones too) re-pointed at
the port; comments in them that speak of jit, XLA or the TPU describe
the JAX package. `memory.py` reads `torch.cuda` (`mem_get_info` and the
caching allocator's stats); `profiler.py` keeps the session surface,
whose capture comes with ROADMAP A16. The port's instrumented code so
far is `generation.GenerationServer` and `resilience.policy`.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.monitoring.state import STATE
from deeplearning4j_tpu_torch.monitoring import cluster  # noqa: F401
from deeplearning4j_tpu_torch.monitoring import memory  # noqa: F401
from deeplearning4j_tpu_torch.monitoring import profiler  # noqa: F401
from deeplearning4j_tpu_torch.monitoring import requests  # noqa: F401
from deeplearning4j_tpu_torch.monitoring import events  # noqa: F401
from deeplearning4j_tpu_torch.monitoring import slo  # noqa: F401
from deeplearning4j_tpu_torch.monitoring import steps  # noqa: F401
from deeplearning4j_tpu_torch.monitoring import stragglers  # noqa: F401
from deeplearning4j_tpu_torch.monitoring.requests import (  # noqa: F401
    RequestLog, RequestTimeline, merged_chrome_trace, request_log)
from deeplearning4j_tpu_torch.monitoring.slo import (  # noqa: F401
    LatencyObjective, RatioObjective, SloTracker, StepTimeObjective,
    StragglerObjective, ThroughputObjective, standard_objectives)
from deeplearning4j_tpu_torch.monitoring.memory import (  # noqa: F401
    MemoryMonitor)
from deeplearning4j_tpu_torch.monitoring.profiler import (  # noqa: F401
    ProfileSession, last_report, profile_next_steps)
from deeplearning4j_tpu_torch.monitoring.steps import (  # noqa: F401
    StepRecorder, recorder as step_recorder)
from deeplearning4j_tpu_torch.monitoring.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry,
    JIT_CACHE_MISSES, JIT_COMPILE_SECONDS, OP_DISPATCHES,
    JIT_PERSISTENT_HITS, JIT_PERSISTENT_MISSES,
    JIT_PERSISTENT_REQUESTS,
    EXEC_COMPILES, EXEC_COMPILE_SECONDS, EXEC_DISK_HITS,
    EXEC_DESERIALIZE_FAILURES, EXEC_SERIALIZE_FAILURES,
    EXEC_FLOPS, EXEC_BYTES_ACCESSED,
    SERVING_ROWS, SERVING_PADDED_ROWS, SERVING_BUCKET_OCCUPANCY,
    SERVING_SPLITS, SERVING_STAGED_BUFFERS, SERVING_STAGING_OCCUPANCY,
    SERVING_AOT_FALLBACKS,
    TRANSFER_H2D_BYTES, DEVICE_MEMORY_BYTES, DEVICE_MEMORY_SUPPORTED,
    HOST_RSS_BYTES,
    RESILIENCE_RETRIES, RESILIENCE_BACKOFF_SECONDS,
    RESILIENCE_BREAKER_TRIPS, RESILIENCE_FAULTS_INJECTED,
    RESILIENCE_BATCHES_SKIPPED, RESILIENCE_CHECKPOINT_SAVES,
    RESILIENCE_RESUMES, RESILIENCE_RESUME_STEP,
    RESILIENCE_INFERENCE_SHED, RESILIENCE_INFERENCE_TIMEOUTS,
    RESILIENCE_COLLECTOR_RESTARTS, RESILIENCE_CKPT_ORPHANS_REMOVED,
    RESILIENCE_CKPT_FALLBACKS,
    GUARDIAN_CHECKS, GUARDIAN_SKIPPED_UPDATES, GUARDIAN_LR_RETRIES,
    GUARDIAN_ROLLBACKS, GUARDIAN_SAVES_GATED, GUARDIAN_LAST_GOOD_STEP,
    WATCHDOG_STALLS, WATCHDOG_BEAT_AGE_SECONDS, WATCHDOG_DUMPS,
    DIST_PEERS, DIST_PEER_LOST, DIST_PREEMPTIONS,
    DIST_BARRIER_TIMEOUTS, DIST_ENCODED_BYTES, DIST_RESIDUAL_NORM,
    DIST_ACCUM_MICROBATCHES, DIST_EXCHANGE_BUCKETS, DIST_BUCKET_BYTES,
    DIST_EXPOSED_EXCHANGE_MS, DIST_ENCODER_MIGRATIONS,
    DIST_REFORMS_AGREED, DIST_REFORMS, DIST_REFORM_MS, DIST_WIRE_BYTES,
    DIST_STRAGGLER_RATIO, DIST_STRAGGLER_SKEW_MS,
    PIPELINE_SYNCS, PIPELINE_HOST_BLOCKED_MS, PIPELINE_PREFETCH_DEPTH,
    PIPELINE_STAGED_BATCHES,
    PROFILE_SESSIONS, PROFILE_CAPTURED_STEPS, PROFILE_DEVICE_MS,
    PROFILE_OP_MS, PROFILE_OP_COUNT,
    STEP_WALL_MS, STEP_PHASE_MS,
    MODEL_PARAMS_BYTES, MODEL_OPT_STATE_BYTES, MODEL_LAYER_STATE_BYTES,
    GEN_TOKENS, GEN_ACTIVE_SLOTS, GEN_ADMISSIONS, GEN_RETIREMENTS,
    GEN_PREFILL_MS, GEN_PER_TOKEN_MS, GEN_REPLAYS, GEN_RESTARTS,
    GEN_DEGRADATIONS, GEN_SUPERSTEPS, GEN_TOKENS_PER_DISPATCH,
    GEN_FETCH_OVERLAP_MS, GEN_DRAFT_ACCEPTS, GEN_DRAFT_REJECTS,
    GEN_PAGES_ACTIVE, GEN_PAGES_SHARED, GEN_PAGE_EVICTIONS,
    GEN_PREFIX_HITS,
    FLEET_ROUTED, FLEET_FAILOVERS, FLEET_REPLACEMENTS, FLEET_HEALTHY,
    FLEET_DESIRED_REPLICAS,
    QUANT_INT8_LAYERS, QUANT_CALIBRATIONS, QUANT_DEQUANT_FALLBACKS,
    QUANT_ACTIVATION_BYTES,
    INFERENCE_REQUEST_MS, SLO_BREACHES, SLO_BURN_RATE, SLO_BREACHED,
    EVENTS_EMITTED, EVENTS_DROPPED, INCIDENTS_OPEN, INCIDENTS_RESOLVED,
    CLUSTER_SNAPSHOT_AGE,
    bootstrap_core_metrics, collect_device_memory, get_registry,
    record_transfer)
from deeplearning4j_tpu_torch.monitoring.tracing import (  # noqa: F401
    NULL_SPAN, Span, Tracer, export_chrome_trace, get_tracer, span,
    traced_iter)

__all__ = [
    "enable", "disable", "enabled", "span", "traced_iter",
    "export_chrome_trace", "get_tracer", "get_registry",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Tracer",
    "bootstrap_core_metrics", "collect_device_memory", "record_transfer",
    "memory", "profiler", "steps",
    "MemoryMonitor", "ProfileSession", "StepRecorder",
    "last_report", "profile_next_steps", "step_recorder",
    "PROFILE_SESSIONS", "PROFILE_CAPTURED_STEPS", "PROFILE_DEVICE_MS",
    "PROFILE_OP_MS", "PROFILE_OP_COUNT",
    "STEP_WALL_MS", "STEP_PHASE_MS",
    "MODEL_PARAMS_BYTES", "MODEL_OPT_STATE_BYTES",
    "MODEL_LAYER_STATE_BYTES",
    "JIT_CACHE_MISSES", "JIT_COMPILE_SECONDS", "OP_DISPATCHES",
    "JIT_PERSISTENT_HITS", "JIT_PERSISTENT_MISSES",
    "JIT_PERSISTENT_REQUESTS",
    "EXEC_COMPILES", "EXEC_COMPILE_SECONDS", "EXEC_DISK_HITS",
    "EXEC_DESERIALIZE_FAILURES", "EXEC_SERIALIZE_FAILURES",
    "EXEC_FLOPS", "EXEC_BYTES_ACCESSED",
    "SERVING_ROWS", "SERVING_PADDED_ROWS", "SERVING_BUCKET_OCCUPANCY",
    "SERVING_SPLITS", "SERVING_STAGED_BUFFERS",
    "SERVING_STAGING_OCCUPANCY", "SERVING_AOT_FALLBACKS",
    "TRANSFER_H2D_BYTES", "DEVICE_MEMORY_BYTES",
    "DEVICE_MEMORY_SUPPORTED", "HOST_RSS_BYTES",
    "RESILIENCE_RETRIES", "RESILIENCE_BACKOFF_SECONDS",
    "RESILIENCE_BREAKER_TRIPS", "RESILIENCE_FAULTS_INJECTED",
    "RESILIENCE_BATCHES_SKIPPED", "RESILIENCE_CHECKPOINT_SAVES",
    "RESILIENCE_RESUMES", "RESILIENCE_RESUME_STEP",
    "RESILIENCE_INFERENCE_SHED", "RESILIENCE_INFERENCE_TIMEOUTS",
    "RESILIENCE_COLLECTOR_RESTARTS", "RESILIENCE_CKPT_ORPHANS_REMOVED",
    "RESILIENCE_CKPT_FALLBACKS",
    "GUARDIAN_CHECKS", "GUARDIAN_SKIPPED_UPDATES", "GUARDIAN_LR_RETRIES",
    "GUARDIAN_ROLLBACKS", "GUARDIAN_SAVES_GATED", "GUARDIAN_LAST_GOOD_STEP",
    "WATCHDOG_STALLS", "WATCHDOG_BEAT_AGE_SECONDS", "WATCHDOG_DUMPS",
    "DIST_PEERS", "DIST_PEER_LOST", "DIST_PREEMPTIONS",
    "DIST_BARRIER_TIMEOUTS", "DIST_ENCODED_BYTES", "DIST_RESIDUAL_NORM",
    "DIST_ACCUM_MICROBATCHES", "DIST_EXCHANGE_BUCKETS",
    "DIST_BUCKET_BYTES", "DIST_EXPOSED_EXCHANGE_MS",
    "DIST_ENCODER_MIGRATIONS",
    "DIST_REFORMS_AGREED", "DIST_REFORMS", "DIST_REFORM_MS",
    "DIST_WIRE_BYTES",
    "DIST_STRAGGLER_RATIO", "DIST_STRAGGLER_SKEW_MS",
    "PIPELINE_SYNCS", "PIPELINE_HOST_BLOCKED_MS", "PIPELINE_PREFETCH_DEPTH",
    "PIPELINE_STAGED_BATCHES",
    "GEN_TOKENS", "GEN_ACTIVE_SLOTS", "GEN_ADMISSIONS",
    "GEN_RETIREMENTS", "GEN_PREFILL_MS", "GEN_PER_TOKEN_MS",
    "GEN_REPLAYS", "GEN_RESTARTS", "GEN_DEGRADATIONS",
    "GEN_SUPERSTEPS", "GEN_TOKENS_PER_DISPATCH", "GEN_FETCH_OVERLAP_MS",
    "GEN_DRAFT_ACCEPTS", "GEN_DRAFT_REJECTS",
    "GEN_PAGES_ACTIVE", "GEN_PAGES_SHARED", "GEN_PAGE_EVICTIONS",
    "GEN_PREFIX_HITS",
    "FLEET_ROUTED", "FLEET_FAILOVERS", "FLEET_REPLACEMENTS",
    "FLEET_HEALTHY", "FLEET_DESIRED_REPLICAS",
    "QUANT_INT8_LAYERS", "QUANT_CALIBRATIONS",
    "QUANT_DEQUANT_FALLBACKS", "QUANT_ACTIVATION_BYTES",
    "INFERENCE_REQUEST_MS", "SLO_BREACHES", "SLO_BURN_RATE",
    "SLO_BREACHED", "CLUSTER_SNAPSHOT_AGE",
    "EVENTS_EMITTED", "EVENTS_DROPPED", "INCIDENTS_OPEN",
    "INCIDENTS_RESOLVED",
    "requests", "slo", "cluster", "stragglers", "events",
    "RequestLog", "RequestTimeline", "request_log",
    "merged_chrome_trace",
    "SloTracker", "LatencyObjective", "ThroughputObjective",
    "RatioObjective", "StepTimeObjective", "StragglerObjective",
    "standard_objectives",
]


def enable():
    """Turn on metrics collection and span recording globally."""
    STATE.enabled = True


def disable():
    """Back to the zero-overhead default (one branch per call site)."""
    STATE.enabled = False


def enabled():
    return STATE.enabled

"""Deterministic, seeded fault injection (the harness the resilience
tests drive; ≡ testing the reference's SharedTrainingMaster by killing
Spark workers on schedule, but in-process and reproducible).

Production code consults the harness through zero-cost-when-disabled
hooks at named sites:

    DATA_NEXT          "data.next"          — batch pulled from iterator
    TRAIN_DISPATCH     "train.dispatch"     — before the jitted step runs
    CHECKPOINT_SAVE    "checkpoint.save"    — before an async ckpt save
    CHECKPOINT_RESTORE "checkpoint.restore" — before a ckpt restore read
    CHECKPOINT_CORRUPT "checkpoint.corrupt" — inside manifest verification
                                              (a fault here simulates a
                                              corrupted checkpoint and
                                              proves the previous-
                                              generation fallback)
    EVAL_FORWARD       "eval.forward"       — before an eval-loop forward
    INFERENCE_FORWARD  "inference.forward"  — before a coalesced forward
    GENERATION_STEP    "generation.step"    — before a decode-step dispatch
    GENERATION_SUPERSTEP "generation.superstep" — before a multi-token
                                              superstep-block dispatch
    GENERATION_ADMIT   "generation.admit"   — before a prefill admission
    CACHE_GROW         "cache.grow"         — before a KV-cache rung growth
    CACHE_PAGE         "cache.page"         — before paged-KV page work
                                              (admission mapping / block
                                              allocate + CoW + table)
    EXECUTABLES_LOAD   "executables.load"   — on the AOT store miss path
    SERVING_DISPATCH   "serving.dispatch"   — inside the AOT serving path
    HOST_JOIN          "host.join"          — during elastic join admission
    WIRE_DECODE        "wire.decode"        — before a sparse-wire exchange

The hook at every call site is literally

    if _faults.ACTIVE is not None:
        _faults.ACTIVE.fire(_faults.TRAIN_DISPATCH)

— one module-attribute check, no allocation, nothing else on the
disabled (production) path. `ACTIVE` is only ever set by an installed
`FaultPlan`.

A plan is a list of seeded rules per site: fail exactly at call N, every
nth call, or with probability p (seeded `random.Random`, so the same
plan replays the same fault schedule). Rules raise `InjectedFault`
(classified transient → exercises retry) unless given another exception
factory (e.g. `FatalTrainingError` to simulate a kill, or an OOM-shaped
RuntimeError to prove retry refuses it).
"""
from __future__ import annotations

import os
import random
import threading

from deeplearning4j_tpu_torch.resilience.errors import InjectedFault

__all__ = ["FaultPlan", "install_plan", "clear_plan", "ACTIVE",
           "DATA_NEXT", "TRAIN_DISPATCH", "CHECKPOINT_SAVE",
           "CHECKPOINT_RESTORE", "CHECKPOINT_CORRUPT", "EVAL_FORWARD",
           "INFERENCE_FORWARD", "INFERENCE_COLLECTOR",
           "COMM_ALLREDUCE", "COMM_BARRIER", "HOST_PREEMPT",
           "GENERATION_STEP", "GENERATION_SUPERSTEP",
           "GENERATION_ADMIT", "CACHE_GROW", "CACHE_PAGE",
           "EXECUTABLES_LOAD", "SERVING_DISPATCH",
           "HOST_JOIN", "WIRE_DECODE",
           "ROUTER_DISPATCH", "REPLICA_RESTART",
           "PROCESS_ID", "resolve_process_id"]

DATA_NEXT = "data.next"
TRAIN_DISPATCH = "train.dispatch"
CHECKPOINT_SAVE = "checkpoint.save"
CHECKPOINT_RESTORE = "checkpoint.restore"
#: fires inside manifest verification (resilience/integrity.py) — a
#: fault here is indistinguishable from a corrupted checkpoint, so the
#: restore path must fall back to the previous generation
CHECKPOINT_CORRUPT = "checkpoint.corrupt"
EVAL_FORWARD = "eval.forward"
INFERENCE_FORWARD = "inference.forward"
#: fires in the collector LOOP (outside the per-batch try), so a fault
#: here kills the collector thread itself — the scenario the breaker-
#: guarded auto-restart exists for
INFERENCE_COLLECTOR = "inference.collector"
#: fires before a multi-host train-step dispatch whose jitted body
#: crosses processes (the compressed gradient all-reduce) — a fault
#: here simulates a DCN transport blip mid-exchange
COMM_ALLREDUCE = "comm.allreduce"
#: fires before a cross-process coordination barrier / heartbeat
#: exchange — the peer-containment paths must surface these as
#: PeerLostError, never an indefinite hang
COMM_BARRIER = "comm.barrier"
#: fires at the multi-host sync point; inject a
#: `PreemptionSignal` here to simulate SIGTERM delivery on schedule
#: (the coordinated drain + checkpoint + clean exit path)
HOST_PREEMPT = "host.preempt"
#: fires before the GenerationServer's per-token decode dispatch — a
#: fault here kills the step mid-flight (donated state presumed gone);
#: crash-replay must re-admit every surviving request bit-identically
GENERATION_STEP = "generation.step"
#: fires before a multi-token decode-block dispatch (superstep k > 1
#: scans AND drafting verify rounds): a fault here kills the whole
#: k-token block mid-flight — crash-replay must regenerate every
#: undelivered token of the block bit-identically
GENERATION_SUPERSTEP = "generation.superstep"
#: fires before a prompt-prefill admission dispatch (fresh or replay);
#: the request is journaled first, so a fault here replays it
GENERATION_ADMIT = "generation.admit"
#: fires before a KV-cache rung-growth dispatch; inject an OOM-shaped
#: error here to drive the memory-pressure degradation ladder
CACHE_GROW = "cache.grow"
#: fires before paged-KV page work (admission page mapping; the
#: per-block allocate/CoW/table build) — inject
#: `PagePoolExhaustedError` to exercise pool exhaustion (contained
#: refusal at admission, degradation ladder + crash-replay mid-stream)
#: or any error to simulate a corrupt page index the replay must
#: rebuild bit-identically
CACHE_PAGE = "cache.page"
#: fires on the AOT executable-store miss path (disk load / live
#: compile) — simulates a corrupt or unreachable executable cache
EXECUTABLES_LOAD = "executables.load"
#: fires inside the AOT serving dispatch (`_serve_aot`) — a fault here
#: must open the AOT breaker and degrade to the legacy path, then
#: recover through the half-open probe after cooldown
SERVING_DISPATCH = "serving.dispatch"
#: fires during elastic join admission — after the joiner announced
#: itself but before the membership commit. A fault here simulates the
#: joiner (or an admitting member) dying mid-join: the transition must
#: be abandoned typed (`MembershipChangeError`), the old roster stays
#: authoritative, and survivors keep training
HOST_JOIN = "host.join"
#: fires before a sparse-wire train-step dispatch (the allgather +
#: decode-and-accumulate exchange) — simulates a corrupt/truncated
#: sparse gradient message; containment must be a typed error or a
#: guardian-gated step, never a silently wrong delivered gradient
WIRE_DECODE = "wire.decode"
#: fires in the FleetRouter before handing a request to the replica it
#: routed to — a fault here is a dispatch-path blip the router must
#: absorb inside the request's bounded failover budget (re-route, never
#: a client-visible error while a healthy replica remains)
ROUTER_DISPATCH = "router.dispatch"
#: fires in the fleet replica supervisor before building a dead
#: replica's replacement — a fault here simulates a restart that itself
#: fails: the replica stays out of the roster, surviving replicas keep
#: serving, and only zero live replicas latches `FleetDeadError`
REPLICA_RESTART = "replica.restart"

#: THE switch production hooks check. None → injection off (the
#: permanent state outside resilience tests).
ACTIVE = None

#: this process's id in a multi-host run — set by the distributed
#: bootstrap (parallel/multihost.initialize) so FaultPlan seed
#: derivation is process-aware without importing jax here. None until
#: a bootstrap (or test) sets it; env vars are the fallback.
PROCESS_ID = None


def resolve_process_id(explicit=None):
    """The process id used for per-worker seed derivation: an explicit
    value wins, then the bootstrap-registered `PROCESS_ID`, then the
    `DL4J_PROCESS_ID` / `JAX_PROCESS_ID` env vars, else 0 (single
    process)."""
    if explicit is not None:
        return int(explicit)
    if PROCESS_ID is not None:
        return int(PROCESS_ID)
    for env in ("DL4J_PROCESS_ID", "JAX_PROCESS_ID"):
        v = os.environ.get(env)
        if v:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


class _Rule:
    __slots__ = ("kind", "arg", "make", "max_fires", "fires")

    def __init__(self, kind, arg, make, max_fires):
        self.kind = kind          # "at" | "every" | "prob"
        self.arg = arg
        self.make = make
        self.max_fires = max_fires
        self.fires = 0

    def matches(self, call_n, rng):
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.kind == "at":
            return call_n == self.arg
        if self.kind == "every":
            return call_n % self.arg == 0
        return rng.random() < self.arg          # "prob"


def _default_exc(site, call_n):
    return InjectedFault(f"injected fault at {site} (call {call_n})")


class FaultPlan:
    """Seeded schedule of failures at named injection sites.

    Usage:
        plan = (FaultPlan(seed=7)
                .fail_at(TRAIN_DISPATCH, 17, exc=FatalTrainingError("kill"))
                .every(INFERENCE_FORWARD, 3)
                .probability(DATA_NEXT, 0.05))
        with plan:                  # installs/clears the global hook
            ... run training ...
        plan.fired[TRAIN_DISPATCH]  # how many faults actually fired
    """

    def __init__(self, seed=0, process_id=None):
        """Seed derivation is PROCESS-AWARE: the effective rng seed is
        `seed ^ process_id` (explicit arg, else the bootstrap-registered
        process id, else env — see `resolve_process_id`). Every worker
        in a multi-process chaos run installs the same plan with the
        same `seed`, yet probability rules fire on a schedule unique to
        (and deterministic for) each worker — replaying the run replays
        the exact same per-worker fault schedule. Deterministic rules
        (`fail_at` / `every`) are unaffected: they count calls, not
        random draws."""
        self._rules = {}            # site -> [_Rule]
        self._calls = {}            # site -> call count (1-based)
        self.fired = {}             # site -> faults raised
        self.seed = int(seed)
        self.process_id = resolve_process_id(process_id)
        self._rng = random.Random(self.seed ^ self.process_id)
        self._lock = threading.Lock()

    # -- rule builders (chainable) --------------------------------------
    def _add(self, site, kind, arg, exc, max_fires):
        make = exc if callable(exc) else (
            None if exc is None else (lambda *_: exc))
        self._rules.setdefault(site, []).append(
            _Rule(kind, arg, make, max_fires))
        return self

    def fail_at(self, site, call_n, exc=None):
        """Raise on exactly the `call_n`-th (1-based) visit to `site`."""
        return self._add(site, "at", int(call_n), exc, max_fires=1)

    def every(self, site, nth, exc=None, max_fires=None):
        """Raise on every `nth` visit to `site`."""
        if int(nth) < 1:
            raise ValueError("nth must be >= 1")
        return self._add(site, "every", int(nth), exc, max_fires)

    def probability(self, site, p, exc=None, max_fires=None):
        """Raise with probability `p` per visit (seeded, replayable)."""
        return self._add(site, "prob", float(p), exc, max_fires)

    # -- the hot hook ----------------------------------------------------
    def fire(self, site):
        """Called by production hooks while this plan is installed:
        count the visit and raise if a rule matches. Thread-safe (the
        inference sites fire from collector threads)."""
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            exc = None
            for rule in self._rules.get(site, ()):
                if rule.matches(n, self._rng):
                    rule.fires += 1
                    self.fired[site] = self.fired.get(site, 0) + 1
                    make = rule.make or _default_exc
                    exc = make(site, n)
                    break
        if exc is None:
            return
        from deeplearning4j_tpu_torch import monitoring as _mon
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.RESILIENCE_FAULTS_INJECTED, labels={"site": site},
                help="faults raised by the injection harness").inc()
            from deeplearning4j_tpu_torch.monitoring import events as _events
            _events.emit("resilience", _events.FAULT_INJECTED,
                         attrs={"site": site, "call": n,
                                "error": type(exc).__name__})
        raise exc

    def calls(self, site):
        """How many times `site` has been visited under this plan."""
        with self._lock:
            return self._calls.get(site, 0)

    def reset_counts(self):
        """Clear visit/fire counts but keep the rules (a 'restarted
        process' sees fresh call numbering; rule fire budgets persist so
        a fail-once kill does not re-kill the resumed run)."""
        with self._lock:
            self._calls.clear()
        return self

    # -- install/clear ---------------------------------------------------
    def install(self):
        global ACTIVE
        ACTIVE = self
        return self

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        clear_plan()
        return False


def install_plan(plan):
    return plan.install()


def clear_plan():
    global ACTIVE
    ACTIVE = None

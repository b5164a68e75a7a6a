"""FleetRouter — health-driven request routing across GenerationServer
replicas, with replica supervision and mid-stream failover replay: the
port of `deeplearning4j_tpu/generation/fleet.py`.

Every per-replica hardening already exists below this layer:
crash-replay and supervised restart (generation/server.py), the
memory-pressure degradation ladder, warm spin-up from the executable
store's shared manifest (runtime/executables.py), burn-rate SLOs
(monitoring/slo.py), and the ops event journal (monitoring/events.py).
The router composes them, so that one stuck decode loop is no longer a
full outage for its clients.

Routing policy (shed-to-healthy before shed-to-floor):

- Admissions go ONLY to healthy replicas — never to a dead one, never
  to one degraded under the pressure ladder, never to one whose
  per-replica burn gauge breached (multi-window burn-rate rule over
  recent request outcomes, the slo.py semantics scoped to one
  replica). A burn-breached replica receives ZERO new admissions until
  its windows stop burning.
- Among healthy replicas the least-loaded wins (active slots + queued,
  admission count as the tie-break).
- With no healthy replica but live ones remaining, the request sheds
  TYPED (`InferenceOverloadedError`) — the floor — instead of piling
  onto a replica that is already degrading.
- Only when NO live replica remains (and replacement failed or is
  exhausted) does the router latch the typed `FleetDeadError`.

Every request carries a propagated deadline and a bounded failover
budget. When a replica dies mid-stream, the router re-submits the
surviving request to a healthy replica through the server's own
journal-replay machinery (`GenerationServer.adopt`): replicas share
one seed and the router assigns fleet-wide admission ids, so a stream
is a pure function of (seed, admit id, prompt, sampling config) —
independent of WHICH replica serves it. The delivered prefix rides the
re-submission and is suppressed (prefix re-prefill or
regenerate-with-suppression, exactly like an in-process crash), so
client streams stay exactly-once and token-identical to an
uninterrupted run on one bare server.

The replica supervisor runs inline in whichever relay thread first
observes a death: drain (the dead server already failed its open work;
shutdown() reaps the loop thread), then restart — the `replica.restart`
fault site fires here — by building a replacement from the replica
factory and warming it. Point the factory at ONE `exec_cache_dir`: the
replacement's `warmup()` then finds every key in the manifest
(`from_disk` equals the key count, `compiled` 0), and on the card
captures its CUDA graphs there, at the declared cold boundary, while the
surviving replicas keep replaying theirs (each server's loop runs on its
own stream; captures never overlap one another). The episode lands on
the ops journal as one ordered incident: `replica.unhealthy` (trigger)
→ `replica.drained` → `replica.replaced` (resolving), with the racing
`request.failover` events absorbed while it is open. Nothing keeps the
dead server once its slot is refilled, so its caches, staging buffers,
graphs and their private pool are freed with it.

The router also emits an autoscale signal — queue depth x SLO burn →
desired replica count — on `GET /fleet`, the metrics plane
(`dl4j.fleet.desired_replicas`), and the cross-host replica registry
(`publish()` / `directory()` over the coordination KV's
`fleet/<process_id>` namespace, `parallel/coordination.py`; with no
active coordinator `publish()` returns None and `directory()` {}).

Hot-path contract (linted by `python -m
deeplearning4j_tpu_torch.lint.fastpath`): the route / dispatch / relay /
failover walk is pure host bookkeeping — no captures, no device syncs,
and every metrics/event touch sits behind the one-branch enabled guard.
The declared cold boundary is `_supervise` (replica replacement warms a
new server).
"""
from __future__ import annotations

import math
import sys
import threading
import time
import types
import weakref
from collections import deque

import numpy as np

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.generation.sampling import method_id
from deeplearning4j_tpu_torch.generation.server import GenerationRequest
from deeplearning4j_tpu_torch.monitoring import events as _events
from deeplearning4j_tpu_torch.monitoring import requests as _req
from deeplearning4j_tpu_torch.monitoring import slo as _slo
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience.errors import (
    FleetDeadError, InferenceOverloadedError, InferenceTimeoutError,
    MemoryPressureError, ReplayDivergedError, ServerDeadError,
    TransientError)

__all__ = ["FleetRequest", "FleetRouter", "status", "directory"]

_ROUTERS = weakref.WeakSet()


class _BurnGauge:
    """Per-replica burn-rate health: the slo.py multi-window rule over
    recent request OUTCOMES (ok / failed) on one replica. Breached when
    both the short window (bad right now) and the long window (bad long
    enough to matter) burn faster than the error budget with at least
    `min_samples` of evidence; recovers by itself as bad samples age
    out of the windows."""

    def __init__(self, short_s, long_s, budget, min_samples):
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.budget = float(budget)
        self.min_samples = int(min_samples)
        self._samples = deque()
        self._lock = threading.Lock()

    def record(self, now, bad):
        with self._lock:
            self._samples.append((now, bool(bad)))
            while self._samples \
                    and now - self._samples[0][0] > self.long_s:
                self._samples.popleft()

    def _burn(self, window, now):
        inside = [bad for t, bad in self._samples if now - t <= window]
        if not inside:
            return 0.0
        return (sum(inside) / len(inside)) / self.budget

    def burn(self, now):
        with self._lock:
            while self._samples \
                    and now - self._samples[0][0] > self.long_s:
                self._samples.popleft()
            return (self._burn(self.short_s, now),
                    self._burn(self.long_s, now))

    def breached(self, now):
        with self._lock:
            while self._samples \
                    and now - self._samples[0][0] > self.long_s:
                self._samples.popleft()
            if len(self._samples) < self.min_samples:
                return False
            return self._burn(self.short_s, now) >= 1.0 \
                and self._burn(self.long_s, now) >= 1.0

    def reset(self):
        with self._lock:
            self._samples.clear()


class _Replica:
    """One roster slot: the live server, the factory that builds its
    replacement, routing counters, and the burn gauge."""

    def __init__(self, name, server, factory, gauge, restart_budget):
        self.name = name
        self.server = server
        self.factory = factory
        self.gauge = gauge
        self.restarts_left = int(restart_budget)
        self.lock = threading.Lock()    # serializes supervision
        self.routed = 0                 # admissions dispatched here
        self.failovers = 0              # streams that left here mid-way
        self.replacements = 0           # supervisor-built servers
        self.unhealthy_latched = False  # burn-transition event edge
        self.reviving = False           # async supervision in flight

    def health(self, now):
        """dead | unhealthy | degraded | healthy (cold counts healthy:
        the first dispatch warms it from the shared store)."""
        srv = self.server
        if srv._dead is not None or srv._shutdown:
            return "dead"
        if self.gauge.breached(now):
            return "unhealthy"
        if srv._pressure:
            return "degraded"
        return "healthy"

    def snapshot(self, now):
        srv = self.server
        bs, bl = self.gauge.burn(now)
        return {"name": self.name,
                "health": self.health(now),
                "burn_short": round(bs, 4),
                "burn_long": round(bl, 4),
                "slots": srv.slots,
                "active_slots": len(srv._slot_req),
                "queued": srv._queue.qsize(),
                "routed": self.routed,
                "failovers": self.failovers,
                "replacements": self.replacements,
                "restarts_left": self.restarts_left,
                **{k: v for k, v in srv.serving_state().items()
                   if k in ("state", "pressure", "rung_cap", "replays",
                            "restarts")}}


class FleetRequest(GenerationRequest):
    """Client handle for one fleet-routed request. The client surface
    is exactly GenerationRequest's (`tokens` / `stream()` / `result()`
    / `on_token`); underneath, a relay thread feeds it from whichever
    replica currently owns the stream — across a mid-stream failover
    the handle never notices (delivered tokens arrive exactly once, in
    order, bit-identical to an uninterrupted run)."""

    def __init__(self, prompt, max_new_tokens, eos_id, method,
                 temperature, top_k, admit_id, deadline, on_token=None):
        super().__init__(prompt, max_new_tokens, eos_id, method,
                         temperature, top_k, on_token=on_token)
        self.admit_id = int(admit_id)   # fleet-wide (rng identity)
        self.deadline = deadline        # monotonic seconds or None
        self.attempts = 0               # failovers consumed
        self.routes = []                # replica names, dispatch order


class FleetRouter:
    """Front-end spreading generation requests across N GenerationServer
    replicas (module docstring has the policy). Replicas must agree on
    seed and shape ladders — the bit-identical-failover contract.

    Parameters
    ----------
    replicas: pre-built GenerationServer list, or None to build
        `num_replicas` via `factory(i)`.
    factory: callable(index) -> GenerationServer; also the supervisor's
        replacement builder (point it at the SAME exec_cache_dir so a
        replacement finds every key in the manifest: `compiled` 0).
    failover_budget: mid-stream re-routes a single request may consume.
    restart_budget: replacement servers the supervisor may build per
        roster slot before that slot stays dead.
    health_windows / health_budget / health_min_samples: the
        per-replica burn gauge (short_s, long_s) / error budget /
        evidence floor.
    default_timeout_ms: deadline applied when submit() gets none.
    max_replicas: cap for the autoscale signal (None = uncapped).
    clock: injectable monotonic clock (tests age burn windows with it).
    """

    def __init__(self, replicas=None, factory=None, num_replicas=None,
                 failover_budget=2, restart_budget=2,
                 health_windows=(5.0, 20.0), health_budget=0.25,
                 health_min_samples=4, default_timeout_ms=None,
                 max_replicas=None, clock=time.monotonic):
        if replicas is None:
            if factory is None or num_replicas is None:
                raise ValueError(
                    "pass replicas=[...] or factory= with num_replicas=")
            replicas = [factory(i) for i in range(int(num_replicas))]
        replicas = list(replicas)
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        t = replicas[0]
        for srv in replicas[1:]:
            if (srv.seed, srv.cache_lengths, srv.prompt_buckets) \
                    != (t.seed, t.cache_lengths, t.prompt_buckets):
                raise ValueError(
                    "replicas must share seed, cache_lengths and "
                    "prompt_buckets — failover continuations are only "
                    "bit-identical across aligned replicas")
        # the first replica's settings, not the replica: a router that
        # kept a server would keep it (its caches and graphs) after a
        # replacement took its slot
        self._template = types.SimpleNamespace(**{
            k: getattr(t, k) for k in (
                "seed", "cache_lengths", "prompt_buckets",
                "default_max_new_tokens", "default_eos_id",
                "default_method", "default_temperature", "default_top_k")})
        self.failover_budget = int(failover_budget)
        self.default_timeout_ms = default_timeout_ms
        self.max_replicas = (None if max_replicas is None
                             else int(max_replicas))
        self._clock = clock
        self._hw = (float(health_windows[0]), float(health_windows[1]))
        self._hb = float(health_budget)
        self._hm = int(health_min_samples)
        self._replicas = [
            _Replica(f"r{i}", srv,
                     (None if factory is None
                      else (lambda idx=i: factory(idx))),
                     _BurnGauge(self._hw[0], self._hw[1], self._hb,
                                self._hm),
                     restart_budget)
            for i, srv in enumerate(replicas)]
        self.stats = {"submitted": 0, "completed": 0, "failed": 0,
                      "failovers": 0, "shed": 0, "replacements": 0}
        self._counter = 0               # fleet-wide admission ids
        self._lock = threading.Lock()
        self._threads = set()
        self._dead = None               # FleetDeadError once latched
        self._closing = False
        self._corr = "fleet-%x" % id(self)   # ops-event incident key
        _ROUTERS.add(self)

    # -- client surface ---------------------------------------------------
    def warmup(self):
        """Warm every replica. Over a shared exec-cache directory the
        first replica writes the manifest and the rest find every key
        there (`from_disk`)."""
        return [r.server.warmup() for r in self._replicas]

    def submit(self, prompt, max_new_tokens=None, eos_id="default",
               method=None, temperature=None, top_k=None, on_token=None,
               timeout_ms=None):
        """Route one prompt into the fleet; returns a FleetRequest
        immediately. Validation mirrors GenerationServer.submit against
        the shared replica shape ladders; the fleet admission id is
        assigned HERE, in submission order, so the workload's streams
        are reproducible whatever the replica count."""
        if self._dead is not None:
            raise self._dead
        if self._closing:
            raise RuntimeError("FleetRouter is shut down")
        t = self._template
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if prompt.size > t.prompt_buckets[-1]:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the top prompt "
                f"bucket {t.prompt_buckets[-1]}")
        max_new = (t.default_max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new > t.cache_lengths[-1]:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds the top cache rung {t.cache_lengths[-1]}")
        tmo = self.default_timeout_ms if timeout_ms is None \
            else timeout_ms
        deadline = (None if tmo is None
                    else self._clock() + float(tmo) / 1e3)
        with self._lock:
            if self._dead is not None:
                raise self._dead
            self._counter += 1
            admit_id = self._counter
            self.stats["submitted"] += 1
        freq = FleetRequest(
            prompt, max_new,
            t.default_eos_id if eos_id == "default" else eos_id,
            t.default_method if method is None else method_id(method),
            t.default_temperature if temperature is None else temperature,
            t.default_top_k if top_k is None else top_k,
            admit_id, deadline, on_token=on_token)
        freq.trace = _req.start("fleet", meta={
            "prompt_len": int(prompt.size),
            "max_new_tokens": max_new,
            "admit_id": admit_id})
        if freq.trace is not None:
            freq.trace_id = freq.trace.trace_id
        th = threading.Thread(target=self._serve, args=(freq,),
                              name=f"fleet-relay-{admit_id}",
                              daemon=True)
        self._threads.add(th)
        th.start()
        return freq

    def generate(self, prompt, timeout=None, **kw):
        """Blocking convenience: submit + result."""
        return self.submit(prompt, **kw).result(timeout=timeout)

    # -- relay loop (one thread per in-flight request) --------------------
    def _serve(self, freq):
        try:
            while not freq.done():
                try:
                    replica = self._route(freq)
                except Exception as e:  # noqa: BLE001 — typed refusal
                    self._finalize(freq, e)
                    return
                err = None
                try:
                    backend = self._dispatch(replica, freq)
                except Exception as e:  # noqa: BLE001 — classify below
                    err = e
                else:
                    err = self._relay(replica, freq, backend)
                    if err is None:
                        return          # finished; _relay closed it
                if not self._failover(freq, replica, err):
                    return
        except Exception as e:  # noqa: BLE001 — never strand a client
            if not freq.done():
                freq._fail(e)
        finally:
            self._threads.discard(threading.current_thread())

    def _route(self, freq):
        """Pick the healthy replica to serve `freq` (least loaded,
        admission count breaks ties). No healthy replica: supervise the
        corpses (replacement may restore one synchronously), then shed
        typed while live replicas remain — `FleetDeadError` latches
        only at zero live replicas."""
        while True:
            if self._closing:
                raise RuntimeError("FleetRouter is shut down")
            if self._dead is not None:
                raise self._dead
            now = self._clock()
            best = best_load = None
            dead = []
            alive = 0
            for r in self._replicas:
                h = self._health(r, now)
                if h == "dead":
                    dead.append(r)
                    continue
                alive += 1
                if h != "healthy":
                    continue
                load = (len(r.server._slot_req)
                        + r.server._queue.qsize(), r.routed)
                if best is None or load < best_load:
                    best, best_load = r, load
            if best is not None:
                if dead:
                    # healthy capacity remains: revive the corpses OFF
                    # the dispatch path (replacement builds block on
                    # warmup) — an idle replica's death must not wait
                    # for the fleet to drain before it is replaced
                    self._kick_supervision(dead)
                return best
            progressed = False
            for r in dead:
                cause = r.server._dead \
                    or RuntimeError("replica shut down")
                if self._supervise(r, cause):
                    progressed = True
            if progressed:
                continue
            if alive:
                with self._lock:
                    self.stats["shed"] += 1
                raise InferenceOverloadedError(
                    "fleet shed: no healthy replica "
                    "(remaining replicas degraded or burn-breached)")
            self._latch(FleetDeadError(
                "no live replica remains and replacement is exhausted"))
            raise self._dead

    def _dispatch(self, replica, freq):
        """Hand `freq` to `replica` through the adopt hook: a fresh
        backend request under the request's FLEET admission id, carrying
        the delivered prefix (failover) for journal-replay suppression.
        The `router.dispatch` chaos site fires first — an injected
        fault here must be absorbed by the failover budget."""
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.ROUTER_DISPATCH)
        remaining = None
        if freq.deadline is not None:
            remaining = (freq.deadline - self._clock()) * 1e3
            if remaining <= 0:
                raise InferenceTimeoutError(
                    "fleet request deadline expired before dispatch")
        backend = GenerationRequest(
            freq.prompt, freq.max_new_tokens, freq.eos_id, freq.method,
            freq.temperature, freq.top_k)
        backend.tokens = list(freq.tokens)
        replica.server.adopt(backend, freq.admit_id,
                             timeout_ms=remaining)
        replica.routed += 1
        freq.routes.append(replica.name)
        if freq.trace is not None:
            freq.trace.event("route", replica=replica.name,
                             attempt=freq.attempts + 1,
                             delivered=len(freq.tokens))
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.FLEET_ROUTED, labels={"replica": replica.name},
                help="fleet admissions dispatched per replica").inc()
        return backend

    def _relay(self, replica, freq, backend):
        """Pump the backend stream into the client handle. Returns None
        once the stream finished (the fleet request is closed), or the
        terminal exception for `_failover` to classify. The backend was
        seeded with the delivered prefix, so only NEW tokens ever
        arrive here — exactly-once needs no bookkeeping."""
        per_tok = None
        if freq.deadline is not None:
            per_tok = max(1e-3, freq.deadline - self._clock())
        try:
            for tok in backend.stream(timeout=per_tok):
                freq._push(tok)
        except Exception as e:  # noqa: BLE001 — classified by caller
            return e
        self._mark(replica, ok=True)
        with self._lock:
            self.stats["completed"] += 1
        freq._finish(backend.finish_reason)
        return None

    def _failover(self, freq, replica, exc):
        """One consumed attempt: mark the replica's gauge, supervise it
        if it died, and decide — re-route (True) within the budget and
        deadline, or fail the request typed (False)."""
        self._mark(replica, ok=False)
        replica.failovers += 1
        if isinstance(exc, ServerDeadError):
            self._supervise(replica, exc)
        if isinstance(exc, TimeoutError) and \
                not isinstance(exc, InferenceTimeoutError):
            # stream stall past the deadline: per-token waits are cut
            # to the remaining budget, so this IS deadline exhaustion
            err = InferenceTimeoutError(
                "fleet request deadline expired mid-stream")
            err.__cause__ = exc
            self._finalize(freq, err)
            return False
        expired = freq.deadline is not None \
            and self._clock() >= freq.deadline
        if expired or not self._retryable(exc, replica) \
                or freq.attempts >= self.failover_budget:
            self._finalize(freq, exc)
            return False
        freq.attempts += 1
        with self._lock:
            self.stats["failovers"] += 1
        if freq.trace is not None:
            freq.trace.event("failover", from_replica=replica.name,
                             attempt=freq.attempts,
                             delivered=len(freq.tokens),
                             error=type(exc).__name__)
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.FLEET_FAILOVERS,
                help="mid-stream request re-routes via journal "
                     "replay").inc()
            _events.emit(
                "fleet", _events.REQUEST_FAILOVER,
                attrs={"from": replica.name,
                       "delivered": len(freq.tokens),
                       "attempt": freq.attempts,
                       "error": type(exc).__name__,
                       "request": freq.trace_id},
                correlation_id=self._corr)
        return True

    @staticmethod
    def _retryable(exc, replica):
        """Failover classifier: replica-scoped failures re-route
        (another replica continues the stream bit-identically); a
        purity violation or a client error never does."""
        if isinstance(exc, ReplayDivergedError):
            return False
        if isinstance(exc, (ServerDeadError, TransientError,
                            InferenceOverloadedError,
                            MemoryPressureError)):
            return True
        # a dispatch that raced the supervisor's drain of this replica
        return isinstance(exc, RuntimeError) and replica.server._shutdown

    def _finalize(self, freq, exc):
        with self._lock:
            self.stats["failed"] += 1
        if not freq.done():
            freq._fail(exc)

    def _mark(self, replica, ok):
        replica.gauge.record(self._clock(), bad=not ok)

    def _health(self, replica, now):
        """Replica health for routing, with the burn-transition event
        (one `replica.unhealthy` per breach episode) on the edge."""
        h = replica.health(now)
        if h == "unhealthy" and not replica.unhealthy_latched:
            replica.unhealthy_latched = True
            if _mon.enabled():
                _events.emit(
                    "fleet", _events.REPLICA_UNHEALTHY,
                    attrs={"replica": replica.name,
                           "reason": "burn_rate"},
                    correlation_id=self._corr)
        elif h == "healthy" and replica.unhealthy_latched:
            replica.unhealthy_latched = False
        return h

    # -- replica supervision (the declared cold boundary) -----------------
    def _kick_supervision(self, dead):
        """Spawn (at most) one background reviver per dead replica so
        an idle replica's death is repaired while the survivors keep
        serving. The flag check races benignly: `_supervise` serializes
        on the replica lock and no-ops once the slot is live again."""
        for r in dead:
            if r.factory is None or r.restarts_left <= 0 or r.reviving:
                continue
            r.reviving = True
            threading.Thread(target=self._revive, args=(r,),
                             daemon=True,
                             name=f"fleet-revive-{r.name}").start()

    def _revive(self, replica):
        try:
            cause = replica.server._dead \
                or RuntimeError("replica shut down")
            self._supervise(replica, cause)
        finally:
            replica.reviving = False

    def _supervise(self, replica, cause):
        """Drain a dead replica and build its replacement from the
        factory over the shared manifest directory (`compiled` 0; on the
        card it captures its graphs here). Runs inline in the first relay thread
        that observed the death (or in a background reviver thread for
        idle deaths), serialized per replica; returns True
        when the roster slot holds a live server again. An exhausted
        restart budget (or a failed replacement — the `replica.restart`
        chaos site fires just before the build) leaves the slot dead;
        the fleet latches only when EVERY slot is."""
        with replica.lock:
            srv = replica.server
            if srv._dead is None and not srv._shutdown:
                return True             # someone already replaced it
            mon_on = _mon.enabled()
            if mon_on:
                _events.emit(
                    "fleet", _events.REPLICA_UNHEALTHY,
                    attrs={"replica": replica.name, "reason": "dead",
                           "error": type(cause).__name__},
                    correlation_id=self._corr)
            open_slots = len(srv._slot_req)
            srv.shutdown()              # idempotent: reap loop thread
            if mon_on:
                _events.emit(
                    "fleet", _events.REPLICA_DRAINED,
                    attrs={"replica": replica.name,
                           "open_requests": open_slots},
                    correlation_id=self._corr)
            if replica.factory is None or replica.restarts_left <= 0:
                return False
            replica.restarts_left -= 1
            try:
                if _faults.ACTIVE is not None:
                    _faults.ACTIVE.fire(_faults.REPLICA_RESTART)
                fresh = replica.factory()
                warm = fresh.warmup()
            except Exception:  # noqa: BLE001 — slot stays dead; the
                return False   # fleet keeps serving on the survivors
            with self._lock:
                replica.server = fresh
            replica.gauge.reset()
            replica.unhealthy_latched = False
            replica.replacements += 1
            with self._lock:
                self.stats["replacements"] += 1
            if mon_on:
                reg = _mon.get_registry()
                reg.counter(
                    _mon.FLEET_REPLACEMENTS,
                    help="replacement replicas built by the fleet "
                         "supervisor").inc()
                _events.emit(
                    "fleet", _events.REPLICA_REPLACED,
                    attrs={"replica": replica.name,
                           "compiled": warm.get("compiled"),
                           "from_disk": warm.get("from_disk")},
                    correlation_id=self._corr)
            return True

    def _latch(self, err):
        with self._lock:
            if self._dead is None:
                self._dead = err
                if _mon.enabled():
                    _events.emit(
                        "fleet", _events.SERVER_DEAD,
                        attrs={"reason": "no live replica remains"},
                        correlation_id=self._corr)

    # -- autoscale / registry / status ------------------------------------
    def autoscale(self):
        """The autoscale signal: desired replica count from queue depth
        x SLO burn. Utilization is (active + queued) / total slots over
        live replicas; the burn factor is the worst breached
        objective's short-window burn from the installed SloTracker.
        Pull-path only (`/fleet`, status(), publish())."""
        now = self._clock()
        live = healthy = depth = slots = 0
        for r in self._replicas:
            h = r.health(now)
            if h == "dead":
                continue
            live += 1
            if h == "healthy":
                healthy += 1
            slots += r.server.slots
            depth += len(r.server._slot_req) + r.server._queue.qsize()
        utilization = (depth / slots) if slots else 0.0
        burn = 1.0
        tracker = _slo.ACTIVE
        if tracker is not None:
            try:
                snap = tracker.snapshot()
                for o in snap.get("objectives", {}).values():
                    if o.get("breached"):
                        burn = max(burn, float(o.get("burn_short")
                                               or 1.0))
            except Exception:  # noqa: BLE001 — signal must not raise
                pass
        if live:
            desired = max(1, math.ceil(live * utilization * burn))
        else:
            desired = max(1, len(self._replicas))
        if self.max_replicas is not None:
            desired = min(desired, self.max_replicas)
        out = {"queue_depth": depth, "slots": slots,
               "utilization": round(utilization, 4),
               "slo_burn": round(burn, 4),
               "replicas_live": live, "replicas_healthy": healthy,
               "desired_replicas": desired}
        if _mon.enabled():
            reg = _mon.get_registry()
            reg.gauge(_mon.FLEET_HEALTHY,
                      help="replicas currently admitting "
                           "traffic").set(healthy)
            reg.gauge(_mon.FLEET_DESIRED_REPLICAS,
                      help="autoscale signal: queue depth x SLO burn "
                           "-> replica count").set(desired)
        return out

    def fleet_state(self):
        """Compact survivability view for `GET /health`
        (resilience.health_snapshot): dead → the fleet latched
        `FleetDeadError`; degraded → at least one replica is out of
        the healthy pool; serving otherwise."""
        now = self._clock()
        healths = [r.health(now) for r in self._replicas]
        if self._dead is not None:
            state = "dead"
        elif all(h == "healthy" for h in healths):
            state = "serving"
        else:
            state = "degraded"
        return {"state": state,
                "replicas": dict(zip((r.name for r in self._replicas),
                                     healths)),
                "desired_replicas": self.autoscale()["desired_replicas"]}

    def status(self):
        now = self._clock()
        return {"replicas": [r.snapshot(now) for r in self._replicas],
                "failover_budget": self.failover_budget,
                "dead": self._dead is not None,
                "autoscale": self.autoscale(),
                **self.stats}

    def publish(self, coordinator=None):
        """Publish this process's replica registry entry
        (`fleet/<process_id>` on the coordination KV) — the cross-host
        half of the roster. Returns the published document (None
        without a coordinator)."""
        coord = _coordinator(coordinator)
        if coord is None:
            return None
        now = self._clock()
        doc = {"process_id": coord.process_id,
               "replicas": [r.snapshot(now) for r in self._replicas],
               "autoscale": self.autoscale()}
        coord.publish_json(f"fleet/{coord.process_id}", doc)
        return doc

    # -- lifecycle --------------------------------------------------------
    def shutdown(self):
        """Idempotent: stop routing, shut every replica down (their
        open backends fail; relay threads surface that to clients) and
        reap the relay threads."""
        self._closing = True
        for r in self._replicas:
            try:
                r.server.shutdown()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        for th in list(self._threads):
            th.join(timeout=5)

    def __enter__(self):
        self.warmup()
        return self

    def __exit__(self, *exc):
        self.shutdown()


def _coordinator(coordinator):
    """An explicit coordinator (duck-typed: `process_id`, `publish_json`,
    `fetch_json_dir`), else the active one of the port's coordination
    module when something imported it (read through sys.modules), else
    None — the reference's answer when no coordinator is active."""
    if coordinator is not None:
        return coordinator
    co = sys.modules.get("deeplearning4j_tpu_torch.parallel.coordination")
    return None if co is None else getattr(co, "ACTIVE", None)


def status():
    """Aggregate fleet status for every live router
    (`GET /fleet` on the UIServer)."""
    return {"routers": [r.status() for r in list(_ROUTERS)]}


def directory(coordinator=None):
    """The merged cross-host replica registry: every process's
    published `fleet/<process_id>` document keyed by process id."""
    coord = _coordinator(coordinator)
    if coord is None:
        return {}
    return coord.fetch_json_dir("fleet/")

"""Ops event journal: one bounded, ordered record of state transitions.

Every significant state transition across the resilience, generation,
parallel, and monitoring subsystems emits one typed event

    {seq, monotonic_ts, wall_ts, subsystem, kind, severity, attrs,
     correlation_id}

into a process-wide ring bounded by ``DL4J_EVENT_RING`` (default 512).
The journal is the *causal* record the per-subsystem counters can't
give: counters say a rollback happened, the journal says the rollback
followed a retry that followed a divergence check at step 41, and that
the whole episode resolved in 1.8 s.

Incident correlation rides on top of the ring: an error-severity event
opens an **incident** that absorbs causally-adjacent events — same
correlation id, or within ``DL4J_INCIDENT_WINDOW`` seconds of the
incident's last event — until a resolving event closes it (resolution =
that event's kind) or a quiet period of ``DL4J_INCIDENT_QUIET`` seconds
passes (resolution = None). Each incident yields
``{trigger, actions[], resolution, duration_s}`` — the machine-readable
drain/replace/autoscale signal ROADMAP item 1's fleet router consumes.

Zero-cost when monitoring is disabled: ``emit`` is a no-op behind one
branch, every producer hook is one guarded branch
(``if _mon.enabled(): _events.emit(...)``), and
``scripts/check_fastpath.py`` enforces both (guard presence in the
producer modules, no device syncs reachable from the emit path).
``scripts/check_event_coverage.py`` asserts every kind declared below
is exercised by at least one test.

Served by the dashboard as ``GET /events?last=N`` and ``GET
/incidents``; ``write_bundle`` assembles the seven-section post-mortem
JSON (event tail, incidents, metrics registry, step-recorder tail,
request ring, health/SLO state, open spans) invoked from crash dumps,
stall/peer reports, and ``POST /debug/bundle``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from deeplearning4j_tpu_torch.monitoring.state import STATE

# --------------------------------------------------------------------------
# Event-kind catalog.  Module-level UPPER = "dotted.kind" constants, AST-
# parseable by scripts/check_event_coverage.py exactly like the fault-site
# constants in resilience/faults.py.  Severity: "info" < "warn" < "error".
# An error-severity event opens an incident (unless absorbed by one already
# open); a kind listed in _RESOLVING closes the incident that absorbs it.

#: guardian loss-spike ladder requested an lr-scaled retry
GUARDIAN_RETRY = "guardian.retry"
#: guardian requested (or completed, attrs["phase"]) a checkpoint rollback
GUARDIAN_ROLLBACK = "guardian.rollback"
#: guardian exhausted its ladder — training marked unhealthy
GUARDIAN_DIVERGED = "guardian.diverged"
#: guardian saw enough clean checks to restore lr_scale to 1.0
GUARDIAN_RECOVERED = "guardian.recovered"
#: watchdog tripped: no heartbeat within the stall timeout
WATCHDOG_STALL = "watchdog.stall"
#: heartbeats resumed after a stall
WATCHDOG_RECOVERED = "watchdog.recovered"
#: an armed FaultPlan fired at a chaos site
FAULT_INJECTED = "fault.injected"
#: serving pressure ladder climbed a rung (attrs: level, action)
PRESSURE_ESCALATED = "pressure.escalated"
#: serving pressure ladder stepped down (resolves at level 0)
PRESSURE_RELIEVED = "pressure.relieved"
#: admission refused a request (attrs: status = shed|timeout|rejected)
SERVER_REFUSED = "server.refused"
#: queued requests shed under memory pressure (attrs: shed)
SERVER_SHED = "server.shed"
#: decode cache grew to a larger rung (attrs: to_rung)
CACHE_GROWN = "cache.grown"
#: decode cache rung capacity shrunk under pressure (attrs: cap)
CACHE_SHRUNK = "cache.shrunk"
#: KV page pool could not cover an admission/growth
PAGES_EXHAUSTED = "pages.exhausted"
#: cold KV pages evicted to relieve pressure (attrs: evicted)
PAGES_EVICTED = "pages.evicted"
#: a device fault interrupted serving; crash-replay starting
SERVER_DISRUPTED = "server.disrupted"
#: one in-flight request re-admitted bit-identically after a crash
SERVER_REPLAY = "server.replay"
#: supervised restart rebuilt the server after a failed recovery
SERVER_RESTARTED = "server.restarted"
#: serving recovered — replay or supervised restart succeeded
SERVER_RECOVERED = "server.recovered"
#: restart budget exhausted: server permanently dead (attrs: reason)
SERVER_DEAD = "server.dead"
#: membership committed a new epoch (attrs: epoch, joins, leaves)
MEMBERSHIP_EPOCH = "membership.epoch"
#: this host was admitted into the cluster at an epoch boundary
MEMBERSHIP_JOINED = "membership.joined"
#: this host announced an orderly leave
MEMBERSHIP_LEAVE = "membership.leave"
#: a lost host was replaced and the mesh re-formed (attrs: lost)
MEMBERSHIP_REPLACED = "membership.replaced"
#: a peer host was declared lost (heartbeat/barrier failure)
PEER_LOST = "peer.lost"
#: peers disagreed on coordinated state (step desync)
PEER_DESYNC = "peer.desync"
#: an SLO objective's burn rate breached (attrs: objective, exemplars)
SLO_BREACH = "slo.breach"
#: a breached SLO objective recovered
SLO_RECOVER = "slo.recover"
#: the fleet router stopped admitting to a replica (attrs: replica,
#: reason = dead|burn_rate) — the replica-lost incident trigger
REPLICA_UNHEALTHY = "replica.unhealthy"
#: the supervisor drained a lost replica before replacement (attrs:
#: replica, open_requests re-routed through failover)
REPLICA_DRAINED = "replica.drained"
#: a fresh replica took the lost one's roster slot (warm spin-up from
#: the shared FunctionStore: attrs carry compiled/from_disk counts) —
#: resolves the replica-lost incident
REPLICA_REPLACED = "replica.replaced"
#: one in-flight request re-routed to a healthy replica (journal
#: replay, delivered prefix suppressed; attrs: from, to, delivered)
REQUEST_FAILOVER = "request.failover"

#: kind -> default severity.  Every kind the journal accepts is here.
KIND_SEVERITY = {
    GUARDIAN_RETRY: "error",
    GUARDIAN_ROLLBACK: "error",
    GUARDIAN_DIVERGED: "error",
    GUARDIAN_RECOVERED: "info",
    WATCHDOG_STALL: "error",
    WATCHDOG_RECOVERED: "info",
    FAULT_INJECTED: "info",
    PRESSURE_ESCALATED: "error",
    PRESSURE_RELIEVED: "info",
    SERVER_REFUSED: "warn",
    SERVER_SHED: "warn",
    CACHE_GROWN: "info",
    CACHE_SHRUNK: "warn",
    PAGES_EXHAUSTED: "warn",
    PAGES_EVICTED: "info",
    SERVER_DISRUPTED: "error",
    SERVER_REPLAY: "info",
    SERVER_RESTARTED: "warn",
    SERVER_RECOVERED: "info",
    SERVER_DEAD: "error",
    MEMBERSHIP_EPOCH: "info",
    MEMBERSHIP_JOINED: "info",
    MEMBERSHIP_LEAVE: "info",
    MEMBERSHIP_REPLACED: "warn",
    PEER_LOST: "error",
    PEER_DESYNC: "error",
    SLO_BREACH: "error",
    SLO_RECOVER: "info",
    REPLICA_UNHEALTHY: "error",
    REPLICA_DRAINED: "warn",
    REPLICA_REPLACED: "info",
    REQUEST_FAILOVER: "warn",
}

#: kinds that close the incident absorbing them (resolution = kind).
_RESOLVING = frozenset({
    GUARDIAN_RECOVERED,
    WATCHDOG_RECOVERED,
    SERVER_RECOVERED,
    SLO_RECOVER,
    REPLICA_REPLACED,
})

_DEFAULT_RING = 512
_DEFAULT_WINDOW_S = 5.0
_DEFAULT_QUIET_S = 10.0
_CLOSED_KEEP = 64
_ACTIONS_KEEP = 64


def _env_float(name, default):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class Incident:
    """One correlated episode: trigger -> actions[] -> resolution."""

    __slots__ = ("id", "trigger", "actions", "dropped_actions",
                 "resolution", "opened_ts", "last_ts", "closed_ts",
                 "correlation_id", "state")

    def __init__(self, incident_id, trigger):
        self.id = incident_id
        self.trigger = trigger
        self.actions = deque(maxlen=_ACTIONS_KEEP)
        self.dropped_actions = 0
        self.resolution = None
        self.opened_ts = trigger["monotonic_ts"]
        self.last_ts = trigger["monotonic_ts"]
        self.closed_ts = None
        self.correlation_id = trigger["correlation_id"]
        self.state = "open"

    def absorb(self, event):
        if len(self.actions) == self.actions.maxlen:
            self.dropped_actions += 1
        self.actions.append(event)
        self.last_ts = event["monotonic_ts"]
        if self.correlation_id is None:
            self.correlation_id = event["correlation_id"]

    def close(self, ts, resolution):
        self.state = "resolved"
        self.closed_ts = ts
        self.resolution = resolution

    def snapshot(self):
        events = [self.trigger] + list(self.actions)
        end = self.closed_ts if self.closed_ts is not None else self.last_ts
        links = {"trace": "/trace"}
        requests = []
        for e in events:
            rid = (e.get("attrs") or {}).get("request")
            if rid and rid not in requests:
                requests.append(rid)
        if requests:
            links["requests"] = ["/requests/%s" % r for r in requests]
        return {
            "id": self.id,
            "state": self.state,
            "trigger": self.trigger,
            "actions": list(self.actions),
            "dropped_actions": self.dropped_actions,
            "resolution": self.resolution,
            "correlation_id": self.correlation_id,
            "opened_ts": self.opened_ts,
            "closed_ts": self.closed_ts,
            "duration_s": round(end - self.opened_ts, 6),
            "kinds": [e["kind"] for e in events],
            "links": links,
        }


class EventJournal:
    """Bounded ordered ring of ops events + the incident correlator.

    Appends are rare (state transitions, not per-token work) so a small
    lock keeps seq/ring/incident state consistent across threads; the
    disabled path never reaches here (module-level ``emit`` returns
    before touching the journal).
    """

    def __init__(self, capacity=None, window_s=None, quiet_s=None,
                 clock=time.monotonic):
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "DL4J_EVENT_RING", str(_DEFAULT_RING)))
            except ValueError:
                capacity = _DEFAULT_RING
        self.capacity = max(1, capacity)
        self.window_s = (window_s if window_s is not None
                         else _env_float("DL4J_INCIDENT_WINDOW",
                                         _DEFAULT_WINDOW_S))
        self.quiet_s = (quiet_s if quiet_s is not None
                        else _env_float("DL4J_INCIDENT_QUIET",
                                        _DEFAULT_QUIET_S))
        self._clock = clock
        self._lock = threading.Lock()
        self._ring = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0
        self._open = []
        self._closed = deque(maxlen=_CLOSED_KEEP)
        self._incident_seq = 0
        self.resolved_total = 0

    # -- emission ----------------------------------------------------------

    def emit(self, subsystem, kind, attrs=None, correlation_id=None,
             severity=None, resolves=None):
        if severity is None:
            severity = KIND_SEVERITY.get(kind, "info")
        if resolves is None:
            resolves = kind in _RESOLVING
        now = self._clock()
        with self._lock:
            self._seq += 1
            event = {
                "seq": self._seq,
                "monotonic_ts": now,
                "wall_ts": time.time(),
                "subsystem": subsystem,
                "kind": kind,
                "severity": severity,
                "attrs": dict(attrs) if attrs else {},
                "correlation_id": correlation_id,
            }
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(event)
            self._correlate(event, now, resolves)
            self._publish_locked()
        return event

    def _correlate(self, event, now, resolves):
        self._sweep_quiet(now)
        target = None
        for inc in reversed(self._open):
            same_corr = (event["correlation_id"] is not None
                         and inc.correlation_id == event["correlation_id"])
            if same_corr or now - inc.last_ts <= self.window_s:
                target = inc
                break
        if target is not None:
            event["incident"] = target.id
            if resolves:
                target.absorb(event)
                self._close(target, now, event["kind"])
            else:
                target.absorb(event)
            return
        if event["severity"] == "error" and not resolves:
            self._incident_seq += 1
            inc = Incident(self._incident_seq, event)
            event["incident"] = inc.id
            self._open.append(inc)

    def _sweep_quiet(self, now):
        # iterate a copy: _close() removes from self._open in place
        for inc in list(self._open):
            if now - inc.last_ts > self.quiet_s:
                self._close(inc, now, None)

    def _close(self, inc, ts, resolution):
        inc.close(ts, resolution)
        if inc in self._open:
            self._open.remove(inc)
        self._closed.append(inc)
        self.resolved_total += 1

    def _publish_locked(self):
        # Journal state -> metrics.  Reached only from emit(), which the
        # module-level guard already limits to enabled monitoring.
        try:
            from deeplearning4j_tpu_torch.monitoring import registry as _registry
            reg = _registry.get_registry()
            reg.counter(_registry.EVENTS_EMITTED,
                        help="ops events emitted into the journal").inc()
            if self.dropped:
                reg.gauge(
                    _registry.EVENTS_DROPPED,
                    help="ops events dropped from the bounded ring",
                ).set(self.dropped)
            reg.gauge(_registry.INCIDENTS_OPEN,
                      help="currently open correlated incidents").set(
                          len(self._open))
            reg.gauge(_registry.INCIDENTS_RESOLVED,
                      help="incidents closed since startup").set(
                          self.resolved_total)
        except Exception:
            pass

    # -- read side ---------------------------------------------------------

    def snapshot(self, last=64):
        with self._lock:
            self._sweep_quiet(self._clock())
            events = list(self._ring)
            emitted = self._seq
            dropped = self.dropped
        if last is not None and last >= 0:
            # slice via len(): events[-0:] would be the WHOLE ring
            events = events[len(events) - min(last, len(events)):]
        return {
            "events": events,
            "capacity": self.capacity,
            "emitted": emitted,
            "dropped": dropped,
        }

    def incidents(self):
        with self._lock:
            self._sweep_quiet(self._clock())
            open_snap = [inc.snapshot() for inc in self._open]
            recent = [inc.snapshot() for inc in reversed(self._closed)]
        return {
            "open": open_snap,
            "recent": recent,
            "resolved_total": self.resolved_total,
            "window_s": self.window_s,
            "quiet_s": self.quiet_s,
        }


_JOURNAL = None
_JOURNAL_LOCK = threading.Lock()


def journal():
    """The process-wide journal (created on first use)."""
    global _JOURNAL
    if _JOURNAL is None:
        with _JOURNAL_LOCK:
            if _JOURNAL is None:
                _JOURNAL = EventJournal()
    return _JOURNAL


def reset(**kwargs):
    """Swap in a fresh journal (tests); kwargs forward to EventJournal."""
    global _JOURNAL
    with _JOURNAL_LOCK:
        _JOURNAL = EventJournal(**kwargs)
    return _JOURNAL


def emit(subsystem, kind, attrs=None, correlation_id=None,
         severity=None, resolves=None):
    """Record one ops event.  No-op (one branch) when monitoring is off."""
    if not STATE.enabled:
        return None
    return journal().emit(subsystem, kind, attrs=attrs,
                          correlation_id=correlation_id,
                          severity=severity, resolves=resolves)


def snapshot(last=64):
    """Tail of the event ring (``GET /events?last=N``)."""
    return journal().snapshot(last=last)


def incidents():
    """Open + recent correlated incidents (``GET /incidents``)."""
    return journal().incidents()


# --------------------------------------------------------------------------
# Post-mortem bundle: one JSON with everything an operator opens first.

BUNDLE_SECTIONS = ("events", "incidents", "metrics", "steps",
                   "requests", "health", "spans")


def bundle(headline=None):
    """Assemble the seven-section post-mortem document (best-effort:
    a section that fails to snapshot becomes None, never an exception —
    this runs from crash paths)."""
    doc = {"meta": {
        "headline": headline,
        "written_wall_ts": time.time(),
        "pid": os.getpid(),
        "monitoring_enabled": STATE.enabled,
        "sections": list(BUNDLE_SECTIONS),
    }}
    j = journal()
    try:
        doc["events"] = j.snapshot(last=None)
    except Exception:
        doc["events"] = None
    try:
        doc["incidents"] = j.incidents()
    except Exception:
        doc["incidents"] = None
    try:
        from deeplearning4j_tpu_torch.monitoring import registry as _registry
        doc["metrics"] = _registry.get_registry().snapshot()
    except Exception:
        doc["metrics"] = None
    try:
        from deeplearning4j_tpu_torch.monitoring import steps as _steps
        rec = _steps.recorder()
        doc["steps"] = {"records": rec.records(last=64),
                        "summary": rec.summary()}
    except Exception:
        doc["steps"] = None
    try:
        from deeplearning4j_tpu_torch.monitoring import requests as _requests
        doc["requests"] = _requests.request_log().snapshot(last=64)
    except Exception:
        doc["requests"] = None
    try:
        from deeplearning4j_tpu_torch import resilience as _resilience
        doc["health"] = _resilience.health_snapshot()
    except Exception:
        doc["health"] = None
    try:
        from deeplearning4j_tpu_torch.monitoring.tracing import get_tracer
        doc["spans"] = {str(tid): stack for tid, stack
                        in get_tracer().open_spans().items()}
    except Exception:
        doc["spans"] = None
    return doc


def write_bundle(path=None, dump_dir=None, headline=None,
                 prefix="dl4j-bundle"):
    """Write the post-mortem bundle as one JSON file; returns the path
    (or None if even the write failed — crash paths must not re-raise)."""
    try:
        doc = bundle(headline=headline)
        if path is None:
            directory = dump_dir or os.environ.get(
                "DL4J_CRASH_DUMP_DIR") or os.getcwd()
            os.makedirs(directory, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            path = os.path.join(
                directory, "%s-%s-%d.json" % (prefix, stamp, os.getpid()))
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        return path
    except Exception:
        return None


def event_tail_lines(last=20):
    """The shared human-readable journal-tail section embedded in every
    text debug artifact (crash dumps, stall reports, peer reports)."""
    lines = ["Ops event journal (tail):"]
    try:
        snap = journal().snapshot(last=last)
        events = snap["events"]
        if not events:
            lines.append("  (no events recorded)")
        for e in events:
            corr = e.get("correlation_id")
            attrs = e.get("attrs") or {}
            extra = " ".join("%s=%s" % (k, attrs[k]) for k in sorted(attrs))
            lines.append("  #%-4d [%s] %s %s%s%s" % (
                e["seq"], e["severity"], e["subsystem"], e["kind"],
                (" " + extra) if extra else "",
                (" corr=%s" % corr) if corr else ""))
        if snap["dropped"]:
            lines.append("  (+%d older events dropped from the ring)"
                         % snap["dropped"])
    except Exception as exc:
        lines.append("  (journal unavailable: %r)" % (exc,))
    return lines


__all__ = [
    "EventJournal", "Incident", "KIND_SEVERITY", "BUNDLE_SECTIONS",
    "journal", "reset", "emit", "snapshot", "incidents",
    "bundle", "write_bundle", "event_tail_lines",
    "GUARDIAN_RETRY", "GUARDIAN_ROLLBACK", "GUARDIAN_DIVERGED",
    "GUARDIAN_RECOVERED", "WATCHDOG_STALL", "WATCHDOG_RECOVERED",
    "FAULT_INJECTED", "PRESSURE_ESCALATED", "PRESSURE_RELIEVED",
    "SERVER_REFUSED", "SERVER_SHED", "CACHE_GROWN", "CACHE_SHRUNK",
    "PAGES_EXHAUSTED", "PAGES_EVICTED", "SERVER_DISRUPTED",
    "SERVER_REPLAY", "SERVER_RESTARTED", "SERVER_RECOVERED",
    "SERVER_DEAD", "MEMBERSHIP_EPOCH", "MEMBERSHIP_JOINED",
    "MEMBERSHIP_LEAVE", "MEMBERSHIP_REPLACED", "PEER_LOST",
    "PEER_DESYNC", "SLO_BREACH", "SLO_RECOVER",
    "REPLICA_UNHEALTHY", "REPLICA_DRAINED", "REPLICA_REPLACED",
    "REQUEST_FAILOVER",
]

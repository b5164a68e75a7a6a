"""Per-host step timelines + straggler attribution over the
coordination KV — the training-side twin of the cluster metrics plane
(`monitoring/cluster.py`).

In a multi-host run each process's step flight recorder
(`monitoring/steps.py`) is an island: per-step skew between hosts —
the signal elastic scale-up/replace decisions need — is invisible.
This module makes it visible with the same zero-cost discipline as the
cluster plane:

- **Publish** — at every coordination SYNC POINT (behind
  `_mon.enabled()`, best-effort), each process writes ONE compact JSON
  digest of its flight-recorder ring to `steps/<pid>` (overwrite —
  exactly one bounded key per process, nothing to reap): per-phase
  p50/p99 for data_next/stage/dispatch/exchange/listeners,
  host-blocked and compile totals, steps/s, and a short record tail
  for trace lanes. Zero new collectives, zero new host syncs — the
  digest is JSON over numbers the recorder already holds, and the lint
  (`scripts/check_fastpath.py`) walks this module to prove it.
- **Attribute** — process 0 (or any reader) gathers the digests and
  computes per-host ATTRIBUTED step time (sum of the `SUM_PHASES`
  p50s), the max-host / median-host ratio, and the culprit: the
  slowest host AND the phase with the largest excess over the
  cross-host median of that phase. Surfaces: `GET /stragglers`, new
  columns in the `GET /health` peer table, the
  `dl4j.dist.straggler_*` gauges (the labels ARE the culprit), the
  `StragglerObjective` SLO (`monitoring/slo.py`), and one named
  training lane per host in the merged Chrome trace (`GET /trace`).
- **Derive** — `derived_exchange_ms()` estimates the exposed exchange
  cost on any host count without issuing a collective: in a lockstep
  collective step every host leaves the exchange together, so the
  cross-host spread in dispatch-phase p50 is wall time the exchange
  exposed on the fast hosts (a conservative lower bound; the
  single-process probe in `parallel/multihost.py` remains the
  standalone upper bound).

The median is the LOWER median (`sorted[(n-1)//2]`): with two hosts it
is the fast host, so the ratio degrades to max/min instead of
saturating at 2× — small fleets still produce an actionable signal.
"""
from __future__ import annotations

import json
import time

from deeplearning4j_tpu_torch.monitoring import registry as _registry
from deeplearning4j_tpu_torch.monitoring import steps as _steps
from deeplearning4j_tpu_torch.monitoring.state import STATE

__all__ = ["publish", "gather", "attribution", "annotate_peer_table",
           "derived_exchange_ms", "chrome_events"]

#: KV key prefix (under the coordinator's namespace)
KEY_PREFIX = "steps/"

#: records shipped per publish — enough for a trace lane's recent
#: history, bounded regardless of the local ring size
TAIL = 16

#: Chrome-trace pid band for the per-host training lanes: far above the
#: request lanes' tid space (1_000_000+) and real OS pids, and disjoint
#: per host so each renders as its own named process lane
LANE_BASE = 2_000_000


def publish(coordinator, recorder=None, extra=None):
    """Write this process's flight-recorder digest to `steps/<pid>`
    (one bounded, overwritten key). Called from the coordinator's sync
    point behind the enabled-guard; best-effort — a full KV store must
    never fail a training step."""
    rec = recorder or _steps.recorder()
    snap = {"t": time.time(), "step": coordinator.step,
            "timeline": rec.compact_summary(tail=TAIL)}
    if extra:
        snap.update(extra)
    coordinator.publish(f"{KEY_PREFIX}{coordinator.process_id}",
                        json.dumps(snap), overwrite=True)
    return snap


def gather(coordinator):
    """{pid: published digest} for every host that has published one
    (this process included when it has)."""
    out = {}
    for suffix, v in coordinator.fetch_dir(KEY_PREFIX):
        try:
            out[int(suffix)] = json.loads(v)
        except (ValueError, TypeError):
            continue
    return out


def _median(vals):
    """Lower median — for two hosts this is the FAST one, so the
    straggler ratio degrades to max/min instead of capping at 2x."""
    s = sorted(vals)
    return s[(len(s) - 1) // 2] if s else None


def attribution(coordinator, snaps=None):
    """The straggler verdict: per-host attributed step time, the
    max/median ratio, and the culprit host + phase. None when the KV is
    unreachable; `ratio`/`slowest` are None below two usable hosts.

    Step time is the sum of the per-phase p50s (`steps.SUM_PHASES`) —
    attribution, not raw wall: wall anchors end-of-step to end-of-step
    and would charge inter-step idle to whichever host paused.

    On process 0 with monitoring enabled the verdict also lands on the
    `dl4j.dist.straggler_*` gauges with the culprit as labels."""
    try:
        snaps = gather(coordinator) if snaps is None else snaps
    except Exception:  # noqa: BLE001 — KV service down
        return None
    now = time.time()
    hosts = {}
    for pid, snap in sorted(snaps.items()):
        tl = snap.get("timeline") or {}
        phases = tl.get("phases") or {}
        p50s = {k: float(v["p50"]) for k, v in phases.items()
                if isinstance(v, dict) and v.get("p50") is not None}
        step_ms = sum(p50s.get(p, 0.0) for p in _steps.SUM_PHASES)
        wall = (tl.get("wall_ms") or {}).get("p50")
        hosts[str(pid)] = {
            "step_ms": round(step_ms, 3),
            "wall_p50_ms": wall,
            "phases_p50_ms": {k: round(v, 3) for k, v in p50s.items()},
            "steps_per_s": snap.get("steps_per_s"),
            "snapshot_age_s": round(max(0.0, now - snap.get("t", now)),
                                    3),
        }
    out = {"hosts": hosts, "published": len(hosts),
           "ratio": None, "median_step_ms": None, "slowest": None}
    usable = {h: d for h, d in hosts.items() if d["step_ms"] > 0}
    if len(usable) < 2:
        return out
    med = _median([d["step_ms"] for d in usable.values()])
    slow_host = max(usable, key=lambda h: usable[h]["step_ms"])
    slow = usable[slow_host]
    if not med or med <= 0:
        return out
    ratio = slow["step_ms"] / med
    # culprit phase: largest excess of the slow host's p50 over the
    # cross-host median for the SAME phase — "host 1 is slow, and it's
    # the dispatch phase", not just "host 1 is slow"
    phase, excess = None, 0.0
    keys = set()
    for d in usable.values():
        keys.update(d["phases_p50_ms"])
    for k in sorted(keys):
        pm = _median([d["phases_p50_ms"].get(k, 0.0)
                      for d in usable.values()])
        e = slow["phases_p50_ms"].get(k, 0.0) - (pm or 0.0)
        if e > excess:
            phase, excess = k, e
    out["ratio"] = round(ratio, 4)
    out["median_step_ms"] = round(med, 3)
    out["slowest"] = {"host": slow_host, "phase": phase,
                      "step_ms": slow["step_ms"],
                      "excess_ms": round(excess, 3),
                      "ratio": out["ratio"]}
    if STATE.enabled and coordinator.process_id == 0 \
            and phase is not None:
        reg = _registry.get_registry()
        labels = {"host": slow_host, "phase": phase}
        reg.gauge(_registry.DIST_STRAGGLER_RATIO, labels=labels,
                  help="max-host / median-host attributed step time; "
                       "the labels name the culprit host and phase"
                  ).set(ratio)
        reg.gauge(_registry.DIST_STRAGGLER_SKEW_MS, labels=labels,
                  help="slowest host's attributed step time excess "
                       "over the median host (ms)"
                  ).set(slow["step_ms"] - med)
    return out


def annotate_peer_table(coordinator, table, att=None):
    """Fold the per-host timeline columns + the straggler verdict into
    the `GET /health` peer table (best-effort, never raises)."""
    try:
        att = attribution(coordinator) if att is None else att
    except Exception:  # noqa: BLE001
        return table
    if att is None:
        return table
    for h, d in att["hosts"].items():
        try:
            pid = int(h)
        except ValueError:
            continue
        entry = table.setdefault(pid, {})
        entry["step_ms_p50"] = d["step_ms"]
        if d.get("wall_p50_ms") is not None:
            entry["step_wall_p50_ms"] = d["wall_p50_ms"]
    slow = att.get("slowest")
    if slow is not None:
        try:
            pid = int(slow["host"])
        except (ValueError, TypeError):
            return table
        table.setdefault(pid, {})["straggler"] = {
            "phase": slow["phase"], "ratio": slow["ratio"]}
    return table


def derived_exchange_ms(coordinator, snaps=None):
    """Multi-host exposed-exchange estimate from the per-phase
    attribution: the cross-host spread (max - min) of the
    dispatch-phase p50. In a lockstep collective step every host
    leaves the exchange together, so a host that reaches it late
    forces every other host to expose at least that difference waiting
    in the collective — a conservative lower bound on the exposure,
    measured on any host count without issuing a collective (the
    single-process probe stays the standalone upper bound). None below
    two reporting hosts."""
    try:
        snaps = gather(coordinator) if snaps is None else snaps
    except Exception:  # noqa: BLE001
        return None
    vals = []
    for snap in snaps.values():
        p = ((snap.get("timeline") or {}).get("phases") or {}) \
            .get("dispatch")
        if isinstance(p, dict) and p.get("p50") is not None:
            vals.append(float(p["p50"]))
    if len(vals) < 2:
        return None
    return max(vals) - min(vals)


def chrome_events(coordinator, epoch_ns=None):
    """One named Chrome-trace lane per host from the published record
    tails: a process-name metadata event (`train host <pid>`) plus one
    "X" slice per step, so a skewed step is visually obvious next to
    the local span lanes in Perfetto. Cross-host alignment rides the
    records' unix `ts`, mapped onto the tracer's perf-counter timebase
    via one (now_unix, now_perf) correspondence taken at export time —
    approximate to NTP skew, which is fine for eyeballing skew that
    the attribution already quantifies."""
    try:
        snaps = gather(coordinator)
    except Exception:  # noqa: BLE001
        return []
    now_perf_ns = time.perf_counter_ns()
    now_unix = time.time()
    base_ns = epoch_ns if epoch_ns is not None else now_perf_ns

    def to_us(unix_ts):
        return ((now_perf_ns - base_ns) / 1e3
                + (unix_ts - now_unix) * 1e6)

    out = []
    for pid, snap in sorted(snaps.items()):
        tail = (snap.get("timeline") or {}).get("tail") or []
        lane = LANE_BASE + int(pid)
        out.append({"ph": "M", "name": "process_name", "pid": lane,
                    "tid": 0, "args": {"name": f"train host {pid}"}})
        for r in tail:
            ts_end = r.get("ts")
            dur_ms = r.get("wall_ms")
            if dur_ms is None:
                dur_ms = sum((r.get("phases") or {}).values())
            if ts_end is None or not dur_ms:
                continue
            args = {"host": str(pid)}
            args.update(r.get("phases") or {})
            out.append({"ph": "X", "cat": "train",
                        "name": f"step {r.get('step')}",
                        "ts": to_us(ts_end) - dur_ms * 1e3,
                        "dur": dur_ms * 1e3,
                        "pid": lane, "tid": 0, "args": args})
    return out

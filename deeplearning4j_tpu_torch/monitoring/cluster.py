"""Cluster metrics plane: per-host metric snapshots over the
coordination KV, aggregated and served from process 0.

In a multi-host run each process's MetricsRegistry is an island —
`GET /metrics` on process 0 shows one host of an N-host job. This
module makes the fleet visible without any new collectives or syncs:

- **Publish** — at every coordination SYNC POINT (the guardian-flush
  cadence `parallel/coordination.py` already piggybacks on), each
  process with monitoring enabled writes ONE compact JSON snapshot of
  its registry to the KV store under `metrics/<pid>` (overwrite-
  allowed: exactly one bounded key per process, the bounded-key reap
  discipline taken to its fixed-point — nothing to reap). Publishing
  is host-side serialization of numbers the registry already holds;
  the train step itself is untouched.
- **Serve** — process 0's `GET /metrics` renders every host's series
  with a `host="<pid>"` label plus CLUSTER AGGREGATES under
  `host="cluster"` (counters and histogram count/sum summed across
  hosts; gauges stay per-host — summing occupancies would lie), and
  `dl4j.cluster.snapshot_age_seconds{host=...}` says how stale each
  host's view is (max over hosts rides `host="cluster"`: one wedged
  publisher is visible at a glance). `GET /health`'s "distributed"
  section carries the same per-host meta (step, steps/s, exchange
  bytes, age).

Zero-cost discipline: everything here is reached either from a sync
point (bounded cadence, behind `_mon.enabled()`) or from an endpoint
(pull). No hot path imports this module.
"""
from __future__ import annotations

import json
import time

from deeplearning4j_tpu_torch.monitoring import registry as _registry

__all__ = ["compact_snapshot", "publish", "gather", "health_meta",
           "cluster_prometheus_text"]

#: KV key prefix (under the coordinator's namespace)
KEY_PREFIX = "metrics/"


def compact_snapshot(registry=None):
    """JSON-compact registry dump for the KV wire: counters/gauges keep
    their value, histograms shrink to count/sum/p50/p99 (quantiles
    cannot aggregate across hosts anyway — they serve per-host)."""
    reg = registry or _registry.get_registry()
    metrics = {}
    for name, entries in reg.snapshot().items():
        out = []
        for e in entries:
            rec = {"labels": e["labels"], "kind": e["kind"]}
            if e["kind"] == "histogram":
                rec["count"] = e["count"]
                rec["sum"] = e["sum"]
                rec["p50"] = e["p50"]
                rec["p99"] = e["p99"]
            else:
                rec["value"] = e["value"]
            out.append(rec)
        metrics[name] = out
    return metrics


def publish(coordinator, registry=None, extra=None):
    """Write this process's snapshot to `metrics/<pid>` (one bounded,
    overwritten key). Called from the coordinator's sync point behind
    the enabled-guard; best-effort — a full KV store must never fail a
    training step."""
    snap = {"t": time.time(), "step": coordinator.step,
            "metrics": compact_snapshot(registry)}
    if extra:
        snap.update(extra)
    coordinator.publish(f"{KEY_PREFIX}{coordinator.process_id}",
                        json.dumps(snap), overwrite=True)
    return snap


def gather(coordinator):
    """{pid: published snapshot} for every host that has published one
    (this process included when it has)."""
    out = {}
    for suffix, v in coordinator.fetch_dir(KEY_PREFIX):
        try:
            out[int(suffix)] = json.loads(v)
        except (ValueError, TypeError):
            continue
    return out


def health_meta(coordinator, snaps=None):
    """The `GET /health` cluster section: per-host snapshot age, step,
    steps/s and exchange bytes, plus the max age (the wedged-publisher
    tell). Never raises — health must always answer."""
    try:
        snaps = gather(coordinator) if snaps is None else snaps
    except Exception:  # noqa: BLE001 — KV service down
        return None
    now = time.time()
    hosts, ages = {}, []
    for pid, snap in sorted(snaps.items()):
        age = round(max(0.0, now - snap.get("t", now)), 3)
        ages.append(age)
        hosts[str(pid)] = {
            "snapshot_age_s": age,
            "step": snap.get("step"),
            "steps_per_s": snap.get("steps_per_s"),
            "exchange_bytes": snap.get("exchange_bytes"),
        }
    return {"hosts": hosts,
            "max_snapshot_age_s": max(ages) if ages else None,
            "published": len(hosts)}


def _merge_host(families, pid, metrics):
    for name, entries in metrics.items():
        fam = families.setdefault(name, {"kind": entries[0]["kind"]
                                         if entries else "gauge",
                                         "series": []})
        for e in entries:
            labels = dict(e["labels"])
            labels["host"] = str(pid)
            fam["series"].append((labels, e))


def _aggregate(families):
    """host="cluster" series: counters and histogram count/sum summed
    across hosts per distinct non-host label set. Gauges don't
    aggregate (summing a fill ratio across hosts is a lie); their
    fleet view is the per-host series themselves."""
    for fam in families.values():
        if fam["kind"] == "counter":
            sums = {}
            for labels, e in fam["series"]:
                key = tuple(sorted((k, v) for k, v in labels.items()
                                   if k != "host"))
                sums[key] = sums.get(key, 0) + e.get("value", 0)
            for key, total in sorted(sums.items()):
                labels = dict(key)
                labels["host"] = "cluster"
                fam["series"].append((labels, {"kind": "counter",
                                               "value": total}))
        elif fam["kind"] == "histogram":
            sums = {}
            for labels, e in fam["series"]:
                key = tuple(sorted((k, v) for k, v in labels.items()
                                   if k != "host"))
                c, s = sums.get(key, (0, 0.0))
                sums[key] = (c + e.get("count", 0), s + e.get("sum", 0.0))
            for key, (c, s) in sorted(sums.items()):
                labels = dict(key)
                labels["host"] = "cluster"
                fam["series"].append((labels, {"kind": "histogram",
                                               "count": c, "sum": s,
                                               "p50": None,
                                               "p99": None}))


def cluster_prometheus_text(coordinator, registry=None):
    """The process-0 `/metrics` body in a multi-host run: every host's
    series labeled `host="<pid>"` (this process rendered LIVE from its
    own registry, peers from their last published snapshots), cluster
    aggregates under `host="cluster"`, and the per-host snapshot-age
    gauge. Output is the same strict exposition format the local
    renderer guarantees — one TYPE header per family, escaped labels,
    `+Inf`/`NaN` spellings."""
    reg = registry or _registry.get_registry()
    me = coordinator.process_id
    snaps = gather(coordinator)
    snaps[me] = {"t": time.time(), "metrics": compact_snapshot(reg)}
    families = {}
    for pid, snap in sorted(snaps.items()):
        _merge_host(families, pid, snap.get("metrics", {}))
    _aggregate(families)
    now = time.time()
    age_fam = families.setdefault(
        _registry.CLUSTER_SNAPSHOT_AGE, {"kind": "gauge", "series": []})
    ages = []
    for pid, snap in sorted(snaps.items()):
        age = max(0.0, now - snap.get("t", now))
        ages.append(age)
        age_fam["series"].append(({"host": str(pid)},
                                  {"kind": "gauge", "value": age}))
    if ages:
        age_fam["series"].append(({"host": "cluster"},
                                  {"kind": "gauge", "value": max(ages)}))
    helps = dict(reg.help_texts())
    helps.setdefault(_registry.CLUSTER_SNAPSHOT_AGE,
                     "age of each host's published metrics snapshot "
                     "(host=cluster is the max)")
    lines = []
    for name in sorted(families):
        fam = families[name]
        pname = _registry._prom_name(name)
        # header + sample rendering are the registry's own helpers —
        # escaping, ±Inf/NaN spellings and the summary line shapes stay
        # one rule for the local and the cluster scrape alike
        _registry._render_family_header(lines, pname, fam["kind"],
                                        helps.get(name))
        for labels, e in fam["series"]:
            rec = dict(e)
            if fam["kind"] == "histogram":
                # the compact KV wire carries p50/p99 only (quantiles
                # cannot aggregate across hosts; cluster rows are None)
                rec["quantiles"] = [("0.5", e.get("p50")),
                                    ("0.99", e.get("p99"))]
            _registry._render_sample_lines(lines, pname, fam["kind"],
                                           sorted(labels.items()), rec)
    return "\n".join(lines) + "\n"

"""Declarative SLOs with multi-window burn-rate evaluation.

A fleet replica needs a machine-checkable "am I healthy enough for
traffic" signal, not a human staring at dashboards. This module turns
the telemetry the repo already collects — latency histograms
(`registry.Histogram`), the step-time flight recorder
(`monitoring/steps.py`), counters — into declarative OBJECTIVES:

    tracker = SloTracker([
        LatencyObjective("per_token_p99",
                         metric=registry.GEN_PER_TOKEN_MS,
                         quantile=0.99, max_value=25.0),
        ThroughputObjective("steps_rate", max_drop=0.5),
        RatioObjective("replay_rate", num=registry.GEN_REPLAYS,
                       den=registry.GEN_ADMISSIONS, max_ratio=0.2),
    ])
    tracker.install()          # GET /health now reports breaches

Evaluation is PULL-based (the `/health` and `/slo` endpoints drive it,
rate-limited to `min_interval`): nothing on any hot path ever touches
this module, so the train/decode loops pay zero cost whether or not a
tracker is installed — the disabled-path discipline, just with the
guard at the endpoint instead of the call site.

Burn-rate semantics (the multi-window rule SRE burn-rate alerts use):
each evaluation samples every objective as good/bad; `burn_rate(w)` is
the bad fraction of the samples inside window `w`, divided by the
error budget (the tolerated bad fraction, default 10%). An objective
BREACHES when both the SHORT window (is it bad right now) and the LONG
window (has it been bad long enough to matter) burn faster than budget
(rate >= 1) — a single bad scrape can't page, and a real regression
trips within one short window. It AUTO-RECOVERS the moment either
window stops burning; `dl4j.slo.breaches` counts trips,
`dl4j.slo.burn_rate{objective,window}` and
`dl4j.slo.breached{objective}` track the live state, and
`GET /health` flips to degraded with the violated objective named.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from deeplearning4j_tpu_torch.monitoring import events as _events
from deeplearning4j_tpu_torch.monitoring import registry as _registry
from deeplearning4j_tpu_torch.monitoring.state import STATE

__all__ = ["Objective", "LatencyObjective", "ThroughputObjective",
           "RatioObjective", "StepTimeObjective", "StragglerObjective",
           "SloTracker", "ACTIVE", "clear_tracker",
           "standard_objectives"]

#: the installed tracker `resilience.health_snapshot()` consults
#: (faults.py ACTIVE pattern; None = no SLOs declared)
ACTIVE = None


class Objective:
    """One declarative objective. Subclasses implement `measure()` →
    True (violated) / False (met) / None (no evidence yet — e.g. the
    metric has no observations; inconclusive samples are skipped, they
    neither burn nor repay budget)."""

    def __init__(self, name, description=""):
        self.name = str(name)
        self.description = description
        self.last_value = None
        self.threshold = None

    def measure(self):  # pragma: no cover — abstract
        raise NotImplementedError

    def describe(self):
        return {"name": self.name, "description": self.description,
                "last_value": self.last_value,
                "threshold": self.threshold}


class LatencyObjective(Objective):
    """A histogram quantile must stay at or under `max_value` —
    e.g. per-token p99 <= 25 ms over `registry.GEN_PER_TOKEN_MS`."""

    def __init__(self, name, metric, max_value, quantile=0.99,
                 labels=None, description=""):
        super().__init__(name, description or
                         f"{metric} p{int(quantile * 100)} <= "
                         f"{max_value}")
        self.metric = metric
        self.labels = labels
        self.quantile = float(quantile)
        self.threshold = float(max_value)

    def measure(self, registry=None):
        reg = registry or _registry.get_registry()
        h = reg.get(self.metric, self.labels)
        if h is None or getattr(h, "count", 0) == 0:
            return None
        v = h.quantile(self.quantile)
        if v is None:
            return None
        self.last_value = float(v)
        return self.last_value > self.threshold


class ThroughputObjective(Objective):
    """Steps/s must stay within `max_drop` of a rolling baseline, from
    the flight recorder's wall-time percentiles (monitoring/steps.py).
    The baseline is an EMA over HEALTHY samples only — a sustained
    regression can't drag its own reference down and self-heal the
    alert; recovery updates the baseline again."""

    def __init__(self, name, max_drop=0.5, ema=0.2, description=""):
        super().__init__(name, description or
                         f"steps/s within {max_drop:.0%} of the "
                         f"rolling baseline")
        self.max_drop = float(max_drop)
        self.ema = float(ema)
        self.baseline = None
        self.threshold = self.max_drop

    def _rate(self):
        from deeplearning4j_tpu_torch.monitoring import steps as _steps
        s = _steps.recorder().summary()
        wall = s.get("wall_ms")
        if not wall or not wall.get("p50"):
            return None
        return 1000.0 / wall["p50"]

    def measure(self, registry=None):
        rate = self._rate()
        if rate is None:
            return None
        self.last_value = rate
        if self.baseline is None:
            self.baseline = rate
            return False
        bad = rate < self.baseline * (1.0 - self.max_drop)
        if not bad:
            self.baseline = (1 - self.ema) * self.baseline \
                + self.ema * rate
        return bad


class RatioObjective(Objective):
    """A windowed counter ratio must stay at or under `max_ratio` —
    e.g. crash-replays per admission <= 20%. Measured on counter
    DELTAS since the previous evaluation (the lifetime ratio would
    take forever to notice a regression — and forever to recover)."""

    def __init__(self, name, num, den, max_ratio, num_labels=None,
                 den_labels=None, description=""):
        super().__init__(name, description or
                         f"{num}/{den} <= {max_ratio}")
        self.num = num
        self.den = den
        self.num_labels = num_labels
        self.den_labels = den_labels
        self.threshold = float(max_ratio)
        self._last = None              # (num_value, den_value)

    def measure(self, registry=None):
        reg = registry or _registry.get_registry()
        n = reg.get(self.num, self.num_labels)
        d = reg.get(self.den, self.den_labels)
        nv = n.value if n is not None else 0
        dv = d.value if d is not None else 0
        if self._last is None:
            self._last = (nv, dv)
            return None
        dn, dd = nv - self._last[0], dv - self._last[1]
        self._last = (nv, dv)
        if dd <= 0:
            # no denominator activity this window: a numerator bump
            # with zero denominator is a violation by itself (replays
            # with no admissions), otherwise no evidence. Clear the
            # stale ratio so the breach never displays a previous
            # window's under-threshold value as its evidence.
            if dn > 0:
                self.last_value = None
                return True
            return None
        self.last_value = dn / dd
        return self.last_value > self.threshold


class StepTimeObjective(Objective):
    """A step wall-time quantile from the flight recorder
    (monitoring/steps.py) must stay at or under `max_ms` — the
    training-side twin of LatencyObjective, read from the ring's
    percentile roll-up instead of a histogram."""

    def __init__(self, name, max_ms, quantile=0.99, description=""):
        q = float(quantile)
        self._qkey = "p%d" % round(q * 100)
        super().__init__(name, description or
                         f"step wall {self._qkey} <= {max_ms} ms")
        self.quantile = q
        self.threshold = float(max_ms)

    def measure(self, registry=None):
        from deeplearning4j_tpu_torch.monitoring import steps as _steps
        wall = _steps.recorder().summary().get("wall_ms")
        if not wall or wall.get(self._qkey) is None:
            return None
        self.last_value = float(wall[self._qkey])
        return self.last_value > self.threshold


class StragglerObjective(Objective):
    """The max-host / median-host attributed step-time ratio (straggler
    plane, monitoring/stragglers.py) must stay at or under `max_ratio`.
    Breaching carries the CULPRIT — slowest host and phase — into
    `describe()`, so `GET /health` names who to replace or rebalance,
    not just that someone is slow. Inconclusive (None) below two
    reporting hosts or with no coordinator attached."""

    def __init__(self, name, max_ratio=2.0, coordinator=None,
                 description=""):
        super().__init__(name, description or
                         f"max-host/median-host step time <= "
                         f"{max_ratio}x")
        self.threshold = float(max_ratio)
        self._coordinator = coordinator
        self.culprit = None

    def _coord(self):
        if self._coordinator is not None:
            return self._coordinator
        # late lookup so the objective can be declared before the
        # coordinator exists (and survives coordinator replacement on
        # elastic restart); sys.modules, never a fresh import — an
        # objective must not trigger module init from a health poll
        import sys
        mod = sys.modules.get("deeplearning4j_tpu_torch.parallel.coordination")
        return getattr(mod, "ACTIVE", None) if mod else None

    def measure(self, registry=None):
        coord = self._coord()
        if coord is None:
            return None
        from deeplearning4j_tpu_torch.monitoring import stragglers as _sg
        att = _sg.attribution(coord)
        if att is None or att.get("ratio") is None:
            return None
        self.last_value = float(att["ratio"])
        self.culprit = att.get("slowest")
        return self.last_value > self.threshold

    def describe(self):
        d = super().describe()
        if self.culprit is not None:
            d["culprit"] = {"host": self.culprit.get("host"),
                            "phase": self.culprit.get("phase")}
        return d


def _exemplar_ids(obj, top=3):
    """Trace ids behind the tail of the objective's histogram (if it
    has one) — the breach event links straight to slow requests."""
    metric = getattr(obj, "metric", None)
    if not metric:
        return []
    try:
        hist = _registry.get_registry().histogram(
            metric, labels=getattr(obj, "labels", None))
        return [e["trace_id"] for e in hist.exemplars(top=top)
                if e.get("trace_id")]
    except Exception:  # noqa: BLE001 — breach reporting must not raise
        return []


class SloTracker:
    """Evaluates a set of objectives on the multi-window burn-rate rule
    and carries the breach state `GET /health` reports.

    `budget` is the error budget (tolerated bad fraction of samples,
    default 0.1); `short_window`/`long_window` are the two burn
    windows in seconds. `min_interval` rate-limits evaluation (the
    endpoints may poll every second; sampling faster than telemetry
    changes just burns CPU). `min_samples` is the evidence floor: an
    objective cannot breach until its long window holds at least that
    many samples — at cold start (or with a scrape cadence as long as
    the windows) both windows hold the same 1-2 samples and the
    multi-window rule would otherwise degenerate to paging on a single
    bad scrape."""

    def __init__(self, objectives=(), short_window=30.0,
                 long_window=120.0, budget=0.1, min_interval=1.0,
                 min_samples=4, clock=time.monotonic):
        self.objectives = list(objectives)
        self.short_window = float(short_window)
        self.long_window = float(long_window)
        self.budget = float(budget)
        self.min_interval = float(min_interval)
        self.min_samples = int(min_samples)
        self._clock = clock
        self._lock = threading.Lock()
        self._samples = {o.name: deque() for o in self.objectives}
        self._breached = {}            # name -> since (monotonic)
        self._burn = {}                # name -> (short, long)
        self._last_eval = None
        self._prev_active = None

    # -- install / clear (faults.py pattern) -----------------------------
    def install(self):
        global ACTIVE
        if ACTIVE is not self:
            self._prev_active = ACTIVE
            ACTIVE = self
        return self

    def uninstall(self):
        global ACTIVE
        if ACTIVE is self:
            ACTIVE = self._prev_active
            self._prev_active = None
        return self

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def add(self, objective):
        with self._lock:
            self.objectives.append(objective)
            self._samples[objective.name] = deque()
        return self

    # -- evaluation -------------------------------------------------------
    def _burn_rate(self, samples, window, now):
        inside = [bad for t, bad in samples if now - t <= window]
        if not inside:
            return 0.0
        return (sum(inside) / len(inside)) / self.budget

    def evaluate(self, force=False):
        """One evaluation pass (rate-limited unless `force`): sample
        every objective, fold the burn windows, flip/clear breaches,
        publish `dl4j.slo.*`. Returns the snapshot."""
        now = self._clock()
        with self._lock:
            if not force and self._last_eval is not None \
                    and now - self._last_eval < self.min_interval:
                return self._snapshot_locked(now)
            self._last_eval = now
            for obj in self.objectives:
                try:
                    bad = obj.measure()
                except Exception:  # noqa: BLE001 — one broken objective
                    continue       # must not take down health reporting
                samples = self._samples.setdefault(obj.name, deque())
                if bad is not None:
                    samples.append((now, bool(bad)))
                while samples and now - samples[0][0] > self.long_window:
                    samples.popleft()
                bs = self._burn_rate(samples, self.short_window, now)
                bl = self._burn_rate(samples, self.long_window, now)
                self._burn[obj.name] = (bs, bl)
                breached = bs >= 1.0 and bl >= 1.0 \
                    and len(samples) >= self.min_samples
                was = obj.name in self._breached
                if breached and not was:
                    self._breached[obj.name] = now
                    if STATE.enabled:
                        _registry.get_registry().counter(
                            _registry.SLO_BREACHES,
                            labels={"objective": obj.name},
                            help="SLO objective breach trips "
                                 "(multi-window burn rule)").inc()
                        _events.emit(
                            "monitoring", _events.SLO_BREACH,
                            attrs={"objective": obj.name,
                                   "burn_short": round(bs, 4),
                                   "burn_long": round(bl, 4),
                                   "exemplars": _exemplar_ids(obj)},
                            correlation_id="slo-%s" % obj.name)
                elif not breached and was:
                    self._breached.pop(obj.name, None)
                    if STATE.enabled:
                        _events.emit(
                            "monitoring", _events.SLO_RECOVER,
                            attrs={"objective": obj.name},
                            correlation_id="slo-%s" % obj.name)
                if STATE.enabled:
                    reg = _registry.get_registry()
                    for win, b in (("short", bs), ("long", bl)):
                        reg.gauge(
                            _registry.SLO_BURN_RATE,
                            labels={"objective": obj.name,
                                    "window": win},
                            help="error-budget burn rate per window "
                                 "(>=1 burns faster than budget)"
                        ).set(b)
                    reg.gauge(
                        _registry.SLO_BREACHED,
                        labels={"objective": obj.name},
                        help="1 while the objective is breached"
                    ).set(1.0 if breached else 0.0)
            return self._snapshot_locked(now)

    def breaches(self):
        """Names of currently breached objectives (oldest first)."""
        with self._lock:
            return [n for n, _ in sorted(self._breached.items(),
                                         key=lambda kv: kv[1])]

    def _snapshot_locked(self, now):
        objs = {}
        for obj in self.objectives:
            bs, bl = self._burn.get(obj.name, (0.0, 0.0))
            d = obj.describe()
            d.update(burn_short=round(bs, 4), burn_long=round(bl, 4),
                     breached=obj.name in self._breached)
            since = self._breached.get(obj.name)
            if since is not None:
                d["breached_for_s"] = round(now - since, 3)
            objs[obj.name] = d
        return {"objectives": objs,
                "violated": [n for n, _ in sorted(self._breached.items(),
                                                  key=lambda kv: kv[1])],
                "budget": self.budget,
                "windows_s": {"short": self.short_window,
                              "long": self.long_window}}

    def snapshot(self):
        """Evaluate (rate-limited) and return the `/slo` payload —
        what `resilience.health_snapshot()` embeds."""
        return self.evaluate()


def standard_objectives(per_token_p99_ms=None, steps_drop=None,
                        replay_ratio=None, step_p99_ms=None,
                        straggler_ratio=None, failover_ratio=None):
    """The standard objective set, with env-var thresholds:
    DL4J_SLO_PER_TOKEN_P99_MS, DL4J_SLO_STEPS_DROP,
    DL4J_SLO_REPLAY_RATIO, DL4J_SLO_STEP_P99_MS,
    DL4J_SLO_STRAGGLER_RATIO, DL4J_SLO_FAILOVER_RATIO (an unset/None
    knob omits the objective)."""
    import os

    def knob(arg, env):
        if arg is not None:
            return float(arg)
        v = os.environ.get(env)
        try:
            return float(v) if v else None
        except ValueError:
            return None

    out = []
    v = knob(per_token_p99_ms, "DL4J_SLO_PER_TOKEN_P99_MS")
    if v is not None:
        out.append(LatencyObjective("per_token_p99",
                                    metric=_registry.GEN_PER_TOKEN_MS,
                                    quantile=0.99, max_value=v))
    v = knob(steps_drop, "DL4J_SLO_STEPS_DROP")
    if v is not None:
        out.append(ThroughputObjective("steps_rate", max_drop=v))
    v = knob(replay_ratio, "DL4J_SLO_REPLAY_RATIO")
    if v is not None:
        out.append(RatioObjective("replay_rate",
                                  num=_registry.GEN_REPLAYS,
                                  den=_registry.GEN_ADMISSIONS,
                                  max_ratio=v))
    v = knob(step_p99_ms, "DL4J_SLO_STEP_P99_MS")
    if v is not None:
        out.append(StepTimeObjective("step_p99", max_ms=v))
    v = knob(straggler_ratio, "DL4J_SLO_STRAGGLER_RATIO")
    if v is not None:
        out.append(StragglerObjective("straggler_ratio", max_ratio=v))
    v = knob(failover_ratio, "DL4J_SLO_FAILOVER_RATIO")
    if v is not None:
        # fleet health: mid-stream failovers per routed admission — a
        # fleet that re-routes most of its traffic is burning replicas
        # even while every individual stream still completes
        out.append(RatioObjective("failover_ratio",
                                  num=_registry.FLEET_FAILOVERS,
                                  den=_registry.FLEET_ROUTED,
                                  max_ratio=v))
    return out


def clear_tracker():
    """Force-reset the global switch — test teardown only."""
    global ACTIVE
    ACTIVE = None

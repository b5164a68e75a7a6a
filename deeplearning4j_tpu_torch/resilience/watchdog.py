"""Stall watchdog: detect a wedged training step and dump a crash
report while the evidence is still alive. A copy of
`deeplearning4j_tpu/resilience/watchdog.py` re-pointed at the port.

A hung collective, a dead-locked host callback, or a loader stuck on a
dead filesystem all present the same way: the step simply never ends,
no exception, no log line — the most expensive failure mode there is,
because nothing pages anyone. The watchdog is a monitor THREAD with two
inputs:

- a **per-trainer heartbeat**: every trainer step calls
  `ACTIVE.beat("multilayer@<id>")` — keyed per INSTANCE, so two
  concurrent fits of the same class can't mask each other's stall or
  retire each other's beats (one dict store behind the usual
  `if _watchdog.ACTIVE is not None:` pointer compare — zero cost
  disarmed);
- the **flight recorder** (`monitoring/steps.py`) for the step-time
  history that goes into the report.

When the OLDEST live trainer's heartbeat is older than `stall_timeout`
(env `DL4J_STALL_TIMEOUT`, default 300 s) while the watchdog is ARMED
(between `arm()` / `disarm()` — an idle process after fit() returns is
not a stall), it:

1. writes `dl4j-stall-report-<ts>-<pid>.txt`: per-trainer heartbeat
   ages, every Python thread's stack (`sys._current_frames` — this is
   how you see the wedged collective), the open monitoring spans of
   every thread, the flight-recorder tail, and the last device-memory
   reading;
2. bumps `dl4j.watchdog.stalls` / `dl4j.watchdog.dumps` and keeps
   `dl4j.watchdog.beat_age_seconds` fresh;
3. optionally aborts: `abort=True` interrupts the main thread
   (KeyboardInterrupt — lets `finally:` blocks flush checkpoints),
   `abort=<callable>` runs yours (e.g. `lambda: os._exit(134)` for a
   supervisor-managed restart). CAVEAT: interrupt_main only fires when
   the main thread next runs Python bytecode — if the MAIN thread is
   the one wedged inside a native call (the hung collective itself),
   abort=True cannot reach it; the report still gets written, but only
   `abort=<callable>` with `os._exit` actually ends the process then.

The trip LATCHES until the next heartbeat, so one stall produces one
report, and a recovered step re-arms detection automatically.

Oldest-live, not newest: with two concurrent trainers beating one
watchdog, a live trainer's fresh beats must not mask a wedged one's
silence. A fit that ENDS retires its name (`retire()`, wired into the
model/wrapper fit epilogues) so a finished trainer cannot age into a
false trip; functional step loops (`ShardedTrainer.fit_batch` driven
directly) have no fit scope — disarm the watchdog when such a loop
finishes inside an armed window.

    wd = StallWatchdog(stall_timeout=120).start()
    wd.arm()
    try:
        net.fit(iterator, epochs=10)
    finally:
        wd.disarm(); wd.stop()

`FaultTolerantTrainer(..., watchdog=wd)` does the arm/disarm around its
own fit. State surfaces at `GET /health`.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.monitoring import events as _events

__all__ = ["ACTIVE", "StallWatchdog", "clear_watchdog", "default_timeout",
           "write_debug_report"]

#: THE switch the trainer heartbeat hooks check (faults.py pattern).
ACTIVE = None


def default_timeout():
    try:
        return float(os.environ.get("DL4J_STALL_TIMEOUT", "300"))
    except ValueError:
        return 300.0


def _peer_table_lines():
    """Peer-table section for crash/stall reports: the multi-host
    coordinator's view of every process (step, heartbeat age, preempt
    flag). Lazy + best-effort — single-process runs (no coordinator
    installed) get one explanatory line, and a broken coordination
    service must never stop a report from being written."""
    lines = ["Peer table (multi-host):"]
    try:
        # read through sys.modules, never import: if coordination was
        # never loaded, no coordinator can be installed — and a stall
        # report must not pay (or deadlock on) a whole-package import
        # inside a process that is by definition wedged
        mod = sys.modules.get(
            "deeplearning4j_tpu_torch.parallel.coordination")
        coord = getattr(mod, "ACTIVE", None) if mod is not None else None
    except Exception:  # noqa: BLE001 — report must always be writable
        coord = None
    if coord is None:
        lines.append("  (single process — no coordinator installed)")
        return lines
    try:
        table = coord.peer_table()
    except Exception as e:  # noqa: BLE001
        lines.append(f"  (peer table unavailable: {e})")
        return lines
    if not table:
        lines.append("  (no peer heartbeats observed yet)")
    for pid, info in sorted(table.items()):
        lines.append(f"  process {pid}: {info}")
    return lines


def write_debug_report(headline, dump_dir=None, prefix="dl4j-stall-report",
                       extra_sections=None, count_dump=True):
    """Write the full forensics report both the stall watchdog and the
    multi-host peer monitor use: the headline, any caller sections
    (heartbeat tables, peer autopsies), open monitoring spans, every
    Python thread's stack, the flight-recorder tail, the last device
    memory reading, and the multi-host peer table. Returns the report
    path. `extra_sections` is a list of line-lists inserted after the
    headline. Every caller (stall watchdog, peer monitor, crash dumps
    via util/crash_reporting) shares the journal-tail section below,
    and a machine-readable post-mortem bundle rides alongside the text
    report when monitoring is enabled."""
    ts = time.strftime("%Y%m%d-%H%M%S")
    directory = dump_dir or os.getcwd()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}-{ts}-{os.getpid()}.txt")
    lines = [f"deeplearning4j_tpu_torch {prefix} ({ts})", "=" * 60, ""]
    if isinstance(headline, str):
        lines.append(headline)
    else:
        lines.extend(headline)
    lines.append("")
    for section in (extra_sections or ()):
        lines.extend(section)
        lines.append("")
    lines.extend(_events.event_tail_lines())
    lines.append("")
    lines.extend(_peer_table_lines())
    lines.append("")
    lines.append("Open monitoring spans by thread:")
    spans = _mon.get_tracer().open_spans()
    if spans:
        for tid, stack in sorted(spans.items()):
            lines.append(f"  thread {tid}: {' > '.join(stack)}")
    else:
        lines.append("  (none recorded — monitoring disabled or "
                     "between spans)")
    lines.append("")
    lines.append("Python thread stacks:")
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        if tid == threading.get_ident():
            continue               # the reporting thread is not evidence
        lines.append(f"  -- thread {tid} ({names.get(tid, '?')}) --")
        for ln in traceback.format_stack(frame):
            lines.extend("  " + s for s in ln.rstrip().splitlines())
    lines.append("")
    lines.append("Step-time flight recorder:")
    lines.extend(_mon.step_recorder().crash_lines())
    lines.append("")
    mem = _mon.memory.last_sample()
    lines.append("Last device memory reading:")
    if mem:
        for k, v in sorted(mem.items()):
            lines.append(f"  {k}: {v}")
    else:
        lines.append("  (none — memory telemetry not sampling)")
    if _mon.enabled():
        bundle_path = _events.write_bundle(
            dump_dir=directory, headline=f"{prefix}: see {path}")
        lines.append("")
        lines.append(f"Post-mortem bundle: {bundle_path or '(failed)'}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if count_dump and _mon.enabled():
        _mon.get_registry().counter(
            _mon.WATCHDOG_DUMPS,
            help="stall crash-report files written").inc()
    return path


class StallWatchdog:
    def __init__(self, stall_timeout=None, poll_interval=None, abort=False,
                 on_stall=None, dump_dir=None, clock=time.monotonic):
        self.stall_timeout = (default_timeout() if stall_timeout is None
                              else float(stall_timeout))
        if self.stall_timeout <= 0:
            raise ValueError("stall_timeout must be > 0")
        self.poll_interval = (min(1.0, self.stall_timeout / 4.0)
                              if poll_interval is None
                              else float(poll_interval))
        self.abort = abort
        self.on_stall = on_stall
        self.dump_dir = dump_dir
        self._clock = clock
        self._beats = {}           # trainer name -> monotonic timestamp
        self._retired = {}         # name -> retire timestamp (fit ended)
        self._prev_active = None   # watchdog shadowed by install()
        self._armed = 0            # arm() nesting depth (see arm())
        self._armed_at = None
        self.stalled = False       # latched until the next beat
        self.stall_count = 0
        self.last_report_path = None
        self._thread = None
        self._stop = threading.Event()

    # -- the hot hook ----------------------------------------------------
    def beat(self, name="trainer"):
        """One step heartbeat: a dict store (atomic under the GIL — no
        lock on the hot path). A latched stall clears once no live
        trainer is stale anymore — the step that finally completed IS
        the recovery signal, but another trainer's beats must not
        unlatch a stall it didn't cause (that would re-trip a report
        every poll while the wedged one stays silent)."""
        # beat BEFORE un-retiring: the reverse order opens a window in
        # which the monitor sees neither entry and anchors a fresh fit's
        # first step on the stale armed_at — a false trip
        self._beats[name] = self._clock()
        self._retired.pop(name, None)
        if self.stalled:
            age = self.beat_age()
            if age is None or age <= self.stall_timeout:
                self.stalled = False
                if _mon.enabled():
                    _events.emit(
                        "resilience", _events.WATCHDOG_RECOVERED,
                        attrs={"trainer": name},
                        correlation_id="watchdog-%x" % id(self))

    def retire(self, name="trainer"):
        """A trainer's fit completed: its heartbeat stops being stall
        evidence (detection watches the OLDEST live trainer, so a name
        that legitimately finished must not age into a false trip).
        Reaching fit's end is itself proof of liveness — the retire
        timestamp anchors detection while no trainer is live."""
        self._beats.pop(name, None)
        self._retired[name] = self._clock()

    # -- lifecycle -------------------------------------------------------
    def install(self):
        """Install as ACTIVE, remembering the watchdog this one shadows
        so stop()/uninstall() restores it — a second watchdog (e.g. a
        serving MemoryMonitor-style scope inside a training run's) must
        not strip the outer one from the beats that follow, leaving an
        armed watchdog starved of heartbeats until it false-trips."""
        global ACTIVE
        if ACTIVE is not self:
            self._prev_active = ACTIVE
            ACTIVE = self
        return self

    def uninstall(self):
        """Undo this watchdog's install(): restore the watchdog it
        shadowed (None when there was none). A no-op unless this one is
        currently ACTIVE."""
        global ACTIVE
        if ACTIVE is self:
            ACTIVE = self._prev_active
            self._prev_active = None
        return self

    def start(self):
        """Install as the ACTIVE heartbeat sink and spawn the monitor
        thread. Idempotent."""
        self.install()
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dl4j-stall-watchdog")
            self._thread.start()
        return self

    def stop(self):
        self.uninstall()
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def arm(self):
        """Begin watching: arming counts as an implicit heartbeat, so a
        run that wedges before its FIRST step still trips. arm/disarm
        NEST (a count, not a flag): two overlapping FaultTolerantTrainer
        fits sharing one watchdog each arm around their own scope, and
        the first to finish must not switch detection off under the
        second — only the outermost arm opens a fresh window (clearing
        heartbeats from before it: stale names from an earlier run must
        not read as wedged trainers in this one), and only the last
        disarm ends it."""
        if self._armed == 0:
            self._beats.clear()
            self._retired.clear()
            self._armed_at = self._clock()
            self.stalled = False
        self._armed += 1
        return self

    def disarm(self):
        self._armed = max(0, self._armed - 1)
        return self

    @property
    def armed(self):
        return self._armed > 0

    # -- detection -------------------------------------------------------
    def beat_age(self):
        """Seconds since the OLDEST live trainer's last heartbeat; None
        when disarmed. Oldest, not newest: with two concurrent trainers
        beating one watchdog, the live one's fresh beats must not mask
        the wedged one's silence — a finished fit retires its name so it
        cannot age into a false trip. With no live trainer, the anchor
        is the latest sign of life (arm() or the newest retirement —
        between a driver's per-batch fits the dict is briefly empty)."""
        if not self._armed:
            return None
        # list() first: trainer threads insert new keys concurrently and
        # a bare .values() iteration would raise "dictionary changed
        # size" mid-scan
        oldest = min(list(self._beats.values()), default=None)
        if oldest is None:
            anchor = max([self._armed_at]
                         + list(self._retired.values()))
        else:
            anchor = oldest
        return self._clock() - anchor

    def check_now(self):
        """One synchronous detection pass (what the monitor thread runs
        per poll; exposed so tests drive it without real sleeps).
        Returns True when this call TRIPPED a new stall."""
        age = self.beat_age()
        if _mon.enabled() and age is not None:
            _mon.get_registry().gauge(
                _mon.WATCHDOG_BEAT_AGE_SECONDS,
                help="seconds since the oldest live trainer's "
                     "heartbeat") \
                .set(age)
        if age is None or age <= self.stall_timeout or self.stalled:
            return False
        self.stalled = True        # latched until the next beat
        self.stall_count += 1
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.WATCHDOG_STALLS,
                help="training steps that exceeded the stall "
                     "timeout").inc()
            _events.emit(
                "resilience", _events.WATCHDOG_STALL,
                attrs={"beat_age_s": round(age, 3),
                       "timeout_s": self.stall_timeout},
                correlation_id="watchdog-%x" % id(self))
        try:
            self.last_report_path = self._write_report(age)
        except Exception:  # noqa: BLE001 — the report must never kill us
            self.last_report_path = None
        if self.on_stall is not None:
            try:
                self.on_stall(self)
            except Exception:  # noqa: BLE001
                pass
        if self.abort:
            if callable(self.abort):
                self.abort()
            else:
                import _thread
                _thread.interrupt_main()
        return True

    def _run(self):
        while not self._stop.wait(self.poll_interval):
            try:
                self.check_now()
            except Exception:  # noqa: BLE001 — monitor must stay alive
                pass

    # -- the report ------------------------------------------------------
    def _write_report(self, age):
        now = self._clock()
        beats = ["Heartbeats:"]
        if self._beats:
            for name, t in sorted(list(self._beats.items())):
                beats.append(f"  {name}: {now - t:.1f} s ago")
        else:
            beats.append("  (no step ever completed since arm())")
        return write_debug_report(
            f"stall: no trainer heartbeat for {age:.1f} s "
            f"(timeout {self.stall_timeout:.1f} s)",
            dump_dir=self.dump_dir, extra_sections=[beats])

    # -- introspection (GET /health) -------------------------------------
    def snapshot(self):
        age = self.beat_age()
        return {
            "status": "stalled" if self.stalled else (
                "watching" if self._armed else "disarmed"),
            "armed": self.armed,
            "stalled": self.stalled,
            "stall_count": self.stall_count,
            "stall_timeout_s": self.stall_timeout,
            "beat_age_s": age,
            # live AND retired: a trainer whose fit just finished is
            # still part of the window's story (retired ones are not
            # stall evidence, but /health readers want to see them)
            "heartbeats": {k: round(self._clock() - v, 3)
                           for k, v in (list(self._retired.items())
                                        + list(self._beats.items()))},
            "live": sorted(self._beats),
            "last_report": self.last_report_path,
        }


def clear_watchdog():
    """Force-reset the global switch, ignoring any shadow chain — test
    teardown and emergency use only; running code pairs install() with
    uninstall()/stop()."""
    global ACTIVE
    ACTIVE = None

"""Training listeners: the port of `deeplearning4j_tpu/optimize/listeners.py`
(≡ deeplearning4j-nn :: optimize.listeners.*: ScoreIterationListener,
PerformanceListener, TimeIterationListener, EvaluativeListener,
CheckpointListener, and the BaseTrainingListener protocol).

The networks call `iterationDone` after each training step and
`onEpochEnd` at each epoch's end. `CheckpointListener` writes through the
port's `ModelSerializer` (archives the JAX package reads too),
`EvaluativeListener` evaluates through the port's `eval/`, and
`MetricsListener` reports through the port's `monitoring/`, and
`ProfilerListener` captures a window of iterations through the
profiler's `ProfileSession` (torch.profiler, decoded per op).

Observability cross-links (three complementary layers):
- `MetricsListener` (here) — HOST-side operational metrics + span traces
  via `deeplearning4j_tpu_torch.monitoring` (Prometheus `/metrics` on the
  UI server, Chrome-trace JSON for Perfetto);
- `ProfilerListener` (here) — the device-side per-op trace;
- `ui.stats.StatsListener` — LEARNING diagnostics (score, update
  ratios, activation histograms) for the training dashboard.
"""
from __future__ import annotations

import os
import time

from deeplearning4j_tpu_torch import monitoring as _mon


class TrainingListener:
    """Protocol: networks call iterationDone each step, onEpochEnd at epoch
    boundaries (≡ BaseTrainingListener)."""

    def iterationDone(self, model, iteration, epoch):
        pass

    def onEpochEnd(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    def __init__(self, printIterations=10, log_fn=print):
        self.every = int(printIterations)
        self.log = log_fn

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.every == 0:
            self.log(f"Score at iteration {iteration} is {model.score()}")


class PerformanceListener(TrainingListener):
    """Reports examples/sec and iterations/sec (≡ PerformanceListener)."""

    def __init__(self, frequency=10, reportBatch=True, log_fn=print):
        self.every = int(frequency)
        self.reportBatch = reportBatch
        self.log = log_fn
        self._last_time = None
        self._last_iter = 0
        self.last_throughput = None

    def iterationDone(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            return
        if iteration - self._last_iter >= self.every:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            its_per_sec = iters / dt
            self.last_throughput = its_per_sec
            self.log(f"iteration {iteration}: {its_per_sec:.2f} iters/sec "
                     f"(epoch {epoch})")
            self._last_time, self._last_iter = now, iteration


class TimeIterationListener(TrainingListener):
    """ETA logging over a planned iteration count."""

    def __init__(self, total_iterations, frequency=50, log_fn=print):
        self.total = int(total_iterations)
        self.every = int(frequency)
        self.log = log_fn
        self._start = None

    def iterationDone(self, model, iteration, epoch):
        if self._start is None:
            self._start = time.perf_counter()
            return
        if iteration % self.every == 0:
            elapsed = time.perf_counter() - self._start
            rate = elapsed / max(1, iteration)
            remaining = rate * max(0, self.total - iteration)
            self.log(f"iteration {iteration}/{self.total}, "
                     f"ETA {remaining:.1f}s")


class EvaluativeListener(TrainingListener):
    """Periodically evaluate on a held-out iterator (≡ EvaluativeListener)."""

    def __init__(self, iterator, frequency, evaluation=None, log_fn=print):
        self.iterator = iterator
        self.every = int(frequency)
        self.evaluation_factory = evaluation
        self.log = log_fn
        self.last_evaluation = None

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.every != 0:
            return
        with _mon.span("listener.evaluate"):
            e = model.evaluate(self.iterator)
        self.last_evaluation = e
        self.log(f"Evaluation at iteration {iteration}: "
                 f"accuracy={e.accuracy():.4f} f1={e.f1():.4f}")


class CheckpointListener(TrainingListener):
    """≡ CheckpointListener.Builder: save every N iterations/epochs, keep
    last K checkpoints."""

    def __init__(self, directory, saveEveryNIterations=None,
                 saveEveryNEpochs=None, keepLast=3, saveUpdater=True):
        self.dir = directory
        self.every_iter = saveEveryNIterations
        self.every_epoch = saveEveryNEpochs
        self.keep = int(keepLast)
        self.saveUpdater = saveUpdater
        self._saved = []
        os.makedirs(directory, exist_ok=True)

    def _save(self, model, tag):
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer
        path = os.path.join(self.dir, f"checkpoint_{tag}.zip")
        with _mon.span("listener.checkpoint"):
            ModelSerializer.writeModel(model, path, self.saveUpdater)
        self._saved.append(path)
        while len(self._saved) > self.keep:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def iterationDone(self, model, iteration, epoch):
        if self.every_iter and iteration % self.every_iter == 0:
            self._save(model, f"iter_{iteration}")

    def onEpochEnd(self, model):
        if self.every_epoch and model.getEpochCount() % self.every_epoch == 0:
            self._save(model, f"epoch_{model.getEpochCount()}")

    def lastCheckpoint(self):
        return self._saved[-1] if self._saved else None


class CollectScoresListener(TrainingListener):
    def __init__(self, frequency=1):
        self.every = int(frequency)
        self.scores = []

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.every == 0:
            self.scores.append((iteration, model.score()))


class ProfilerListener(TrainingListener):
    """≡ the JAX package's ProfilerListener: per-iteration step timings
    and a device trace of a window of iterations, decoded per op.

    The trace window is a `monitoring.profiler.ProfileSession` that this
    listener drives in manual begin/end mode, so the capture also yields
    the decoded per-op report — `self.report` after the window closes,
    the same shape as `monitoring.last_report()`. Prefer
    `monitoring.profile_next_steps(k)` / `POST /profile?steps=k` in new
    code; this listener is the iterationDone-cadence surface.

    Two outputs per training run:
    - per-iteration step timings recorded into the OpExecutioner profiler
      (≡ OpProfiler: `OpExecutioner.getInstance().getProfilingStats()`),
      under the op name "train_step";
    - a torch.profiler trace (Kineto's Chrome JSON, `*.pt.trace.json`
      under `trace_dir`, viewable in Perfetto) covering iterations
      [start_iter, start_iter + trace_iters), plus the decoded
      `self.report` per-op table.

    Usage: net.setListeners(ProfilerListener(trace_dir="/tmp/trace")).
    """

    def __init__(self, trace_dir=None, start_iter=1, trace_iters=3):
        self.trace_dir = None if trace_dir is None else str(trace_dir)
        self.start_iter = int(start_iter)
        self.trace_iters = int(trace_iters)
        self.report = None
        self._session = None
        self._last_time = None
        from deeplearning4j_tpu_torch.runtime.executioner import \
            OpExecutioner
        self._ex = OpExecutioner.getInstance()
        self._ex.setProfilingMode(True)

    @property
    def _tracing(self):
        return self._session is not None \
            and self._session.state == "tracing"

    def _close_window(self):
        s = self._session
        if s is not None and s.state == "tracing":
            s.end()
            self.report = s.report
        self.trace_dir = None  # one trace per listener

    def iterationDone(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._last_time is not None:
            # the whole iteration is the train step's (one dispatch, or
            # one graph replay on the card)
            self._ex.op_counts["train_step"] += 1
            self._ex.op_times["train_step"] += now - self._last_time
        self._last_time = now
        if self.trace_dir is None:
            return
        if not self._tracing and iteration >= self.start_iter:
            from deeplearning4j_tpu_torch.monitoring.profiler import \
                ProfileSession
            self._session = ProfileSession(
                steps=self.trace_iters, trace_dir=self.trace_dir,
                keep_trace=True, device=getattr(model, "_device", None))
            self._session.begin()
            if self._session.state == "failed":
                # the window was refused (another torch.profiler is
                # running, e.g. an armed global session's) — give up
                # instead of retrying on every remaining iteration
                self._session = None
                self.trace_dir = None
        elif self._tracing:
            # listener-driven sessions are never the global ACTIVE one,
            # so the trainers' step hooks skip them — count the captured
            # step here; the k-th step_end closes the window and builds
            # the report
            self._session.step_end()
            if not self._tracing:
                self.report = self._session.report
                self.trace_dir = None  # one trace per listener

    def onEpochEnd(self, model):
        # re-arm the timer: inter-epoch work (eval, checkpointing) must not
        # be attributed to the next epoch's first train_step
        self._last_time = None
        if self._tracing:
            self._close_window()


class MetricsListener(TrainingListener):
    """One-line opt-in to the HOST-side monitoring subsystem:

        net.setListeners(MetricsListener())

    Constructing it calls `monitoring.enable()` (that IS the opt-in: every
    instrumented span/metric point in the trainers, parallel stack, and
    executioner goes live), bootstraps the core metric families (jit
    compile histogram, transfer counter, device memory gauges), and then
    per iteration records:

    - `dl4j.train.iterations` (counter), `dl4j.train.score` (gauge),
    - `dl4j.train.iteration_seconds` (histogram → p50/p95/p99),
    - device memory gauges every `deviceMemoryFrequency` iterations
      (`device.memory_stats()` where the backend has it).

    `tracePath` (optional) exports the accumulated span trace as
    Chrome trace-event JSON at every epoch end — load it in Perfetto /
    chrome://tracing to see nested data-iter / dispatch / listener /
    eval / checkpoint phases.

    Scrape surface: `UIServer.getInstance().start()` then
    `GET /metrics` (Prometheus text format).

    Complements (does not replace) `ProfilerListener` (the DEVICE-side
    trace, ROADMAP A16) and `ui.stats.StatsListener` (learning
    diagnostics for the dashboard).
    """

    def __init__(self, registry=None, deviceMemoryFrequency=50,
                 tracePath=None, scoreFrequency=1):
        _mon.enable()
        self.registry = registry if registry is not None \
            else _mon.get_registry()
        _mon.bootstrap_core_metrics(self.registry)
        self.deviceMemoryFrequency = max(1, int(deviceMemoryFrequency))
        #: reading score() materializes the device loss — a host-blocking
        #: sync (counted on dl4j.pipeline.syncs). scoreFrequency=N reads
        #: it every N iterations so metrics collection doesn't serialize
        #: the async pipeline it is observing (≡ ScoreIterationListener's
        #: printIterations cadence)
        self.scoreFrequency = max(1, int(scoreFrequency))
        self.trace_path = None if tracePath is None else str(tracePath)
        self._last_time = None
        self._params_version_seen = None

    def iterationDone(self, model, iteration, epoch):
        reg = self.registry
        now = time.perf_counter()
        reg.counter("dl4j.train.iterations",
                    help="training iterations observed").inc()
        if iteration % self.scoreFrequency == 0:
            score = model.score()
            if score is not None:
                reg.gauge("dl4j.train.score",
                          help="most recent training loss") \
                   .set(float(score))
        # a model that fires k iterationDone calls after ONE update (the
        # JAX package's scanned fit) marks its real updates with
        # _params_version (same dedup contract as StatsListener); the
        # port's networks update once per call and carry no version
        version = getattr(model, "_params_version", None)
        params_fresh = version is None \
            or version != self._params_version_seen
        self._params_version_seen = version
        if params_fresh:
            if self._last_time is not None:
                reg.histogram("dl4j.train.iteration_seconds",
                              help="host wall time between real param "
                                   "updates").observe(now - self._last_time)
            self._last_time = now
        if iteration % self.deviceMemoryFrequency == 0:
            # memory.sample (not bare collect_device_memory): also sets
            # the dl4j.model.*_bytes footprint gauges from the live trees
            # and retains the reading for OOM forensics
            # (util/crash_reporting.py embeds the last sample)
            _mon.memory.sample(reg, model)

    def stepRecords(self, last=None):
        """Step-time attribution records from the flight recorder
        (monitoring/steps.py) — the programmatic face of GET /steps."""
        return _mon.step_recorder().records(last=last)

    def stepSummary(self):
        """Percentile roll-up of per-step phase attribution."""
        return _mon.step_recorder().summary()

    def onEpochEnd(self, model):
        # inter-epoch work (eval/checkpoint listeners) must not count as
        # an iteration interval
        self._last_time = None
        _mon.memory.sample(self.registry, model)
        if self.trace_path:
            tracer = _mon.get_tracer()
            tracer.export(self.trace_path)
            # near the event cap, start a fresh window rather than let
            # every later span drop silently: the file just written
            # preserves the old window; subsequent epoch exports rewrite
            # the path with the newer one (late-training spans matter
            # more than re-exporting early ones)
            if len(tracer.events()) >= 0.8 * tracer.max_events:
                tracer.clear()

"""Training guardian: device-side divergence detection with an
escalating recovery ladder. The port of
`deeplearning4j_tpu/resilience/guardian.py`: the host-side ladder is a
copy; `guarded_apply` is the port's (below).

The retry and checkpoint layer survives *infrastructure* failure; nothing
guarded *model-state* failure: one overflowing step writes NaN into the
params, and the run is silently dead long before anyone reads the loss
curve. The guardian closes that hole in three pieces:

1. **Device-side health, zero host syncs.** When a guardian is
   installed, the network classes switch to a GUARDED train step (its
   own key in the fit store, `nn/_network.py`) that also computes the
   global grad norm and a health verdict

       ok = isfinite(loss) & isfinite(gnorm) & (gnorm <= max_gnorm)

   and writes the parameter/optimizer/state update ONLY where `ok`
   (`torch.where` per leaf inside the step's CUDA graph, so a NaN
   gradient can never reach the live params). The verdict and the grad
   norm stay ON DEVICE; `on_step` keeps a device copy of them.

2. **Amortized checks.** Every `check_every` steps the pending scalars
   materialize in ONE stacked host read (counted on
   `dl4j.pipeline.syncs{site="guardian"}` — the tests prove the
   cadence: syncs == steps/check_every, never per-step). The
   flush maintains a host-side EMA of the grad norm; `spike_factor *
   ema` feeds back as the `max_gnorm` threshold the NEXT steps enforce
   on device, so finite-but-exploding steps are skipped too.

3. **The escalation ladder.** Consecutive unhealthy steps climb:
   skip-and-count (implicit — the device already skipped the update) →
   reduce LR and retry the batch (`lr_scale *= lr_backoff`; the guarded
   step multiplies updates by `lr_scale`, and FaultTolerantTrainer
   re-runs the offending batch) → roll back to the last *verified*
   checkpoint (FaultTolerantTrainer restores via the integrity-checked
   path) → raise `DivergenceError`. A clean stretch of
   `recovery_checks` healthy flushes walks the LR back to 1.0.

Install mirrors `resilience/faults.py`: a module-global `ACTIVE`
consulted by the trainers as `if _guardian.ACTIVE is not None:` — one
pointer compare, nothing else, on the disabled (production) path.

    with TrainingGuardian(spike_factor=8.0):
        net.fit(iterator, epochs=3)          # bare fit: skip + LR ladder

    g = TrainingGuardian()
    FaultTolerantTrainer(net, dir, guardian=g).fit(iterator)  # + rollback

State surfaces at `GET /health` on the UI server and as
`dl4j.guardian.*` metrics.
"""
from __future__ import annotations

import time

import torch

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.monitoring import events as _events
from deeplearning4j_tpu_torch.nn.updaters import apply_updates
from deeplearning4j_tpu_torch.resilience.errors import DivergenceError
from deeplearning4j_tpu_torch.runtime.executables import tensor_leaves

__all__ = ["ACTIVE", "RETRY", "ROLLBACK", "TrainingGuardian",
           "clear_guardian", "global_norm", "guarded_apply"]

#: THE switch the trainer hooks check. None → guardian off (the
#: permanent state unless a TrainingGuardian is installed).
ACTIVE = None

#: escalation actions a driving trainer consumes via `take_action()`
RETRY = "retry_reduced_lr"
ROLLBACK = "rollback"


def global_norm(grads):
    """≡ optax.global_norm: sqrt(Σ over every leaf of Σ g²), in f32."""
    leaves = tensor_leaves(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([g.float() for g in leaves])
    return torch.linalg.vector_norm(torch.stack(norms))


def guarded_apply(tx, grads, loss, params, opt_state, lr_scale, max_gnorm,
                  constraints=None, extra=()):
    """The core every guarded train step shares (single, accumulation and
    TBPTT segment steps of both network classes): the health verdict

        ok = isfinite(loss) & isfinite(gnorm) & (gnorm <= max_gnorm)

    the optimizer's updates scaled by `lr_scale` (the reduce-LR rung),
    and every leaf of the parameters, the optimizer state (its counts
    included) and each (new, old) pair of `extra` (BN state, recurrent
    carries) written in place as `torch.where(ok, new, old)`, so an
    unhealthy gradient never reaches the live tensors. `lr_scale` and
    `max_gnorm` are 0-d device tensors the host writes between steps, so
    a CUDA graph of the step reads the current values and a change never
    recaptures. Everything stays on the device: no host read. Returns
    (gnorm, ok) as 0-d tensors."""
    gnorm = global_norm(grads)
    ok = healthy(loss, gnorm, max_gnorm)
    updates, new_opt = tx.update(grads, opt_state, params)
    up = tensor_leaves(updates)
    if up:
        torch._foreach_mul_(up, lr_scale)
    new_params = apply_updates(params, updates)
    if constraints is not None:
        new_params = constraints(new_params)
    write_where(ok, [(new_params, params), (new_opt, opt_state)]
                + list(extra))
    return gnorm, ok


def healthy(loss, gnorm, max_gnorm):
    """A guarded step's verdict, a 0-d device bool: finite loss, finite
    gradient norm within `max_gnorm`."""
    return torch.isfinite(loss) & torch.isfinite(gnorm) & (gnorm <= max_gnorm)


def write_where(ok, pairs):
    """Each (new, old) pair of trees written into old's tensors in place,
    `torch.where(ok, new, old)` leaf by leaf, or copied whole where `ok` is
    None."""
    with torch.no_grad():
        for new, old in pairs:
            dst, src = tensor_leaves(old), tensor_leaves(new)
            if len(dst) != len(src):
                raise ValueError(f"trees differ: {len(dst)} vs {len(src)} "
                                 "tensors")
            if ok is None:
                if dst:
                    torch._foreach_copy_(dst, src)
                continue
            for d, s in zip(dst, src):
                torch.where(ok, s, d, out=d)


class TrainingGuardian:
    """Divergence detector + recovery policy over guarded train steps.

    Parameters
    ----------
    check_every: materialize the pending device verdicts every N steps
        (one stacked host read per check — the only sync this class
        ever performs). The default 10 amortizes the read so a guarded
        fit keeps the host running ahead of the device; check_every=1 gives
        step-exact escalation at the cost of one host-blocking sync per
        step — the per-step sync the async pipeline exists to avoid.
        Either way NaN can never reach the params: the device-side
        torch.where gate refuses unhealthy updates regardless of how
        often the host looks.
    ema_decay / spike_factor / warmup_steps: a step whose grad norm
        exceeds ``spike_factor * EMA(grad_norm)`` is unhealthy; the EMA
        needs ``warmup_steps`` healthy samples before spike detection
        (and the device-side ``max_gnorm`` threshold) arms.
    max_skips: consecutive unhealthy steps tolerated (updates already
        skipped on device) before escalating.
    lr_backoff / max_lr_retries: each LR rung multiplies ``lr_scale``
        by ``lr_backoff`` and requests a batch retry.
    max_rollbacks: checkpoint rollbacks granted before the ladder ends
        in `DivergenceError`.
    recovery_checks: fully-healthy flushes required to restore
        ``lr_scale`` to 1.0 and re-arm the lower rungs.
    raise_on_divergence: False returns the model to the caller with
        ``healthy == False`` instead of raising (serving-style
        degradation; the default is to fail loudly).
    """

    def __init__(self, check_every=10, ema_decay=0.98, spike_factor=10.0,
                 warmup_steps=20, max_skips=3, lr_backoff=0.5,
                 max_lr_retries=2, max_rollbacks=2, recovery_checks=3,
                 raise_on_divergence=True):
        if int(check_every) < 1:
            raise ValueError("check_every must be >= 1")
        self.check_every = int(check_every)
        self.ema_decay = float(ema_decay)
        self.spike_factor = float(spike_factor)
        self.warmup_steps = int(warmup_steps)
        self.max_skips = int(max_skips)
        self.lr_backoff = float(lr_backoff)
        self.max_lr_retries = int(max_lr_retries)
        self.max_rollbacks = int(max_rollbacks)
        self.recovery_checks = int(recovery_checks)
        self.raise_on_divergence = bool(raise_on_divergence)

        #: multiplier the guarded step applies to updates (the LR rung)
        self.lr_scale = 1.0
        #: device-side spike threshold for upcoming steps (inf until the
        #: EMA warms up; refreshed every flush)
        self.max_gnorm = float("inf")

        self.step = 0              # guarded steps observed
        self.checks = 0            # flushes performed
        self.skipped = 0           # updates the device refused to apply
        self.lr_retries = 0        # LR rungs climbed since last recovery
        self.rollbacks = 0         # checkpoint rollbacks consumed
        self.last_good_step = 0    # most recent healthy step number
        self.last_restored_step = None  # trainer-step a rollback landed on
        self.healthy = True        # False once the ladder is exhausted
        self._ema = None
        self._ema_n = 0            # healthy samples folded into the EMA
        self._bad_streak = 0       # consecutive unhealthy steps
        self._good_checks = 0      # consecutive fully-healthy flushes
        self._pending = []         # (gnorm, ok, retryable) device scalars
        self._action = None        # RETRY / ROLLBACK for the driver
        self._in_step_flush = False  # flush fired from on_step (vs
        #                              verify_now / __exit__)
        #: a driver (FaultTolerantTrainer) is consuming take_action()
        #: this fit — unconsumed actions survive across flushes instead
        #: of being dropped, because the driver only runs AFTER the
        #: batch: a TBPTT segment loop flushes once per segment, and a
        #: ROLLBACK raised on segment k must still be pending when the
        #: driver looks, not burned by segment k+1's flush
        self.driver_attached = False
        self._climbed_this_flush = False  # one rung max per flush
        self._prev_active = None   # guardian shadowed by install()
        #: when bound to a trainer, only that trainer's reports count
        #: (a multi-host runner binds it: see `bind`)
        self._bound = None

    # -- install / clear (the faults.py pattern, plus nesting) -----------
    def install(self):
        """Install as ACTIVE, remembering the guardian this one shadows
        so `uninstall()` restores it — an inner scope (e.g.
        FaultTolerantTrainer.fit driving its own guardian inside a
        user's `with TrainingGuardian():` block) must not strip the
        outer guard from the fits that follow it."""
        global ACTIVE
        if ACTIVE is not self:
            self._prev_active = ACTIVE
            ACTIVE = self
        return self

    def uninstall(self):
        """Undo this guardian's install(): restore the guardian it
        shadowed (None when there was none). A no-op unless this
        guardian is the one currently ACTIVE."""
        global ACTIVE
        if ACTIVE is self:
            ACTIVE = getattr(self, "_prev_active", None)
            self._prev_active = None
        return self

    def __enter__(self):
        return self.install()

    def __exit__(self, exc_type, exc, tb):
        try:
            # the fit is over — flush the tail verdicts (steps since the
            # last check_every boundary) so skipped/status are accurate
            # after the with-block; skipped when an exception is already
            # propagating (a DivergenceError from here would mask it)
            if exc_type is None and self._pending:
                self._flush()
        finally:
            self.uninstall()
        return False

    def bind(self, trainer):
        """Scope verdict collection to `trainer`: while bound, only reports
        whose `source` IS that trainer feed this guardian's window, and
        source-less reports (the networks' own fit loops) are dropped,
        because any extra verdict desyncs a window that a
        `CoordinatedGuardian` folds across hosts. `MultiHostRunner` binds
        its trainer (whose `fit_batch` passes itself as the source) and
        unbinds at close. None unbinds: every report counts, the
        single-host default."""
        self._bound = trainer
        return self

    # -- the hot hook ----------------------------------------------------
    def on_step(self, loss, gnorm, ok=None, retryable=True, source=None):
        """Record one guarded step's device scalars. No host sync here:
        they materialize together at the `check_every` cadence. May raise
        `DivergenceError` from the flush when the ladder is exhausted.

        `gnorm` and `ok` are the step's 0-d tensors, or `gnorm` alone a
        (2,) tensor (gnorm, ok) the step already stacked; either way the
        guardian keeps a copy (a CUDA graph's replay overwrites its
        outputs). `loss` is accepted for call-site symmetry and NOT read:
        the device verdict already folded isfinite(loss) into `ok`.

        retryable=False marks steps whose batch must NOT be re-run by the
        RETRY rung (TBPTT segment loops: the healthy segments' updates
        were applied, so re-running the batch would apply them twice):
        escalation skips from the skip rung straight to rollback for
        those. `source` is the reporting trainer (see `bind`)."""
        if self._bound is not None and source is not self._bound:
            return
        self.step += 1
        if ok is None:
            stats = gnorm.detach().clone()
        else:
            stats = torch.stack([
                torch.as_tensor(gnorm, dtype=torch.float32).detach(),
                torch.as_tensor(ok, dtype=torch.float32).detach()])
        self._pending.append((stats, retryable))
        if len(self._pending) >= self.check_every:
            # step-aligned: the newest pending step IS the batch the
            # driver just ran, so a RETRY issued here targets it (a
            # verify_now/__exit__ flush never issues RETRY)
            self._in_step_flush = True
            try:
                self._flush()
            finally:
                self._in_step_flush = False

    def take_action(self):
        """Return-and-clear the pending escalation action (RETRY /
        ROLLBACK / None). Drivers that can act (FaultTolerantTrainer)
        consume this after each step; bare fit loops never call it —
        the LR reduction still applies to their subsequent steps, and
        rollback simply stays unavailable without a checkpointer."""
        act, self._action = self._action, None
        return act

    def verify_now(self):
        """Flush any pending verdicts NOW (one sync — callers align this
        with an already-host-bound moment like a checkpoint save) and
        report whether the CURRENT params are trustworthy: healthy, no
        live bad streak, no unconsumed escalation."""
        if self._pending:
            self._flush()
        return self.healthy and self._bad_streak == 0 \
            and self._action is None

    def note_rollback(self, restored_step):
        """A driver completed a checkpoint rollback: pending verdicts
        refer to discarded state, the EMA restarts (the restored region
        may live at a different gradient scale), and the streak resets
        so the restored run gets a fresh window. `restored_step` is the
        CHECKPOINT'S trainer-step number — a different timeline from
        this guardian's own step counter (a resumed run's guardian
        starts at 0) — so it surfaces as `last_restored_step`, while
        `last_good_step` stays on the guardian timeline: the restored
        state is verified good, so last-good is NOW."""
        self._pending.clear()
        self._bad_streak = 0
        self._good_checks = 0
        self._ema = None
        self._ema_n = 0
        self.max_gnorm = float("inf")
        self.last_restored_step = int(restored_step)
        self.last_good_step = self.step
        if _mon.enabled():
            _events.emit(
                "resilience", _events.GUARDIAN_ROLLBACK,
                attrs={"step": self.step, "phase": "restored",
                       "restored_step": self.last_restored_step},
                correlation_id="guardian-%x" % id(self))

    # -- the check -------------------------------------------------------
    def _materialize(self):
        """ONE stacked host read for all pending scalars, counted like
        every other host-blocking sync (`dl4j.pipeline.syncs`, site
        "guardian"). Each pending entry is a (2,) tensor (gnorm, ok) the
        step copied out of its graph's outputs."""
        from deeplearning4j_tpu_torch.runtime import pipeline as _pipeline
        stats, retryables = zip(*self._pending)
        self._pending = []
        t0 = time.perf_counter()
        flat = torch.stack([s.reshape(2).float() for s in stats]).cpu() \
            .numpy()
        if _mon.enabled():
            _pipeline.record_sync("guardian",
                                  (time.perf_counter() - t0) * 1e3)
        return flat[:, 0], flat[:, 1] > 0.5, retryables

    def _flush(self):
        if self._action is not None and not self.driver_attached:
            # an action nothing consumed across a full step cycle and no
            # driver attached means there IS no driver (bare fit) — drop
            # it so the ladder keeps climbing toward DivergenceError
            # instead of freezing, and so health reports recover. The
            # rung's side effect (reduced LR / burned rollback budget)
            # stands. With a driver attached the action PERSISTS: the
            # driver consumes only after the whole batch, and mid-batch
            # flushes (TBPTT segments) must not eat its escalations.
            self._action = None
        self._climbed_this_flush = False
        first_step = self.step - len(self._pending) + 1
        gnorms, oks, retryables = self._materialize()
        self.checks += 1
        # a RETRY re-runs the NEWEST batch (the one the driver just
        # trained), so it is only legal when THAT step's update was
        # refused on device (params still pre-batch) and its batch may
        # be re-run (retryable; TBPTT segments are not) and the flush is
        # step-aligned. Which step climbed the rung doesn't matter —
        # the re-run target is always the newest.
        can_retry = (bool(retryables[-1]) and not bool(oks[-1])
                     and self._in_step_flush)
        any_bad = False
        for i, (g, ok, retryable) in enumerate(
                zip(gnorms, oks, retryables)):
            step_no = first_step + i
            spike = (self._ema is not None
                     and self._ema_n >= self.warmup_steps
                     and g > self.spike_factor * self._ema)
            if ok and not spike:
                if self._ema is None:
                    self._ema = float(g)
                else:
                    self._ema = (self.ema_decay * self._ema
                                 + (1.0 - self.ema_decay) * float(g))
                self._ema_n += 1
                self.last_good_step = step_no
                self._bad_streak = 0
                continue
            any_bad = True
            self._bad_streak += 1
            # device_refused: the guarded step's torch.where never applied
            # this update. A host-only spike detection (ok but over the
            # EMA threshold the device had not learned yet) means the
            # update DID land — escalation may still reduce LR or roll
            # back, but re-running the batch would apply it twice.
            if not ok:
                self.skipped += 1
                if _mon.enabled():
                    _mon.get_registry().counter(
                        _mon.GUARDIAN_SKIPPED_UPDATES,
                        help="updates the guarded step refused to apply "
                             "(non-finite / grad spike)").inc()
            self._escalate(can_retry=can_retry)
        # feed the EMA threshold back to the device for upcoming steps
        if self._ema is not None and self._ema_n >= self.warmup_steps:
            self.max_gnorm = self.spike_factor * self._ema
        if any_bad:
            self._good_checks = 0
        else:
            self._good_checks += 1
            if self._good_checks >= self.recovery_checks \
                    and self.lr_scale != 1.0:
                self.lr_scale = 1.0
                self.lr_retries = 0
                if _mon.enabled():
                    _events.emit(
                        "resilience", _events.GUARDIAN_RECOVERED,
                        attrs={"step": self.step,
                               "good_checks": self._good_checks},
                        correlation_id="guardian-%x" % id(self))
        if _mon.enabled():
            reg = _mon.get_registry()
            reg.counter(_mon.GUARDIAN_CHECKS,
                        help="guardian health checks performed").inc()
            reg.gauge(_mon.GUARDIAN_LAST_GOOD_STEP,
                      help="most recent healthy guarded step") \
               .set(self.last_good_step)
        if self.raise_on_divergence and not self.healthy:
            raise DivergenceError(
                f"training diverged: {self.skipped} skipped updates, "
                f"{self.lr_retries} LR retries (lr_scale="
                f"{self.lr_scale:.3g}), {self.rollbacks} rollbacks — "
                f"escalation ladder exhausted at step {self.step} "
                f"(last good step {self.last_good_step})")

    def _escalate(self, can_retry=True):
        """One unhealthy step: climb the ladder. The skip rung is
        implicit (the device never applied the update); deeper rungs set
        `_action` for the driver and/or flip `healthy`. can_retry=False
        still climbs the LR rung (the reduced lr_scale applies from the
        next step) but never asks the driver to re-run the batch —
        that would double-apply an update that already landed (host-side
        spike detections, stale flushes) or replay a batch whose healthy
        TBPTT segments already trained (retryable=False)."""
        if self._action is not None or self._climbed_this_flush:
            # one rung per flush window, and none while an action awaits
            # the driver — a check_every>1 window of bad steps must not
            # exhaust the whole ladder internally before the driver
            # could act on a single rung
            return
        if self._bad_streak <= self.max_skips:
            return                               # rung 1: skip-and-count
        self._climbed_this_flush = True
        if self.lr_retries < self.max_lr_retries:
            self.lr_scale *= self.lr_backoff     # rung 2: reduce LR,
            self.lr_retries += 1                 # ask for a batch retry
            self._bad_streak = 0
            if can_retry:
                self._action = RETRY
            if _mon.enabled():
                _mon.get_registry().counter(
                    _mon.GUARDIAN_LR_RETRIES,
                    help="reduce-LR-and-retry escalations").inc()
                _events.emit(
                    "resilience", _events.GUARDIAN_RETRY,
                    attrs={"step": self.step, "lr_scale": self.lr_scale,
                           "retry": bool(can_retry)},
                    correlation_id="guardian-%x" % id(self))
            return
        if self.rollbacks < self.max_rollbacks:
            self.rollbacks += 1                  # rung 3: checkpoint
            self._bad_streak = 0                 # rollback (driver acts)
            self._action = ROLLBACK
            if _mon.enabled():
                _mon.get_registry().counter(
                    _mon.GUARDIAN_ROLLBACKS,
                    help="checkpoint rollbacks the guardian "
                         "requested").inc()
                _events.emit(
                    "resilience", _events.GUARDIAN_ROLLBACK,
                    attrs={"step": self.step, "phase": "requested",
                           "rollbacks": self.rollbacks},
                    correlation_id="guardian-%x" % id(self))
            return
        self.healthy = False                     # rung 4: give up
        if _mon.enabled():
            _events.emit(
                "resilience", _events.GUARDIAN_DIVERGED,
                attrs={"step": self.step, "skipped": self.skipped,
                       "rollbacks": self.rollbacks},
                correlation_id="guardian-%x" % id(self))

    # -- introspection (GET /health) -------------------------------------
    def snapshot(self):
        status = "diverged" if not self.healthy else (
            "degraded" if (self._bad_streak or self.lr_scale != 1.0
                           or self._action is not None) else "ok")
        return {
            "status": status,
            "step": self.step,
            "last_good_step": self.last_good_step,
            "checks": self.checks,
            "skipped_updates": self.skipped,
            "lr_scale": self.lr_scale,
            "lr_retries": self.lr_retries,
            "rollbacks": self.rollbacks,
            "last_restored_step": self.last_restored_step,
            "grad_norm_ema": self._ema,
            "max_gnorm": (None if self.max_gnorm == float("inf")
                          else self.max_gnorm),
            "pending": len(self._pending),
        }


def clear_guardian():
    """Force-reset the global switch, ignoring any shadow chain — test
    teardown and emergency use only; running code pairs install() with
    uninstall() (or the with-statement)."""
    global ACTIVE
    ACTIVE = None

"""FaultTolerantTrainer — checkpoint-resume training with retry and
skip-and-count: the network mode of
`deeplearning4j_tpu/resilience/trainer.py`.

It wraps a `MultiLayerNetwork` / `ComputationGraph`. `fit(iterator,
epochs=)` drives the model's own per-batch step (`_fit_batch`, through
its CUDA graphs on the card) with:

- periodic asynchronous `ElasticCheckpointer` saves of the parameters,
  the optimizer state, the BN state, the dropout generator's state and
  the counters, each with integrity's manifest;
- `resume_or_init()` on entry: the newest VERIFIED checkpoint is written
  into the live tensors, and the iterator batches the crashed run already
  consumed are skipped, so a resumed run reaches the uninterrupted run's
  state bit for bit;
- retry with backoff around transient dispatch failures: the state is
  copied to a device snapshot before each attempt and copied back before
  a retry, so a retried step is bit-identical to one that never failed;
- skip-and-count for non-finite batches (checked on the host, in the
  prefetch thread when the iterator prefetches) and for data faults;
- a `TrainingGuardian` it drives: reduced-LR retries re-run the batch,
  rollbacks restore the last verified checkpoint, and saves are gated
  on the guardian's verdict.

Every write into the model (snapshot restore, resume, rollback) copies
into the live tensors, never rebinds them: the step's CUDA graphs read
fixed addresses and stay valid. Every resume, retry, skipped batch and
save is observable through `monitoring/` (`dl4j.resilience.*`).

The sharded (functional) mode wraps a `ShardedTrainer`-style trainer
(`init` / `fit_batch` / `mesh`): `resume_or_init_sharded(init_params)`
returns the restored (params, opt_state) placed on the trainer's mesh,
and `fit_batch(params, opt_state, batch, rng)` adds the retry, the skip
of non-finite host batches, guardian escalations (a rollback swaps in the
restored state) and the periodic gated save. The caller derives `rng`
from `trainer.step` (e.g. a generator seeded from it) for a resume to be
exact. Over several ranks only rank 0 writes (the state is replicated);
a trainer whose state differs by rank (a compressing MultiHostTrainer's
encoder rows) is driven by `parallel.multihost.MultiHostRunner` instead.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience import guardian as _guardian
from deeplearning4j_tpu_torch.resilience import integrity as _integrity
from deeplearning4j_tpu_torch.resilience import watchdog as _watchdog
from deeplearning4j_tpu_torch.resilience.errors import (
    CheckpointIntegrityError, DivergenceError, FatalTrainingError)
from deeplearning4j_tpu_torch.resilience.policy import RetryPolicy

__all__ = ["FaultTolerantTrainer"]

_finite = _integrity.leaf_finite


def _dataset_arrays(ds):
    """Feature and label arrays of a DataSet or MultiDataSet (masks are
    weights: a zero there is meaning, not corruption)."""
    out = []
    for group in (getattr(ds, "features", None), getattr(ds, "labels", None)):
        if isinstance(group, (list, tuple)):
            out.extend(group)
        elif group is not None:
            out.append(group)
    return out


class _Checked:
    """A batch the prefetch thread staged, with its host-side finiteness
    verdict."""

    __slots__ = ("ds", "finite")

    def __init__(self, ds, finite):
        self.ds, self.finite = ds, finite


def _copy_tree(dst, src):
    """Write every leaf of `src` (host or device tensors) into its place
    in the live tree `dst`."""
    d = [l for _, l in _integrity.flatten(dst)]
    s = [l for _, l in _integrity.flatten(src)]
    if len(d) != len(s):
        raise ValueError(f"trees differ: {len(d)} vs {len(s)} leaves")
    with torch.no_grad():
        for a, b in zip(d, s):
            a.copy_(b)


class FaultTolerantTrainer:
    def __init__(self, model, directory, save_every=25, max_to_keep=3,
                 retry_policy=None, skip_non_finite=True,
                 max_skipped_batches=None, prefetch=2, guardian=None,
                 watchdog=None, sweep_orphans=True):
        """prefetch: staging-queue depth of the host pipeline (0
        disables); batches are counted where the loop consumes them, so
        `step` and the resume replay see exactly the batches that
        trained. guardian: a `TrainingGuardian` this trainer DRIVES
        (installed around fit()). watchdog: a `StallWatchdog` armed and
        disarmed around fit() (the caller owns its start()/stop()).
        sweep_orphans: False when the directory is shared with another
        saving process."""
        from deeplearning4j_tpu_torch.parallel.elastic import (
            ElasticCheckpointer, _world)
        self.model = model
        self.guardian = guardian
        self.watchdog = watchdog
        self.prefetch = int(prefetch)
        # over several processes only process 0 writes (sharded mode)
        self.ckpt = ElasticCheckpointer(directory, max_to_keep=max_to_keep,
                                        save_interval_steps=1,
                                        sweep_orphans=sweep_orphans
                                        and _world()[0] == 0)
        self.save_every = int(save_every)
        self.retry = retry_policy or RetryPolicy(max_attempts=3)
        self.skip_non_finite = bool(skip_non_finite)
        self.max_skipped_batches = max_skipped_batches
        self.step = 0              # iterator batches consumed (inc. skipped)
        self.skipped = 0
        self.resumed_step = None   # step restored from, or None
        self.retries = 0           # dispatch attempts retried
        self._is_network = hasattr(model, "_fit_batch")
        self._snap = None          # device snapshot buffers (_fit_one)

    # -- shared bookkeeping ---------------------------------------------
    def _count_skip(self, reason):
        self.skipped += 1
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.RESILIENCE_BATCHES_SKIPPED,
                labels={"reason": reason},
                help="batches skipped instead of crashing the run").inc()
        if self.max_skipped_batches is not None \
                and self.skipped > self.max_skipped_batches:
            raise FatalTrainingError(
                f"skipped {self.skipped} batches "
                f"(> max_skipped_batches={self.max_skipped_batches}) — "
                "data pipeline looks broken, refusing to train on noise")

    def _note_resume(self, step):
        self.resumed_step = step
        if _mon.enabled():
            reg = _mon.get_registry()
            reg.counter(_mon.RESILIENCE_RESUMES,
                        help="checkpoint resumes after restart").inc()
            reg.gauge(_mon.RESILIENCE_RESUME_STEP,
                      help="step the latest resume restored").set(step)

    # ===================== network mode =================================
    def _net_extra(self):
        m = self.model
        m._ensure_training()
        extra = {"generator": m._generator.get_state(),
                 "iteration": np.asarray(int(m._iteration), np.int64),
                 "epoch": np.asarray(int(m._epoch), np.int64),
                 "step": np.asarray(int(self.step), np.int64)}
        if m._state:
            extra["net_state"] = m._state
        return extra

    def _like(self):
        m = self.model
        return {"params": m._params, "opt_state": m._opt_state,
                "extra": self._net_extra()}

    def _save_network(self, wait=False, verdict=None):
        m = self.model
        self.ckpt.save(self.step, m._params, m._opt_state,
                       extra=self._net_extra(), wait=wait, verdict=verdict)

    def _guardian_allows_save(self, g):
        """THE save gate: a tree the guardian cannot vouch for
        (mid-escalation, an unresolved bad streak) is NEVER persisted, so
        every generation on disk is a known-good rollback target.
        Withheld saves count on dl4j.guardian.saves_gated."""
        if g is None or g.verify_now():
            return True
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.GUARDIAN_SAVES_GATED,
                help="checkpoint saves withheld because the guardian "
                     "could not vouch for the params").inc()
        return False

    def _maybe_save(self, g, wait=False):
        """Gated checkpoint save; the verdict lands in the manifest."""
        if not self._guardian_allows_save(g):
            return False
        self._save_network(wait=wait,
                           verdict=None if g is None else "verified")
        return True

    def _drive_guardian(self, g, ds):
        """Consume the guardian's escalation actions after a trained
        batch: RETRY re-runs the SAME batch (the guarded step refused the
        bad update, so the parameters are still pre-batch, and lr_scale
        is now reduced); ROLLBACK restores the newest verified checkpoint
        in place. Bounded by the ladder's depth."""
        for _ in range(g.max_lr_retries + g.max_rollbacks + 1):
            act = g.take_action()
            if act is None:
                return
            if act == _guardian.RETRY:
                self._fit_one(ds)
                continue
            if act == _guardian.ROLLBACK:
                self._rollback_network(g)
                return

    def _load_network_state(self, state):
        """Write restored state into the live model: parameters,
        optimizer state, BN state, the generator's state and the
        iteration count, each copied into the tensors the captured graphs
        read. Returns the restored step (batches consumed when the
        checkpoint was written). The epoch count is not restored: fit()
        walks every epoch from 0 again, skipping consumed batches."""
        m = self.model
        _copy_tree(m._params, state["params"])
        _copy_tree(m._opt_state, state["opt_state"])
        extra = state["extra"]
        if "net_state" in extra:
            _copy_tree(m._state, extra["net_state"])
        m._generator.set_state(extra["generator"].to(torch.uint8).cpu())
        m._iteration = int(extra["iteration"])
        return int(extra["step"])

    def resume_or_init(self):
        """Restore the newest VERIFIED checkpoint INTO the wrapped model
        (manifest checksums and finiteness verified, falling back a
        generation when the latest is corrupt). Returns the restored step
        (batches the crashed run consumed), 0 when starting fresh."""
        m = self.model
        if m._params is None:
            m.init()
        m._ensure_training()
        if self.ckpt.latest_step() is None:
            return 0
        step, state = self.ckpt.restore_verified(like=self._like())
        if step is None:
            return 0
        self.step = self._load_network_state(state)
        self._note_resume(self.step)
        return self.step

    def _rollback_network(self, g):
        """Guardian-requested rollback: restore the newest verified
        checkpoint IN PLACE (`self.step` keeps counting real iterator
        positions). Raises `DivergenceError` when there is nothing to
        roll back to."""
        try:
            self.ckpt.wait_until_finished()
            step, state = self.ckpt.restore_verified(like=self._like())
        except CheckpointIntegrityError as e:
            raise DivergenceError(
                "guardian requested rollback but no checkpoint "
                "generation could be restored") from e
        if step is None:
            raise DivergenceError(
                "guardian requested rollback but no verified checkpoint "
                "exists yet (diverged before the first save)")
        restored = self._load_network_state(state)
        g.note_rollback(restored)
        return restored

    # -- retry with an exact snapshot --------------------------------------
    def _snapshot(self):
        """Copy the live state into the device snapshot buffers (one
        multi-tensor copy), with the generator state and counters."""
        m = self.model
        trees = (m._params, m._opt_state, m._state)
        if self._snap is None:
            self._snap = [torch.empty_like(l) for _, l in
                          _integrity.flatten(trees)]
        live = [l for _, l in _integrity.flatten(trees)]
        if live:
            torch._foreach_copy_(self._snap, live)
        return (m._generator.get_state(), m._iteration, m._epoch, m._score)

    def _restore_snapshot(self, host):
        m = self.model
        live = [l for _, l in _integrity.flatten(
            (m._params, m._opt_state, m._state))]
        if live:
            torch._foreach_copy_(live, self._snap)
        gen, m._iteration, m._epoch, m._score = host
        m._generator.set_state(gen)

    def _fit_one(self, ds):
        """One batch through the model's own step, retrying transient
        dispatch failures; the pre-attempt snapshot is written back before
        every retry, so a retried step is bit-identical to a never-failed
        one."""
        m = self.model
        m._ensure_training()
        host = self._snapshot()

        def on_retry(attempt_n, exc):
            self.retries += 1
            self._restore_snapshot(host)

        self.retry.call(m._fit_batch, ds, label="train.dispatch",
                        on_retry=on_retry)

    def fit(self, data, epochs=1):
        """Resume (if a checkpoint exists), then drive the iterator.
        Batch positions the crashed run already consumed are skipped;
        corrupt batches count as consumed, so replay alignment holds. A
        fatal error waits for in-flight saves before propagating, so the
        next run's `resume_or_init` sees every checkpoint this run
        completed."""
        if not self._is_network:
            raise TypeError("fit(iterator) is network mode; wrap a "
                            "MultiLayerNetwork/ComputationGraph")
        from deeplearning4j_tpu_torch.runtime import pipeline as _pipeline
        already = self.resume_or_init()
        consumed = 0
        g = self.guardian
        g_installed = False
        if g is not None and _guardian.ACTIVE is not g:
            g.install()
            g_installed = True
        elif g is None:
            # a with-block guardian the caller installed: the guarded step
            # reports to it, so this fit drives it too
            g = _guardian.ACTIVE
        g_prev_driver = None
        if g is not None:
            g_prev_driver = g.driver_attached
            g.driver_attached = True
        if self.watchdog is not None:
            self.watchdog.arm()
        replay = {"left": already}
        dev = self.model._device

        def _stage(ds, device, ring, stream):
            # the worker's host-side finiteness verdict rides with the
            # staged batch; batches the resume replays past stay raw
            if replay["left"] > 0:
                replay["left"] -= 1
                return _Checked(ds, None)
            finite = None
            if self.skip_non_finite:
                finite = all(_finite(a) for a in _dataset_arrays(ds))
            return _Checked(_pipeline.stage_dataset(ds, device, ring,
                                                    stream), finite)

        src, pf = _pipeline.maybe_prefetch(data, self.prefetch, dev,
                                           stage=_stage)
        try:
            for _ in range(int(epochs)):
                if hasattr(src, "reset"):
                    src.reset()
                it = iter(src)
                while True:
                    # the fault site fires BEFORE the pull: the real batch
                    # is pulled and dropped so `consumed` stays aligned
                    # with the iterator's position
                    if _faults.ACTIVE is not None:
                        try:
                            _faults.ACTIVE.fire(_faults.DATA_NEXT)
                        except Exception as e:  # noqa: BLE001
                            if not self.retry.classifier(e):
                                raise
                            try:
                                next(it)
                            except StopIteration:
                                break
                            consumed += 1
                            if consumed > already:
                                self.step = consumed
                                self._count_skip("data_fault")
                            continue
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    except Exception as e:  # noqa: BLE001
                        if not self.retry.classifier(e):
                            raise
                        # the iterator itself failed mid-pull: that
                        # position is lost; count it consumed
                        consumed += 1
                        if consumed > already:
                            self.step = consumed
                            self._count_skip("data_error")
                        if isinstance(src, _pipeline.PrefetchIterator):
                            src.resume_after_error()
                        continue
                    consumed += 1
                    if consumed <= already:
                        continue       # trained before the crash
                    finite = None
                    if isinstance(item, _Checked):
                        item, finite = item.ds, item.finite
                    if self.skip_non_finite:
                        if finite is None:
                            finite = all(_finite(a)
                                         for a in _dataset_arrays(item))
                        if not finite:
                            self.step = consumed
                            self._count_skip("non_finite")
                            continue
                    self._fit_one(item)
                    if g is not None:
                        self._drive_guardian(g, item)
                    self.step = consumed
                    if self.step % self.save_every == 0:
                        self._maybe_save(g)
                self.model._epoch += 1
            self._maybe_save(g, wait=True)
        except Exception:
            # a kill lands here: finish in-flight saves so the restart
            # restores the newest completed checkpoint
            try:
                self.ckpt.wait_until_finished()
            except Exception:  # noqa: BLE001 — the original error wins
                pass
            raise
        finally:
            if g is not None:
                g.driver_attached = g_prev_driver
            if g_installed:
                g.uninstall()
            if _watchdog.ACTIVE is not None:
                _watchdog.ACTIVE.retire(self.model._beat_name())
            if self.watchdog is not None:
                self.watchdog.disarm()
            if pf is not None:
                pf.close()
        return self.model

    # ===================== sharded (functional) mode ====================
    # Over several processes the saves, the resume and the rollback are
    # collective (`elastic.save_collective`, `restore_collective`):
    # process 0 writes the whole state and broadcasts the outcome, and
    # every rank restores its block of the generation process 0 picked.
    def resume_or_init_sharded(self, init_params):
        """Sharded mode: init via the wrapped trainer, then overwrite with
        the newest verified checkpoint placed on the trainer's mesh.
        Returns (params, opt_state); `self.step` holds the restored step
        for the caller's rng derivation."""
        from deeplearning4j_tpu_torch.parallel.elastic import \
            restore_collective
        params, opt_state = self.model.init(init_params)
        step, state = restore_collective(
            self.ckpt, self.model, {"params": params, "opt_state": opt_state})
        if step is None:
            return params, opt_state
        self.step = int(step)
        self._note_resume(self.step)
        return state["params"], state["opt_state"]

    def _rollback_sharded(self, g, params, opt_state):
        """Guardian rollback, functional style: the newest verified
        generation written into the live (params, opt_state)."""
        from deeplearning4j_tpu_torch.parallel.elastic import \
            restore_collective
        try:
            self.ckpt.wait_until_finished()
            step, state = restore_collective(
                self.ckpt, self.model,
                {"params": params, "opt_state": opt_state})
        except CheckpointIntegrityError as e:
            raise DivergenceError(
                "guardian requested rollback but no checkpoint "
                "generation could be restored") from e
        if step is None:
            raise DivergenceError(
                "guardian requested rollback but no verified checkpoint "
                "exists yet (diverged before the first save)")
        _copy_tree(params, state["params"])
        _copy_tree(opt_state, state["opt_state"])
        g.note_rollback(int(step))
        return params, opt_state

    def _save_sharded(self, params, opt_state, g, wait=False):
        from deeplearning4j_tpu_torch.parallel.elastic import \
            save_collective
        if self._guardian_allows_save(g):
            save_collective(self.ckpt, self.step, self.model, params,
                            opt_state, wait=wait,
                            verdict=None if g is None else "verified")

    def fit_batch(self, params, opt_state, batch, rng):
        """Sharded mode: one retried step + periodic gated save.
        Non-finite host batches return the inputs unchanged with loss
        None (counted as skipped)."""
        trainer = self.model
        # a guardian handed to the constructor is installed here (the
        # functional style has no fit() scope to install it in); close()
        # clears it
        if self.guardian is not None \
                and _guardian.ACTIVE is not self.guardian:
            self.guardian.install()
        if self.guardian is not None:
            self.guardian.driver_attached = True
        if self.skip_non_finite:
            # only HOST leaves are checked: reading device leaves would
            # cost a sync every step
            from deeplearning4j_tpu_torch.parallel import mesh as _mesh
            leaves = []
            _mesh._tree_map(lambda a: leaves.append(a)
                            if isinstance(a, np.ndarray) else None, batch)
            if not all(_finite(a) for a in leaves):
                self.step += 1
                self._count_skip("non_finite")
                return params, opt_state, None

        def on_retry(attempt_n, exc):
            self.retries += 1

        params, opt_state, loss = self.retry.call(
            trainer.fit_batch, params, opt_state, batch, rng,
            label="train.dispatch", on_retry=on_retry)
        self.step += 1
        # guardian escalations, functional flavor: the guarded step
        # already refused the bad update; the reduced lr_scale applies
        # from the next step, and ROLLBACK swaps in the restored state
        g = _guardian.ACTIVE
        if g is not None:
            act = g.take_action()
            if act == _guardian.ROLLBACK:
                params, opt_state = self._rollback_sharded(
                    g, params, opt_state)
        if self.step % self.save_every == 0:
            self._save_sharded(params, opt_state, g)
        return params, opt_state, loss

    def finalize(self, params=None, opt_state=None):
        """Final synchronous save (sharded mode passes the live state;
        network mode reads it off the model), gated like every other,
        and close."""
        g = self.guardian if self.guardian is not None \
            else _guardian.ACTIVE
        if params is not None:
            self._save_sharded(params, opt_state, g, wait=True)
        elif self._is_network and self.model._params is not None:
            self.model._ensure_training()
            self._maybe_save(g, wait=True)
        self.close()

    def close(self):
        if self.guardian is not None:
            self.guardian.driver_attached = False
            self.guardian.uninstall()
        self.ckpt.close()

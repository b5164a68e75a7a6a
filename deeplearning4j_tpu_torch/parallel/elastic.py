"""Checkpoint save and resume for fault-tolerant training: the
`ElasticCheckpointer` half of `deeplearning4j_tpu/parallel/elastic.py`.

The JAX package saves through orbax; the port writes its own format, one
directory per step:

    <directory>/<step>/leaves.npz     the leaves, uncompressed, keys l0..lK
    <directory>/<step>/leaves.json    each leaf's path and dtype
    <directory>/manifests/<step>.json integrity's manifest (checksums)

A step is written under `<step>.dl4j-tmp-<pid>-<n>` and renamed into
place when complete, so a kill mid-save leaves a temporary directory
(swept at the next start, `integrity.sweep_orphans`) and never a partial
step. The leaf order is `integrity.flatten`'s; a bf16 leaf is stored as
its raw 16-bit words.

An asynchronous save copies the state to the host at the save boundary
(on the card: non-blocking copies into pinned buffers on the current
stream, so the next step, which overwrites the live tensors in place,
is ordered after them) and writes the files on a thread; `wait=True`,
`wait_until_finished` and `close` join it, and `check_for_errors`
raises what the thread hit. `restore` returns host tensors in the
structure of `like`, which the trainer copies into the live tensors.

`ElasticTrainer`, `place_global`, `replace_on_mesh` and
`initialize_multihost` belong to the multi-host half of parallel/: they
raise, naming ROADMAP A15b.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience import integrity as _integrity
from deeplearning4j_tpu_torch.resilience.errors import \
    CheckpointIntegrityError

__all__ = ["ElasticCheckpointer", "ElasticTrainer", "initialize_multihost",
           "place_global", "replace_on_mesh"]

_LEAVES = "leaves.npz"
_META = "leaves.json"
_SEQ = itertools.count()


def _a15(what):
    return NotImplementedError(
        f"{what} is not ported yet; it comes with the multi-host half of "
        "parallel/ (ROADMAP A15b)")


def _snapshot(leaf):
    """(host copy, needs the copy event) of one leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host, True
        return t.clone(), False
    return np.array(leaf), False


def _to_numpy(leaf):
    """(array, dtype name) as stored."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.int16).numpy(), "bfloat16"
        return leaf.numpy(), str(leaf.dtype).replace("torch.", "")
    a = np.asarray(leaf)
    return a, a.dtype.name


def _from_numpy(a, dtype):
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(a, np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _unflatten(like, leaves):
    """A tree shaped like `like` with its leaves (in `flatten` order)
    taken from the iterator `leaves`."""
    if isinstance(like, dict):
        out = {}
        for k in sorted(like, key=str):
            out[k] = _unflatten(like[k], leaves)
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, leaves) for v in like]
        return vals if isinstance(like, list) else type(like)(vals) \
            if not hasattr(like, "_fields") else type(like)(*vals)
    if like is None:
        return None
    return next(leaves)


class ElasticCheckpointer:
    """Save and resume of (step, params, opt_state[, extra]) trees.
    `extra` carries what the trainer needs for a step-accurate resume
    (the dropout generator's state, BN state, the counters)."""

    def __init__(self, directory, max_to_keep=3, save_interval_steps=1,
                 sweep_orphans=True, primary_only=False):
        """sweep_orphans=False skips the startup debris sweep: required
        when another process may be saving into the same directory.
        `primary_only` (the multi-host single writer) raises, naming
        ROADMAP A15b."""
        if primary_only:
            raise _a15("ElasticCheckpointer(primary_only=True)")
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.orphans_removed = (_integrity.sweep_orphans(self.directory)
                                if sweep_orphans else 0)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))
        self._thread = None
        self._error = None
        self._closed = False
        #: (step, bytes, host seconds of the write) of the last save
        self.last_save = None

    # -- errors and waiting ----------------------------------------------
    def check_for_errors(self):
        """Raise a deferred failure of an asynchronous save now."""
        err, self._error = self._error, None
        if err is not None:
            raise err

    def wait_until_finished(self):
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    # -- save -------------------------------------------------------------
    def save(self, step, params, opt_state=None, extra=None, wait=False,
             verdict=None):
        """`verdict` is the guardian's health verdict recorded in the
        integrity manifest ("verified" when the guardian vouched for this
        state; default "unguarded")."""
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.CHECKPOINT_SAVE)
        self.wait_until_finished()
        self.check_for_errors()
        step = int(step)
        if step % self.save_interval_steps:
            return self
        state = {"params": params}
        if opt_state is not None:
            state["opt_state"] = opt_state
        if extra:
            state["extra"] = extra
        flat = _integrity.flatten(state)
        snaps = [_snapshot(l) for _, l in flat]
        event = None
        if any(needs for _, needs in snaps):
            event = torch.cuda.Event()
            event.record()
        leaves = [h for h, _ in snaps]
        paths = [p for p, _ in flat]
        self._thread = threading.Thread(
            target=self._write_guarded,
            args=(step, paths, leaves, event, verdict), daemon=True,
            name=f"dl4j-ckpt-{step}")
        self._thread.start()
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.RESILIENCE_CHECKPOINT_SAVES,
                help="checkpoint saves issued (async unless wait)").inc()
        if wait:
            self.wait_until_finished()
            self.check_for_errors()
        return self

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 — surfaced later
            self._error = e

    def _write(self, step, paths, leaves, event, verdict):
        import time
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        # the manifest first: a kill before the rename leaves a manifest
        # without its step, which the startup sweep removes
        _integrity.write_manifest(self.directory, step, None,
                                  verdict=verdict,
                                  flat=list(zip(paths, leaves)))
        arrays, dtypes = {}, []
        for i, leaf in enumerate(leaves):
            a, dt = _to_numpy(leaf)
            arrays[f"l{i}"] = a
            dtypes.append(dt)
        tmp = os.path.join(self.directory,
                           f"{step}{_integrity.TMP_MARK}-{os.getpid()}-"
                           f"{next(_SEQ)}")
        os.makedirs(tmp)
        with open(os.path.join(tmp, _LEAVES), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump({"step": step, "paths": paths, "dtypes": dtypes}, f)
        final = os.path.join(self.directory, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        nbytes = sum(a.nbytes for a in arrays.values())
        self._gc()
        _integrity.prune_manifests(self.directory, keep=self.all_steps())
        self.last_save = (step, nbytes, time.perf_counter() - t0)

    def _gc(self):
        if not self.max_to_keep:
            return
        for s in self.all_steps()[:-int(self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    # -- inspection --------------------------------------------------------
    def all_steps(self):
        """Every complete on-disk generation, ascending."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(e) for e in entries if e.isdigit()
                      and os.path.isfile(os.path.join(self.directory, e,
                                                      _META)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_bytes(self, step):
        """Bytes of a generation's leaves file on disk."""
        return os.path.getsize(os.path.join(self.directory, str(int(step)),
                                            _LEAVES))

    # -- restore ----------------------------------------------------------
    def restore(self, step=None, like=None):
        """(step, state): the generation's leaves as host tensors, in the
        structure of `like` (each in its `like` leaf's dtype) or, without
        `like`, as {path: tensor}. (None, None) when there is no
        checkpoint. A leaf count or shape that differs from `like`'s
        raises ValueError."""
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.CHECKPOINT_RESTORE)
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None, None
        d = os.path.join(self.directory, str(step))
        with open(os.path.join(d, _META)) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, _LEAVES)) as z:
            raw = [_from_numpy(z[f"l{i}"], dt)
                   for i, dt in enumerate(meta["dtypes"])]
        if like is None:
            return step, dict(zip(meta["paths"], raw))
        want = _integrity.flatten(like)
        if len(want) != len(raw):
            raise ValueError(
                f"checkpoint step {step} has {len(raw)} leaves but the "
                f"restore target has {len(want)} — saved and target "
                "structures do not match")
        out = []
        for (path, w), got in zip(want, raw):
            ws = tuple(getattr(w, "shape", ()) or ())
            if ws != tuple(got.shape):
                raise ValueError(
                    f"checkpoint step {step}: leaf {path} has shape "
                    f"{tuple(got.shape)}, the target {ws} — saved and "
                    "target structures do not match")
            if torch.is_tensor(w):
                got = got.to(w.dtype)
            out.append(got)
        return step, _unflatten(like, iter(out))

    def restore_verified(self, like=None, check_finite=True):
        """The newest generation that passes integrity verification
        (manifest checksums and finiteness), falling back a generation on
        any restore or verification failure, counted on
        `dl4j.resilience.ckpt_restore_fallbacks`. (None, None) when no
        checkpoint exists; raises `CheckpointIntegrityError` when
        generations exist but none could be restored."""
        steps = self.all_steps()
        if not steps:
            return None, None
        last_err = None
        for step in reversed(steps):
            try:
                s, state = self.restore(step=step, like=like)
                _integrity.verify_restored(self.directory, step, state,
                                           check_finite=check_finite)
                return s, state
            except Exception as e:  # noqa: BLE001 — this generation is
                last_err = e        # unusable; an older one may not be
                if _mon.enabled():
                    _mon.get_registry().counter(
                        _mon.RESILIENCE_CKPT_FALLBACKS,
                        labels={"reason": type(e).__name__},
                        help="checkpoint generations skipped on restore "
                             "(corrupt/unreadable)").inc()
        raise CheckpointIntegrityError(
            f"no restorable checkpoint generation in {self.directory} "
            f"({len(steps)} tried; newest failure: {last_err})") \
            from last_err

    def close(self):
        """Idempotent: wait for an in-flight save, then raise what it
        hit."""
        if self._closed:
            return
        self._closed = True
        self.wait_until_finished()
        self.check_for_errors()


def place_global(host, sharding):
    raise _a15("place_global")


def replace_on_mesh(mesh, like, state):
    raise _a15("replace_on_mesh")


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    raise _a15("initialize_multihost")


class ElasticTrainer:
    """The sharded trainer's checkpoint loop (ROADMAP A15b)."""

    def __init__(self, *args, **kwargs):
        raise _a15("ElasticTrainer")

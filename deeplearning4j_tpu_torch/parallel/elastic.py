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

Multi-host modes: `primary_only=True` is the single writer of a
multi-host run (process 0): it writes each step's manifest before `save`
returns, so the peers can verify it once the writer reaches the save's
fence, even while the leaves are still being written; `read_only=True` is
the peers' flavor: restore and inspect, no sweep, no save.

A checkpoint holds every leaf whole. A trainer's `state_specs` says how
each leaf lies over the mesh: `host_state` gathers the blocks into whole
host tensors by it, and `place_global` and `replace_on_mesh` cut a
rank's block back out. `save_collective` and `restore_collective` are
the multi-process save (process 0 writes, its outcome broadcast as the
fence) and resume (process 0 picks the generation, every rank restores
it); `ElasticTrainer` wraps a ShardedTrainer-style step with them, and
`initialize_multihost` is the hardened bootstrap (`multihost.initialize`).
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
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.coordination import _world
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience import integrity as _integrity
from deeplearning4j_tpu_torch.resilience.errors import \
    CheckpointIntegrityError

__all__ = ["ElasticCheckpointer", "ElasticTrainer", "host_state",
           "initialize_multihost", "place_global", "replace_on_mesh",
           "restore_collective", "save_collective", "whole_zeros"]

_LEAVES = "leaves.npz"
_META = "leaves.json"
_SEQ = itertools.count()


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
                 sweep_orphans=True, primary_only=False, read_only=False):
        """sweep_orphans=False skips the startup debris sweep: required
        when another process may be saving into the same directory.
        `primary_only`: the multi-host single writer (manifests written
        before `save` returns); `read_only`: a peer's restore-only view
        (no sweep; `save` raises)."""
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.primary_only = bool(primary_only)
        self.read_only = bool(read_only)
        self.orphans_removed = (_integrity.sweep_orphans(self.directory)
                                if sweep_orphans and not read_only else 0)
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
        if self.read_only:
            raise RuntimeError(
                f"checkpointer of {self.directory} is read-only (a peer of "
                "a multi-host run: process 0 writes)")
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
        manifest = True
        if self.primary_only:
            # the single writer's peers verify the manifest as soon as
            # the writer passes the save's fence
            if event is not None:
                event.synchronize()
                event = None
            self._write_manifest(step, paths, leaves, verdict)
            manifest = False
        self._thread = threading.Thread(
            target=self._write_guarded,
            args=(step, paths, leaves, event, verdict, manifest),
            daemon=True,
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

    def _write_manifest(self, step, paths, leaves, verdict):
        _integrity.write_manifest(self.directory, step, None,
                                  verdict=verdict,
                                  flat=list(zip(paths, leaves)))

    def _write(self, step, paths, leaves, event, verdict, manifest=True):
        import time
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        # the manifest first: a kill before the rename leaves a manifest
        # without its step, which the startup sweep removes
        if manifest:
            self._write_manifest(step, paths, leaves, verdict)
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


def _block_of(t, mesh, spec):
    """This rank's block of a whole tensor under `spec`."""
    for dim, name in enumerate(spec):
        if name is not None and name in mesh.shape:
            t = _mesh._local_slice(t, dim, mesh.index(name),
                                   mesh.shape[name])
    return t


def place_global(host, sharding):
    """A host array (numpy or tensor) placed as this rank's block under a
    `NamedSharding` (the dims its spec names sliced to this rank's
    coordinate), as a fresh tensor on the mesh's device that owns its
    memory."""
    mesh = getattr(sharding.mesh, "mesh", sharding.mesh)
    t = host if torch.is_tensor(host) else torch.from_numpy(
        np.ascontiguousarray(host))
    return _block_of(t, mesh, sharding.spec).to(mesh.device).clone()


def host_state(mesh, state, specs):
    """Every leaf of `state` whole, as a host tensor: the dims its spec
    (the P at the same place in `specs`) names all-gathered from the
    ranks that hold their blocks. A collective: every rank of those axes
    calls it."""
    mesh = getattr(mesh, "mesh", mesh)

    def whole(t, spec):
        if not torch.is_tensor(t):
            return t
        for dim, name in enumerate(spec):
            group = mesh.group(name) if name is not None else None
            if group is not None and mesh.shape[name] > 1:
                t = _mesh._all_gather(t, group, mesh.shape[name], dim)
        return t.detach().cpu().clone()

    return _mesh._tree_map(whole, state, specs)


def whole_zeros(mesh, like, specs):
    """Host zeros of every leaf's whole shape (each dim its spec names
    times that axis' size), in its `like` dtype: a restore's target."""
    mesh = getattr(mesh, "mesh", mesh)

    def zeros(t, spec):
        if not torch.is_tensor(t):
            return t
        shape = list(t.shape)
        for dim, name in enumerate(spec):
            if name is not None:
                shape[dim] *= mesh.shape.get(name, 1)
        return torch.zeros(shape, dtype=t.dtype)

    return _mesh._tree_map(zeros, like, specs)


def replace_on_mesh(mesh, like, state, specs):
    """Re-place every restored whole host leaf as this rank's block under
    its spec (the P at the same place in `specs`, the trainer's
    `state_specs`), in its `like` counterpart's dtype. Returns fresh
    tensors on the mesh's device; a block whose shape is not its `like`
    leaf's raises ValueError."""
    mesh = getattr(mesh, "mesh", mesh)

    def place(fresh, restored, spec):
        if not torch.is_tensor(fresh):
            return restored
        got = place_global(restored, _mesh.NamedSharding(mesh, spec))
        if tuple(got.shape) != tuple(fresh.shape):
            raise ValueError(
                f"restored leaf of shape {tuple(restored.shape)} gives "
                f"this rank a {tuple(got.shape)} block under {spec}, the "
                f"live leaf is {tuple(fresh.shape)}")
        return got.to(fresh.dtype)

    return _mesh._tree_map(place, like, state, specs)


def _agree(value):
    """Process 0's `value` on every process of the default group."""
    import torch.distributed as dist
    if _world()[1] == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def save_collective(ckpt, step, trainer, params, opt_state, wait=False,
                    verdict=None):
    """Save a trainer's state as one checkpoint. On one process it is
    `ckpt.save`. On several, every rank gathers the whole state
    (`host_state`), process 0 writes it to completion, and its outcome
    is broadcast: the broadcast is the fence after which every rank may
    read the generation, and a failed write raises on every rank."""
    rank, world = _world()
    if world == 1:
        ckpt.save(step, params, opt_state, wait=wait, verdict=verdict)
        return
    host = host_state(trainer.mesh, {"params": params,
                                     "opt_state": opt_state},
                      trainer.state_specs(params, opt_state))
    err = None
    if rank == 0:
        try:
            ckpt.save(step, host["params"], host["opt_state"], wait=True,
                      verdict=verdict)
        except Exception as e:  # noqa: BLE001 — every rank raises below
            err = e
    msg = _agree(None if err is None else f"{type(err).__name__}: {err}")
    if err is not None:
        raise err
    if msg is not None:
        raise RuntimeError(f"process 0's checkpoint save of step {step} "
                           f"failed: {msg}")


def restore_collective(ckpt, trainer, like):
    """(step, state placed on the trainer's mesh) of the newest verified
    generation, or (None, None). On several processes, process 0 picks
    the generation (`restore_verified`) and every rank restores and
    verifies that one, so all land on the same step."""
    specs = trainer.state_specs(like["params"], like["opt_state"])
    host_like = whole_zeros(trainer.mesh, like, specs)
    rank, world = _world()
    if world == 1:
        step, state = ckpt.restore_verified(like=host_like)
    else:
        step = state = err = None
        if rank == 0:
            try:
                step, state = ckpt.restore_verified(like=host_like)
            except CheckpointIntegrityError as e:
                err = e
        step, msg = _agree((step, None if err is None else str(err)))
        if err is not None:
            raise err
        if msg is not None:
            raise CheckpointIntegrityError(msg)
        if rank != 0 and step is not None:
            step, state = ckpt.restore(step=step, like=host_like)
            _integrity.verify_restored(ckpt.directory, step, state)
    if step is None:
        return None, None
    return step, replace_on_mesh(trainer.mesh, like, state, specs)


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """≡ the reference's cluster join for the elastic path: the hardened
    bootstrap (`multihost.initialize`, one implementation), which
    resolves the env config itself and returns False when no coordinator
    is configured."""
    from deeplearning4j_tpu_torch.parallel.multihost import initialize
    return initialize(coordinator_address, num_processes, process_id)


class ElasticTrainer:
    """Wrap a ShardedTrainer-style step with periodic checkpoints and
    crash-resume (≡ the fault-tolerant SharedTrainingMaster loop). The
    functional style of the trainer: `resume_or_init(init_params)` then
    `fit_batch(params, opt_state, batch, rng)`; `step_num` counts the
    steps taken, resumed ones included. Over several processes the saves
    and the resume are collective (`save_collective`,
    `restore_collective`): process 0 writes the whole state into the
    shared `directory`, and every rank resumes its block of one
    generation."""

    def __init__(self, trainer, directory, save_every=50, max_to_keep=3,
                 sweep_orphans=True):
        rank, world = _world()
        self.trainer = trainer
        self.ckpt = ElasticCheckpointer(directory, max_to_keep=max_to_keep,
                                        save_interval_steps=save_every,
                                        sweep_orphans=sweep_orphans,
                                        read_only=rank > 0)
        self.save_every = int(save_every)
        self.step_num = 0

    def resume_or_init(self, init_params):
        """Restore the newest VERIFIED checkpoint if one exists (manifest
        checksums and finiteness, falling back a generation on
        corruption), else shard the given fresh params. Returns (params,
        opt_state)."""
        params, opt_state = self.trainer.init(init_params)
        step, state = restore_collective(
            self.ckpt, self.trainer,
            {"params": params, "opt_state": opt_state})
        if step is None:
            return params, opt_state
        self.step_num = step
        return state["params"], state["opt_state"]

    def _save(self, params, opt_state, wait=False):
        if self.step_num % self.save_every == 0:
            save_collective(self.ckpt, self.step_num, self.trainer, params,
                            opt_state, wait=wait)

    def fit_batch(self, params, opt_state, batch, rng):
        params, opt_state, loss = self.trainer.fit_batch(
            params, opt_state, batch, rng)
        self.step_num += 1
        self._save(params, opt_state)
        return params, opt_state, loss

    def finalize(self, params, opt_state):
        self._save(params, opt_state, wait=True)
        self.ckpt.close()

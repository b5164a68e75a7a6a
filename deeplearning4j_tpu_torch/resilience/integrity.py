"""Checkpoint integrity manifests (the "trust but verify" half of the
training guardian): a copy of `deeplearning4j_tpu/resilience/integrity.py`
re-pointed at the port.

Every `ElasticCheckpointer.save` writes a sidecar manifest under
`<directory>/manifests/<step>.json` via write-tmp + atomic `os.replace`:

    {"step": N, "leaf_count": K, "treedef": "...",
     "checksums": ["crc32:...", ...],        # per leaf, in leaf order
     "guardian": "verified" | "unguarded",   # health verdict at save
     "format": 1}

The leaf order is the port's: dict keys sorted as strings, lists and
tuples in order (`flatten`, the order of `runtime.executables.
tensor_leaves`, plus non-tensor leaves); `treedef` names each leaf's
path. A leaf's checksum is the crc32 of its host bytes, so a tensor and
the numpy array of the same values (the JAX package's leaves) checksum
alike. The manifest is computed from the same host snapshot the save
writes, so it costs no extra device sync.

On restore, `verify_restored` recomputes per-leaf checksums of what was
read back and compares: any mismatch (or non-finite values, or a
missing/truncated manifest file for a manifest-bearing step) raises
`CheckpointIntegrityError`, and `ElasticCheckpointer.restore_verified`
falls back to the previous generation, counted on
`dl4j.resilience.ckpt_restore_fallbacks`. The `checkpoint.corrupt`
fault-injection site fires inside verification so tests prove the
fallback path without corrupting files by hand.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib

import numpy as np
import torch

from deeplearning4j_tpu_torch.resilience.errors import \
    CheckpointIntegrityError

__all__ = [
    "flatten", "leaf_finite", "manifest_path", "prune_manifests",
    "read_manifest", "sweep_orphans", "tree_finite", "verify_restored",
    "write_manifest", "TMP_MARK",
]

_FORMAT = 1
_MANIFEST_DIR = "manifests"
#: the mark of a step directory the checkpointer is still writing
TMP_MARK = ".dl4j-tmp"


# -- the port's leaf order --------------------------------------------------
def flatten(tree, path=""):
    """[(path, leaf)] of a tree of dicts (keys sorted as strings), lists
    and tuples; None entries are structure, not leaves."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree, key=str)
                for pl in flatten(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten(v, f"{path}/{i}")]
    if tree is None:
        return []
    return [(path, tree)]


def _host(leaf):
    """A leaf as a host numpy array (bf16 as its raw 16-bit words)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(leaf)


# -- finiteness -------------------------------------------------------------
def leaf_finite(a):
    """True when `a` contains no NaN/Inf. Python scalars, ints, bools,
    numpy arrays and tensors of any dtype (bf16 included); non-numeric
    leaves have nothing to check."""
    if a is None or isinstance(a, (bool, int)):
        return True
    if torch.is_tensor(a):
        if not (a.is_floating_point() or a.is_complex()):
            return True
        return bool(torch.isfinite(a).all())
    arr = np.asarray(a)
    kind = arr.dtype.kind
    if kind in "iub?SUO":
        return True
    if kind in "fc":
        return bool(np.isfinite(arr).all())
    try:
        return bool(np.isfinite(arr.astype(np.float32)).all())
    except (TypeError, ValueError):
        return True


def tree_finite(tree):
    """True when every leaf of the tree passes `leaf_finite`."""
    return all(leaf_finite(l) for _, l in flatten(tree))


# -- manifest write/read ----------------------------------------------------
def _leaf_checksum(leaf):
    """crc32 over the leaf's host bytes, prefixed so the algorithm can
    evolve without ambiguity."""
    arr = np.ascontiguousarray(_host(leaf))
    try:
        data = memoryview(arr).cast("B")
    except (BufferError, TypeError, ValueError):
        data = arr.tobytes()
    return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def _treedef(flat):
    return ";".join(p for p, _ in flat)


def manifest_path(directory, step):
    return os.path.join(str(directory), _MANIFEST_DIR, f"{int(step)}.json")


def write_manifest(directory, step, state, verdict=None, flat=None):
    """Write the integrity manifest for `state` (or for `flat`, its
    [(path, leaf)] already flattened) via tmp-file + atomic rename, so a
    kill mid-write leaves either the old manifest or none, never a
    truncated one. Returns the manifest path."""
    if flat is None:
        flat = flatten(state)
    doc = {
        "format": _FORMAT,
        "step": int(step),
        "leaf_count": len(flat),
        "treedef": _treedef(flat),
        "checksums": [_leaf_checksum(l) for _, l in flat],
        "guardian": verdict if verdict is not None else "unguarded",
    }
    path = manifest_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_manifest(directory, step):
    """The parsed manifest dict, or None when the step has none. A present
    but unreadable or truncated manifest raises
    `CheckpointIntegrityError`: that is corruption, not absence."""
    path = manifest_path(directory, step)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(
            f"checkpoint step {step}: manifest {path} is unreadable "
            f"({e}) — treating the generation as corrupt") from e


def verify_restored(directory, step, state, check_finite=True):
    """Verify a restored `state` tree against the step's manifest: leaf
    count, structure, per-leaf checksums, and (optionally) finiteness of
    every leaf. Raises `CheckpointIntegrityError` on any mismatch; returns
    "verified", or "unverified" when no manifest exists for the step."""
    from deeplearning4j_tpu_torch.resilience import faults as _faults
    if _faults.ACTIVE is not None:
        _faults.ACTIVE.fire(_faults.CHECKPOINT_CORRUPT)
    flat = flatten(state)
    if check_finite:
        for i, (_, leaf) in enumerate(flat):
            if not leaf_finite(leaf):
                raise CheckpointIntegrityError(
                    f"checkpoint step {step}: restored leaf {i} contains "
                    "non-finite values — refusing to resume from "
                    "poisoned state")
    manifest = read_manifest(directory, step)
    if manifest is None:
        return "unverified"
    want_treedef = manifest.get("treedef")
    if want_treedef is not None and want_treedef != _treedef(flat):
        raise CheckpointIntegrityError(
            f"checkpoint step {step}: restored tree structure does not "
            f"match the manifest's — saved {want_treedef!r}, restored "
            f"{_treedef(flat)!r}")
    if manifest.get("leaf_count") != len(flat):
        raise CheckpointIntegrityError(
            f"checkpoint step {step}: manifest records "
            f"{manifest.get('leaf_count')} leaves but restore produced "
            f"{len(flat)}")
    want = manifest.get("checksums", [])
    for i, (_, leaf) in enumerate(flat):
        got = _leaf_checksum(leaf)
        if want[i] != "skip" and got != want[i]:
            raise CheckpointIntegrityError(
                f"checkpoint step {step}: leaf {i} checksum {got} != "
                f"manifest {want[i]} — bytes corrupted on disk or in "
                "transit")
    return "verified"


def prune_manifests(directory, keep):
    """Remove sidecar manifests of generations no longer on disk. `keep`
    is the iterable of live step numbers. Best effort; returns the
    number removed."""
    mdir = os.path.join(str(directory), _MANIFEST_DIR)
    try:
        entries = os.listdir(mdir)
    except OSError:
        return 0
    live = {str(int(s)) for s in keep}
    removed = 0
    for e in entries:
        stem = e[:-5] if e.endswith(".json") else e
        if stem.isdigit() and stem not in live:
            try:
                os.remove(os.path.join(mdir, e))
                removed += 1
            except OSError:
                pass
    return removed


# -- startup orphan sweep ---------------------------------------------------
def sweep_orphans(directory):
    """Remove debris a killed run can leave in a checkpoint directory: the
    checkpointer's in-progress step directories (`*.dl4j-tmp-*`), bare
    `*.tmp` files and directories (half-written manifests included), and
    manifests whose step directory no longer exists. Returns the number
    of entries removed.

    Only safe at STARTUP, before this process issues any save, and in a
    directory no other process is saving into."""
    directory = str(directory)
    removed = 0
    try:
        entries = os.listdir(directory)
    except OSError:
        return 0

    def _rm(path):
        nonlocal removed
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
            removed += 1
        except OSError:
            pass                   # best effort: a sweep must never crash

    steps = {e for e in entries
             if e.isdigit() and os.path.isdir(os.path.join(directory, e))}
    for e in entries:
        if TMP_MARK in e or e.endswith(".tmp"):
            _rm(os.path.join(directory, e))
    mdir = os.path.join(directory, _MANIFEST_DIR)
    if os.path.isdir(mdir):
        for e in os.listdir(mdir):
            path = os.path.join(mdir, e)
            if e.endswith(".tmp"):
                _rm(path)
                continue
            stem = e[:-5] if e.endswith(".json") else e
            if stem.isdigit() and stem not in steps:
                _rm(path)
    if removed:
        from deeplearning4j_tpu_torch import monitoring as _mon
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.RESILIENCE_CKPT_ORPHANS_REMOVED,
                help="orphaned tmp/partial checkpoint entries swept at "
                     "startup").inc(removed)
    return removed

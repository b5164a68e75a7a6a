"""Byte-balanced gradient buckets for the overlapped exchange (≡ the
reference's EncodedGradientsAccumulator shipping gradient *chunks* as
they become ready, rather than one monolithic message after the whole
backward): the port of `deeplearning4j_tpu/parallel/buckets.py`.

The multi-host trainer splits the gradient tree into N byte-balanced
buckets and encodes and exchanges each as an INDEPENDENT collective,
issued in order (encode b0 → issue b0 → encode b1 → issue b1 → ... →
wait b0 ... wait N-1), so bucket k's collective is in flight while
bucket k+1 still encodes. The plan is computed once on the host from
leaf shapes (no device values touched); each bucket's leaves are
flattened and concatenated into one 1-D tensor of one dtype (the
planner never mixes dtypes), which is also what makes the per-bucket
threshold-encoder state natural: one flat residual and one adaptive
threshold per bucket.

The JAX package proves the overlap structure on the compiled HLO text;
torch has no compiled schedule to read, so `check_overlap_structure`
reads the order the step itself recorded (`MultiHostTrainer.
exchange_log`: the scope names below as each phase starts) or, on the
card, the start order of the same names in a torch.profiler trace (the
step wraps each phase in `record_function`).

Leaf order is `sharded_trainer._paths`' (dict keys sorted), which is
jax.tree_util's order for the same dict tree, so the plan of a tree is
the JAX package's plan of the same tree.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BucketPlan", "plan_buckets", "check_overlap_structure",
           "DEFAULT_NUM_BUCKETS", "ENCODE_SCOPE", "EXCHANGE_SCOPE",
           "WAIT_SCOPE"]

#: default bucket count when neither `num_buckets` nor `bucket_bytes`
#: is given: enough splits to overlap, few enough that per-collective
#: latency still amortizes
DEFAULT_NUM_BUCKETS = 4

#: the names the trainer records (and wraps in `record_function`) for
#: each bucket's phases, in the order they start
ENCODE_SCOPE = "dl4j_bucket{b}_encode"
EXCHANGE_SCOPE = "dl4j_bucket{b}_exchange"
WAIT_SCOPE = "dl4j_bucket{b}_wait"


def _leaves(tree, path=""):
    """[(path, leaf)] of a tree of dicts (keys sorted) and lists, or of a
    flat {"/path": leaf} dict as `sharded_trainer._paths` makes it (its
    order kept)."""
    if isinstance(tree, dict) and not path and tree and all(
            isinstance(k, str) and k.startswith("/") for k in tree):
        return list(tree.items())
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _dtype_name(leaf):
    dt = getattr(leaf, "dtype", np.float32)
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def _itemsize(name):
    return torch.empty((), dtype=getattr(torch, name)).element_size()


class BucketPlan:
    """Host-side plan: which leaf goes to which bucket.

    Attributes: `paths` (each leaf's path, in tree order), `shapes`,
    `dtypes` (torch dtypes), `buckets` (tuples of leaf indices, tree
    order inside each bucket), `bucket_elems`, `bucket_bytes`,
    `total_bytes`, `num_buckets`."""

    def __init__(self, paths, shapes, dtypes, buckets):
        self.paths = tuple(paths)
        self.shapes = tuple(tuple(s) for s in shapes)
        self.dtype_names = tuple(dtypes)
        self.dtypes = tuple(getattr(torch, d) for d in dtypes)
        self.buckets = tuple(tuple(b) for b in buckets)
        self.num_buckets = len(self.buckets)
        sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.leaf_sizes = tuple(sizes)
        self.bucket_elems = tuple(sum(sizes[i] for i in b)
                                  for b in self.buckets)
        self.bucket_bytes = tuple(
            sum(sizes[i] * _itemsize(self.dtype_names[i]) for i in b)
            for b in self.buckets)
        self.total_bytes = sum(self.bucket_bytes)

    def bucket_dtype(self, b):
        return self.dtypes[self.buckets[b][0]]

    def concat(self, tree):
        """Tree (or {path: tensor}) -> [one flat 1-D tensor per bucket]
        in plan order; a one-leaf bucket is a view of its leaf."""
        leaves = dict(_leaves(tree))    # by path: the tree's own order
        out = []                        # may differ from the plan's
        for b in self.buckets:
            flats = [leaves[self.paths[i]].reshape(-1) for i in b]
            out.append(flats[0] if len(flats) == 1 else torch.cat(flats))
        return out

    def split(self, flats):
        """[flat per bucket] -> {path: tensor} (inverse of `concat`)."""
        out = {}
        for b, flat in zip(self.buckets, flats):
            off = 0
            for i in b:
                n = self.leaf_sizes[i]
                out[self.paths[i]] = flat[off:off + n].reshape(
                    self.shapes[i])
                off += n
        return {p: out[p] for p in self.paths}

    def describe(self):
        """Host-side summary for telemetry / GET /health."""
        return {"num_buckets": self.num_buckets,
                "bucket_bytes": list(self.bucket_bytes),
                "total_bytes": self.total_bytes,
                "leaves": len(self.shapes)}


def plan_buckets(tree, num_buckets=None, bucket_bytes=None):
    """Byte-balanced partition of `tree`'s leaves into buckets, as the
    JAX package plans it: greedy LPT (largest leaf into the lightest
    bucket) per dtype group, a bucket never mixing dtypes, each group
    getting buckets in proportion to its byte share (at least one);
    `bucket_bytes` instead of `num_buckets` derives the count as
    ceil(total / target). Deterministic for a given tree structure."""
    flat = _leaves(tree)
    if not flat:
        raise ValueError("plan_buckets: empty tree")
    paths = [p for p, _ in flat]
    shapes = [tuple(getattr(l, "shape", ())) for _, l in flat]
    dtypes = [_dtype_name(l) for _, l in flat]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    nbytes = [sizes[i] * _itemsize(dtypes[i]) for i in range(len(flat))]
    total = sum(nbytes)
    if bucket_bytes is not None:
        if num_buckets is not None:
            raise ValueError("pass num_buckets OR bucket_bytes, not both")
        num_buckets = max(1, -(-total // int(bucket_bytes)))
    elif num_buckets is None:
        num_buckets = DEFAULT_NUM_BUCKETS
    num_buckets = max(1, min(int(num_buckets), len(flat)))

    groups = {}
    for i, dt in enumerate(dtypes):
        groups.setdefault(dt, []).append(i)
    ordered = sorted(groups.items(),
                     key=lambda kv: (-sum(nbytes[i] for i in kv[1]),
                                     kv[0]))
    counts = []
    remaining = max(num_buckets, len(ordered))
    for gi, (_, idxs) in enumerate(ordered):
        left = len(ordered) - gi - 1
        share = sum(nbytes[i] for i in idxs) / max(total, 1)
        want = max(1, min(len(idxs), round(share * num_buckets),
                          remaining - left))
        counts.append(want)
        remaining -= want

    buckets = []
    for (_, idxs), k in zip(ordered, counts):
        k = min(k, len(idxs))
        loads = [0] * k
        members = [[] for _ in range(k)]
        for i in sorted(idxs, key=lambda i: (-nbytes[i], i)):  # LPT
            b = min(range(k), key=lambda j: (loads[j], j))
            loads[b] += nbytes[i]
            members[b].append(i)
        buckets.extend(sorted(m) for m in members)
    buckets.sort(key=lambda b: b[0])
    return BucketPlan(paths, shapes, dtypes, buckets)


def check_overlap_structure(order, num_buckets, require_async=False):
    """Structural proof, on the phase order a step recorded (a sequence of
    the scope names, or of (name, ...) tuples, in start order), that the
    bucketed exchange is overlapped:

    1. exactly `num_buckets` bucket collectives were issued (one
       `dl4j_bucket{k}_exchange` each: the monolithic all-reduce really
       was split);
    2. for every k >= 1, bucket k's encode starts AFTER bucket k-1's
       collective was issued, never "all encodes first, then all
       collectives".

    `require_async=True` additionally demands that bucket k-1's wait
    comes after bucket k's encode started (the collective was in flight
    while the next bucket encoded). Returns a list of violations (empty
    == pass)."""
    names = [o[0] if isinstance(o, (tuple, list)) else str(o)
             for o in order]
    if not names:
        return ["no exchange phases recorded"]
    coll_pos, enc_pos, wait_pos = {}, {}, {}
    issued = {b: 0 for b in range(num_buckets)}
    for idx, name in enumerate(names):
        for b in range(num_buckets):
            if name == EXCHANGE_SCOPE.format(b=b):
                issued[b] += 1
                coll_pos.setdefault(b, idx)
            elif name == ENCODE_SCOPE.format(b=b):
                enc_pos.setdefault(b, idx)
            elif name == WAIT_SCOPE.format(b=b):
                wait_pos.setdefault(b, idx)
    problems = []
    missing = [b for b in range(num_buckets) if b not in coll_pos]
    if missing:
        problems.append(f"expected one collective per bucket, none found "
                        f"for buckets {missing}")
        return problems
    extra = [b for b, n in issued.items() if n != 1]
    if extra:
        problems.append(f"buckets {extra} issued more than one collective")
    stray = [n for n in names if n.startswith("dl4j_bucket")
             and int(n[len("dl4j_bucket"):].split("_")[0]) >= num_buckets]
    if stray:
        problems.append(f"{len(stray)} phases of buckets beyond "
                        f"{num_buckets - 1}: the plan has more buckets")
    for b in range(1, num_buckets):
        e = enc_pos.get(b, coll_pos[b])
        if e <= coll_pos[b - 1]:
            problems.append(
                f"bucket {b}'s encode (position {e}) starts before bucket "
                f"{b - 1}'s collective (position {coll_pos[b - 1]}) — the "
                f"exchange is serialized after all compute")
        if require_async and wait_pos.get(b - 1, -1) < e:
            problems.append(
                f"bucket {b - 1}'s collective was waited on (position "
                f"{wait_pos.get(b - 1)}) before bucket {b}'s encode "
                f"(position {e}) — nothing was in flight")
    return problems

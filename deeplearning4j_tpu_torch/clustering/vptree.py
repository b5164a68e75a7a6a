"""Vantage-point tree kNN: the port of
`deeplearning4j_tpu/clustering/vptree.py` (≡ deeplearning4j-nearestneighbors
:: org.deeplearning4j.clustering.vptree.VPTree + sptree.DataPoint).

Reference shape: ``new VPTree(items, "euclidean", invert)`` builds a
metric tree on the JVM; ``search(target, k, results, distances)`` fills
result lists by branch-and-bound traversal.

Two paths here:

- ``VPTree`` — API-parity host-side tree (numpy, a copy of the JAX
  package's): median-split vantage-point construction,
  triangle-inequality pruned search. Useful when single queries trickle
  in on the host.
- ``knn(queries, items, k)`` — exact and batched on the device: a
  (Q, N) distance GEMM (``torch.matmul``) + ``torch.topk``, in blocks of
  query rows so one block's distance matrix stays near 1 GiB. This is
  what ``NearestNeighborsServer`` serves from.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.kmeans import _pairwise
from deeplearning4j_tpu_torch.device import resolve

__all__ = ["DataPoint", "VPTree", "knn"]

#: elements of one query block's (rows, N) distance matrix
_KNN_BLOCK_ELEMS = 1 << 28


class DataPoint:
    """≡ clustering.sptree.DataPoint (index + vector)."""

    def __init__(self, index, point):
        self.index = int(index)
        self.point = np.asarray(point, np.float32).reshape(-1)

    def getIndex(self):
        return self.index

    def getPoint(self):
        return self.point


def _dist_np(x, items, fn):
    if fn == "euclidean":
        return np.sqrt(np.maximum(((items - x) ** 2).sum(-1), 0.0))
    if fn == "manhattan":
        return np.abs(items - x).sum(-1)
    if fn == "cosinesimilarity":
        xn = x / max(np.linalg.norm(x), 1e-12)
        it = items / np.maximum(
            np.linalg.norm(items, axis=-1, keepdims=True), 1e-12)
        return 1.0 - it @ xn
    if fn == "dot":
        return -(items @ x)
    raise ValueError(f"unknown similarity function: {fn!r}")


def _knn_device(queries, items, k, fn):
    d = _pairwise(queries, items, fn)   # shared with kmeans — one impl
    neg, idx = torch.topk(-d, k, dim=-1)
    return idx, -neg


def knn(queries, items, k, similarity_function="euclidean", device=None):
    """Batched exact kNN on `device` (the card unless "cpu"): returns
    (indices (Q,k), distances (Q,k)) as numpy. One GEMM + top-k per block
    of query rows; no tree needed. Tensors already on a device stay
    there."""
    dev = (queries.device if torch.is_tensor(queries) and device is None
           else resolve(device))
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    if q.ndim == 1:
        q = q[None, :]
    it = torch.as_tensor(items, dtype=torch.float32, device=dev)
    k = min(int(k), it.shape[0])
    fn = str(similarity_function).lower()
    rows = max(1, _KNN_BLOCK_ELEMS // max(1, it.shape[0]))
    idx, dist = [], []
    for r0 in range(0, q.shape[0], rows):
        i, d = _knn_device(q[r0:r0 + rows], it, k, fn)
        idx.append(i)
        dist.append(d)
    return (torch.cat(idx).cpu().numpy(), torch.cat(dist).cpu().numpy())


class _Node:
    __slots__ = ("index", "threshold", "inside", "outside", "bucket")

    def __init__(self, index, threshold=0.0, inside=None, outside=None,
                 bucket=None):
        self.index = index
        self.threshold = threshold
        self.inside = inside
        self.outside = outside
        self.bucket = bucket  # leaf: indices scanned linearly at query


class VPTree:
    """≡ vptree.VPTree(items, similarityFunction, invert). ``invert``
    mirrors the reference flag for similarity (vs distance) functions —
    cosine/dot are already converted to distances internally, so invert
    only validates intent."""

    def __init__(self, items, similarity_function="euclidean", invert=False,
                 seed=123):
        if isinstance(items, (list, tuple)) and items and \
                isinstance(items[0], DataPoint):
            self.items = np.stack([p.point for p in items])
        else:
            self.items = np.asarray(items, np.float32)
        self.fn = str(similarity_function).lower()
        if invert and self.fn not in ("cosinesimilarity", "dot"):
            raise ValueError("invert=True expects a similarity function")
        # Tree search is only EXACT for true metrics — the branch-and-bound
        # pruning rule IS the triangle inequality (ADVICE r4). 'dot' has no
        # metric form: refuse it here (knn() below is the exact batched
        # path for it). 'cosinesimilarity' (1-cos) is not a metric either,
        # but chord distance ||x̂-ŷ|| on the unit sphere is, and it ranks
        # identically (chord² = 2·(1-cos)): the tree internally uses
        # euclidean over normalized vectors and converts reported
        # distances back to the 1-cos form.
        if self.fn == "dot":
            raise ValueError(
                "VPTree: 'dot' is not a metric, so tree pruning would "
                "return inexact neighbors — use clustering.vptree.knn() "
                "(exact batched GEMM + top-k) for dot-product similarity")
        if self.fn == "cosinesimilarity":
            self._tree_items = self.items / np.maximum(
                np.linalg.norm(self.items, axis=-1, keepdims=True), 1e-12)
            self._tree_fn = "euclidean"
        else:
            self._tree_items = self.items
            self._tree_fn = self.fn
        self._rng = np.random.RandomState(seed)
        self._root = self._build(list(range(self.items.shape[0])))

    def _build(self, idxs):
        if not idxs:
            return None
        if len(idxs) == 1:
            return _Node(idxs[0])
        vp = idxs[self._rng.randint(len(idxs))]
        rest = [i for i in idxs if i != vp]
        d = _dist_np(self._tree_items[vp], self._tree_items[rest],
                     self._tree_fn)
        med = float(np.median(d))
        inside = [rest[i] for i in range(len(rest)) if d[i] < med]
        outside = [rest[i] for i in range(len(rest)) if d[i] >= med]
        if not inside or not outside:
            # degenerate split (all points on the median, e.g. duplicates):
            # recursing with only the vp removed would be O(N)-deep, so
            # store the rest as a flat leaf bucket scanned at query time
            return _Node(vp, bucket=rest)
        return _Node(vp, med, self._build(inside), self._build(outside))

    def search(self, target, k, results=None, distances=None):
        """≡ VPTree.search: fills `results` (DataPoint) and `distances`
        lists, nearest first; also returns (results, distances)."""
        target = np.asarray(target, np.float32).reshape(-1)
        if self.fn == "cosinesimilarity":   # search in the metric space
            target = target / max(np.linalg.norm(target), 1e-12)
        k = min(int(k), self.items.shape[0])
        # best-first branch-and-bound with a simple max-heap of size k
        import heapq
        heap = []  # (-distance, index)

        def consider(idx, d):
            if len(heap) < k:
                heapq.heappush(heap, (-d, idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, idx))

        def visit(node):
            if node is None:
                return
            d = float(_dist_np(target, self._tree_items[node.index][None, :],
                               self._tree_fn)[0])
            consider(node.index, d)
            if node.bucket is not None:  # degenerate leaf: vectorized scan
                ds = _dist_np(target, self._tree_items[node.bucket],
                              self._tree_fn)
                for i, bd in zip(node.bucket, ds):
                    consider(i, float(bd))
                return
            tau = -heap[0][0] if len(heap) == k else np.inf
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                visit(node.inside)
                if d + tau >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau <= node.threshold:
                    visit(node.inside)

        visit(self._root)
        order = sorted(((-nd, i) for nd, i in heap))
        if results is None:
            results = []
        if distances is None:
            distances = []
        for d, i in order:
            results.append(DataPoint(i, self.items[i]))
            # report in the caller's distance form: chord² = 2·(1-cos)
            distances.append(float(d * d / 2.0)
                             if self.fn == "cosinesimilarity" else float(d))
        return results, distances

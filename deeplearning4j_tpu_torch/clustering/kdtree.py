"""KD-tree: a copy of `deeplearning4j_tpu/clustering/kdtree.py`, which is
numpy only (≡ deeplearning4j-nearestneighbors ::
org.deeplearning4j.clustering.kdtree.KDTree).

Reference shape: ``new KDTree(dims)``, ``insert(INDArray)``,
``nn(INDArray)`` → (point, distance), ``knn(INDArray, k)``, and a
``delete`` the reference barely uses. Axis-cycling splits, branch-and-
bound search.

Host-side structure like VPTree (pointer-shaped); for batched/serving
queries prefer ``clustering.vptree.knn`` — one (Q, N) GEMM + top-k on
the card beats any tree walk at reference-era corpus sizes.
"""
from __future__ import annotations

import heapq

import numpy as np

__all__ = ["KDTree"]


class _KDNode:
    __slots__ = ("point", "left", "right")

    def __init__(self, point):
        self.point = point
        self.left = None
        self.right = None


class KDTree:
    def __init__(self, dims):
        self.dims = int(dims)
        self._root = None
        self._size = 0

    def size(self):
        return self._size

    def insert(self, point):
        p = np.asarray(point, np.float32).reshape(-1)
        if p.shape[0] != self.dims:
            raise ValueError(f"point has {p.shape[0]} dims, tree expects "
                             f"{self.dims}")
        self._size += 1
        if self._root is None:
            self._root = _KDNode(p)
            return
        node, depth = self._root, 0
        while True:
            axis = depth % self.dims
            side = "left" if p[axis] < node.point[axis] else "right"
            child = getattr(node, side)
            if child is None:
                setattr(node, side, _KDNode(p))
                return
            node, depth = child, depth + 1

    @staticmethod
    def _dist2(a, b):
        return float(((a - b) ** 2).sum())

    def nn(self, point):
        """Nearest neighbor: returns (point, distance)."""
        res = self.knn(point, 1)
        return res[0] if res else (None, float("inf"))

    def knn(self, point, k):
        """k nearest: [(point, distance)] sorted nearest-first."""
        q = np.asarray(point, np.float32).reshape(-1)
        if q.shape[0] != self.dims:
            raise ValueError(f"query has {q.shape[0]} dims, tree expects "
                             f"{self.dims}")
        k = min(int(k), self._size)
        if self._root is None or k <= 0:
            return []
        heap = []  # max-heap of (-squared_dist, counter, point)
        counter = 0
        # explicit stack (no recursion — a sorted-insert tree is O(n)
        # deep); `plane2` is the SQUARED split-plane distance that must
        # beat the current kth-best for the subtree to matter, re-checked
        # at pop time when tau is tightest. Comparisons stay in squared
        # space; sqrt only touches the final k results.
        stack = [(self._root, 0, None)]
        while stack:
            node, depth, plane2 = stack.pop()
            if node is None:
                continue
            tau2 = -heap[0][0] if len(heap) == k else float("inf")
            if plane2 is not None and plane2 > tau2:
                continue
            d2 = self._dist2(q, node.point)
            if len(heap) < k:
                heapq.heappush(heap, (-d2, counter, node.point))
                counter += 1
            elif d2 < -heap[0][0]:
                heapq.heapreplace(heap, (-d2, counter, node.point))
                counter += 1
            axis = depth % self.dims
            delta = float(q[axis] - node.point[axis])
            near, far = ((node.left, node.right) if delta < 0
                         else (node.right, node.left))
            stack.append((far, depth + 1, delta * delta))
            stack.append((near, depth + 1, None))   # popped first
        out = sorted(((-nd2, pt) for nd2, _, pt in heap), key=lambda t: t[0])
        return [(pt, float(np.sqrt(d2))) for d2, pt in out]

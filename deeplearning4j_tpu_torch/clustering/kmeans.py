"""KMeans clustering: the port of `deeplearning4j_tpu/clustering/kmeans.py`
(≡ deeplearning4j-clustering ::
org.deeplearning4j.clustering.kmeans.KMeansClustering +
cluster.Point/Cluster/ClusterSet/PointClassification).

Reference shape: ``KMeansClustering.setup(k, maxIter, distanceFn)`` →
``applyTo(List<Point>)`` → ``ClusterSet`` (iterative Lloyd refinement,
optionally ``useKmeansPlusPlus`` seeding).

The Lloyd loop runs on the device over whole tensors: the (N, K)
distance matrix is one ``X @ Cᵀ`` GEMM per iteration (‖x‖² − 2x·c + ‖c‖²
for euclidean), assignments an argmin, the new centers a one-hot GEMM;
no per-point host loop. The host reads one number per iteration, the
share of points that moved, to test convergence (the JAX package's
``lax.while_loop`` condition). k-means++ seeding is K device distance
updates, each index drawn with the port's threefry uniform.

Seeding draws: the JAX package seeds with ``jax.random.permutation`` /
``randint``; the port draws its permutation and first k-means++ index
from a ``torch.Generator`` seeded by the same threefry key, so the seeds
are deterministic but other points than the JAX package's. From the
same start the two Lloyd loops agree.

Convergence matches the reference's ``ClusteringStrategy`` surface:
either a fixed ``maxIterationCount`` or a ``minDistributionVariationRate``
(fraction of points that changed cluster between iterations).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.ops.random import (_unit, random_bits,
                                                 seed_key, split)

__all__ = ["Point", "Cluster", "ClusterSet", "PointClassification",
           "KMeansClustering"]


class Point:
    """≡ clustering.cluster.Point — an id/label-carrying vector."""

    def __init__(self, array, id=None, label=None):
        self.array = np.asarray(array, np.float32).reshape(-1)
        self.id = id
        self.label = label

    def getArray(self):
        return self.array

    def getId(self):
        return self.id

    def getLabel(self):
        return self.label

    @staticmethod
    def toPoints(matrix):
        """≡ Point.toPoints(INDArray): one Point per row."""
        m = np.asarray(matrix, np.float32)
        return [Point(row, id=str(i)) for i, row in enumerate(m)]


class Cluster:
    def __init__(self, id, center):
        self.id = id
        self._center = np.asarray(center, np.float32)
        self._points = []

    def getCenter(self):
        return self._center

    def getPoints(self):
        return self._points

    def getId(self):
        return self.id

    def addPoint(self, point):
        self._points.append(point)


class PointClassification:
    """≡ cluster.PointClassification (cluster, distance, moved-flag)."""

    def __init__(self, cluster, distance, new_location):
        self._cluster = cluster
        self._distance = float(distance)
        self._new_location = bool(new_location)

    def getCluster(self):
        return self._cluster

    def getDistanceFromCenter(self):
        return self._distance

    def isNewLocation(self):
        return self._new_location


def _pairwise(x, c, distance):
    """(N, D) x (K, D) -> (N, K) distances; euclidean is one GEMM."""
    if distance in ("euclidean", "sqeuclidean"):
        x2 = torch.sum(x * x, -1, keepdim=True)          # (N, 1)
        c2 = torch.sum(c * c, -1)                        # (K,)
        d2 = torch.clamp(x2 - 2.0 * (x @ c.T) + c2, min=0.0)
        return d2 if distance == "sqeuclidean" else torch.sqrt(d2)
    if distance == "manhattan":
        return torch.cdist(x, c, p=1.0)
    if distance == "cosinesimilarity":  # distance = 1 - cosine
        xn = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                             min=1e-12)
        cn = c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True),
                             min=1e-12)
        return 1.0 - xn @ cn.T
    if distance == "dot":
        return -(x @ c.T)
    raise ValueError(f"unknown distance function: {distance!r}")


def _generator(key):
    """A CPU torch.Generator seeded by a threefry key's two words."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(key[0]) << 32 | int(key[1]))
    return g


def _choice(key, p):
    """≡ jax.random.choice(key, n, p=p) (with replacement): the inverse
    CDF at the threefry uniform of `key`, on p's device."""
    cuml = torch.cumsum(p, 0)
    u = _unit(random_bits(key, (), p.device))
    r = cuml[-1] * (1.0 - u)
    return torch.searchsorted(cuml, r.reshape(1)).reshape(())


def _kmeanspp_init(x, key, k, distance):
    """k-means++ seeding: K device distance updates (seeding always uses
    squared euclidean, as the reference)."""
    del distance
    n = x.shape[0]
    k0, key = split(key)
    first = int(torch.randint(0, n, (), generator=_generator(k0)))
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    d2 = _pairwise(x, centers[:1], "sqeuclidean")[:, 0]
    for i in range(1, k):
        key, sub = split(key)
        p = d2 / torch.clamp(d2.sum(), min=1e-12)
        idx = torch.clamp(_choice(sub, p), max=n - 1)
        row = x.index_select(0, idx.reshape(1))
        centers[i] = row[0]
        nd = _pairwise(x, row, "sqeuclidean")[:, 0]
        d2 = torch.minimum(d2, nd)
    return centers


def _lloyd(x, centers0, k, distance, max_iter, min_var):
    """Lloyd refinement from `centers0`; returns (centers, assign,
    iterations). Empty clusters keep their previous center (reference's
    allowEmptyClusters=True behavior; False is handled by the caller via
    farthest-point reseeding between convergence checks)."""

    def assign_of(c):
        return torch.argmin(_pairwise(x, c, distance), dim=-1)

    centers, assign = centers0, assign_of(centers0)
    it, changed = 0, 1.0
    while it < max_iter and changed > min_var:
        onehot = F.one_hot(assign, k).to(x.dtype)          # (N, K)
        counts = onehot.sum(0)                             # (K,)
        sums = onehot.T @ x                                # (K, D) GEMM
        new_centers = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp(counts[:, None], min=1.0), centers)
        new_assign = assign_of(new_centers)
        changed = float(torch.mean((new_assign != assign).to(torch.float32)))
        centers, assign, it = new_centers, new_assign, it + 1
    return centers, assign, it


class ClusterSet:
    def __init__(self, clusters, distance):
        self._clusters = clusters
        self._distance = distance

    def getClusters(self):
        return self._clusters

    def getClusterCount(self):
        return len(self._clusters)

    def classifyPoint(self, point):
        """≡ ClusterSet.classifyPoint: nearest cluster + distance."""
        arr = point.array if isinstance(point, Point) else \
            np.asarray(point, np.float32).reshape(-1)
        centers = np.stack([c.getCenter() for c in self._clusters])
        d = _pairwise(torch.as_tensor(arr[None, :]),
                      torch.as_tensor(centers), self._distance)[0].numpy()
        idx = int(d.argmin())
        return PointClassification(self._clusters[idx], d[idx], True)


class KMeansClustering:
    """≡ kmeans.KMeansClustering. Build via ``setup(...)``, run via
    ``applyTo(points)`` where points is a list[Point] or an (N, D) array;
    the loop runs on `device` (the card unless "cpu")."""

    def __init__(self, k, max_iter, distance, inverse=False,
                 min_distribution_variation_rate=0.0,
                 allow_empty_clusters=True, use_kmeans_plus_plus=False,
                 seed=123, device=None):
        self.k = int(k)
        self.max_iter = int(max_iter)
        # reference distance-function names are e.g. "euclidean",
        # "cosinesimilarity", "manhattan"; `inverse` marks similarity fns
        self.distance = str(distance).lower()
        if inverse and self.distance not in ("cosinesimilarity", "dot"):
            raise ValueError("inverse=True expects a similarity function")
        self.min_var = float(min_distribution_variation_rate)
        self.allow_empty = bool(allow_empty_clusters)
        self.use_pp = bool(use_kmeans_plus_plus)
        self.seed = int(seed)
        self.device = device
        self.iterations = None

    # -- reference factory surface --------------------------------------
    @staticmethod
    def setup(clusterCount, maxIterationCount=None, distanceFunction="euclidean",
              inverse=False, minDistributionVariationRate=None,
              allowEmptyClusters=True, useKMeansPlusPlus=False, seed=123,
              device=None):
        """≡ KMeansClustering.setup overloads: pass maxIterationCount for
        fixed-iteration mode, or minDistributionVariationRate for
        variation-converged mode (both is fine — first bound wins)."""
        if maxIterationCount is None and minDistributionVariationRate is None:
            raise ValueError("need maxIterationCount or "
                             "minDistributionVariationRate")
        return KMeansClustering(
            clusterCount,
            maxIterationCount if maxIterationCount is not None else 1000,
            distanceFunction, inverse=inverse,
            min_distribution_variation_rate=(
                minDistributionVariationRate or 0.0),
            allow_empty_clusters=allowEmptyClusters,
            use_kmeans_plus_plus=useKMeansPlusPlus, seed=seed,
            device=device)

    def initialCenters(self, x):
        """The seeding's (k, D) centers of device tensor `x`."""
        key = seed_key(self.seed)
        if self.use_pp:
            return _kmeanspp_init(x, key, self.k, self.distance)
        perm = torch.randperm(x.shape[0], generator=_generator(key))
        return x[perm[: self.k].to(x.device)]

    def applyTo(self, points):
        pts = points
        if isinstance(points, (list, tuple)):
            x_np = np.stack([p.array for p in points])
        else:
            x_np = np.asarray(points, np.float32)
            pts = None
        if x_np.shape[0] < self.k:
            raise ValueError(
                f"need >= k={self.k} points, got {x_np.shape[0]}")
        x = torch.as_tensor(x_np, device=resolve(self.device))
        centers, assign, self.iterations = _lloyd(
            x, self.initialCenters(x), self.k, self.distance,
            self.max_iter, self.min_var)
        if not self.allow_empty:
            # reseed any empty cluster at the globally farthest point and
            # re-refine; RE-CHECK because refinement can re-empty a
            # cluster. Bounded retries, then a forced reassignment that
            # guarantees the contract.
            for _ in range(3):
                assign_np = assign.cpu().numpy()
                counts = np.bincount(assign_np, minlength=self.k)
                if not (counts == 0).any():
                    break
                centers_np = centers.cpu().numpy()
                d = _pairwise(x, centers, self.distance).cpu().numpy()
                far = np.argsort(-d.min(-1))
                empties = np.flatnonzero(counts == 0)
                for j, ci in enumerate(empties):
                    centers_np[ci] = x_np[far[j]]
                centers, assign, _ = _lloyd(
                    x, torch.as_tensor(centers_np, device=x.device), self.k,
                    self.distance, self.max_iter, self.min_var)
            assign_np = assign.cpu().numpy()
            counts = np.bincount(assign_np, minlength=self.k)
            if (counts == 0).any():
                # forced repair: hand each empty cluster the point that is
                # farthest from its current center, taken from a cluster
                # that can spare one; centers become those points
                centers_np = centers.cpu().numpy()
                d = _pairwise(x, centers, self.distance).cpu().numpy()
                for ci in np.flatnonzero(counts == 0):
                    own = d[np.arange(len(assign_np)),
                            assign_np]            # dist to assigned center
                    donors = counts[assign_np] > 1
                    pick = int(np.argmax(np.where(donors, own, -np.inf)))
                    counts[assign_np[pick]] -= 1
                    assign_np[pick] = ci
                    counts[ci] = 1
                    centers_np[ci] = x_np[pick]
                centers = torch.as_tensor(centers_np)
                assign = torch.as_tensor(assign_np)
        centers_np = centers.cpu().numpy()
        assign_np = assign.cpu().numpy()
        clusters = [Cluster(i, centers_np[i]) for i in range(self.k)]
        if pts is None:
            pts = Point.toPoints(x_np)
        for p, a in zip(pts, assign_np):
            clusters[int(a)].addPoint(p)
        return ClusterSet(clusters, self.distance)

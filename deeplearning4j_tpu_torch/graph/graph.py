"""Graph structure + random walks (≡ deeplearning4j-graph ::
org.deeplearning4j.graph.graph.Graph, api.IGraph, api.Edge/Vertex,
iterator.RandomWalkIterator / WeightedRandomWalkIterator,
data.EdgeLineProcessor-style loading): a copy of
`deeplearning4j_tpu/graph/graph.py`.

Host-side adjacency structure (graph topology is pointer-shaped and
stays on the CPU, as the reference's does); what goes to the device is
the walk-id batches DeepWalk trains on (see
``deeplearning4j_tpu_torch.graph.deepwalk``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["Vertex", "Edge", "Graph", "RandomWalkIterator",
           "WeightedRandomWalkIterator"]


class Vertex:
    """≡ api.Vertex — index + arbitrary value."""

    def __init__(self, idx, value=None):
        self.idx = int(idx)
        self.value = value

    def vertexID(self):
        return self.idx

    def getValue(self):
        return self.value


class Edge:
    """≡ api.Edge — (from, to, value, directed)."""

    def __init__(self, from_idx, to_idx, value=None, directed=False):
        self.from_idx = int(from_idx)
        self.to_idx = int(to_idx)
        self.value = value
        self.directed = bool(directed)

    def getFrom(self):
        return self.from_idx

    def getTo(self):
        return self.to_idx


class Graph:
    """≡ graph.Graph(numVertices, allowMultipleEdges)."""

    def __init__(self, num_vertices, allow_multiple_edges=False,
                 vertices=None):
        self._n = int(num_vertices)
        self._allow_multi = bool(allow_multiple_edges)
        self._vertices = (vertices if vertices is not None
                          else [Vertex(i) for i in range(self._n)])
        self._adj = [[] for _ in range(self._n)]      # per-vertex [(to, w)]
        self._edges = []

    # -- mutation --------------------------------------------------------
    def addEdge(self, from_idx, to_idx, value=1.0, directed=False):
        f, t = int(from_idx), int(to_idx)
        if not (0 <= f < self._n and 0 <= t < self._n):
            raise ValueError(f"edge ({f},{t}) out of range [0,{self._n})")
        w = 1.0 if value is None else float(value)
        if not self._allow_multi:
            fwd = any(d == t for d, _ in self._adj[f])
            rev = f != t and any(d == f for d, _ in self._adj[t])
            if directed:
                if fwd:
                    return
            elif fwd or rev:
                # an undirected request over an existing directed edge
                # upgrades it: add only the missing reverse direction so
                # adjacency never holds a duplicate (t, w) entry
                if fwd and (rev or f == t):
                    return
                self._edges.append(Edge(f, t, w, directed))
                if not fwd:
                    self._adj[f].append((t, w))
                if not rev and f != t:
                    self._adj[t].append((f, w))
                return
        self._edges.append(Edge(f, t, w, directed))
        self._adj[f].append((t, w))
        if not directed and f != t:
            self._adj[t].append((f, w))

    # -- queries (IGraph surface) ---------------------------------------
    def numVertices(self):
        return self._n

    def numEdges(self):
        return len(self._edges)

    def getVertex(self, idx):
        return self._vertices[idx]

    def getVertexDegree(self, idx):
        return len(self._adj[idx])

    def getConnectedVertexIndices(self, idx):
        return np.array([t for t, _ in self._adj[idx]], np.int32)

    def getEdgesOut(self, idx):
        return list(self._adj[idx])

    @staticmethod
    def loadEdgeList(path, num_vertices, directed=False, delimiter=None,
                     weighted=False):
        """≡ data.GraphLoader.loadUndirectedGraphEdgeListFile: one
        "from to [weight]" line per edge; '#' comments skipped."""
        g = Graph(num_vertices)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                w = float(parts[2]) if weighted and len(parts) > 2 else 1.0
                g.addEdge(int(parts[0]), int(parts[1]), w, directed)
        return g


class RandomWalkIterator:
    """≡ iterator.RandomWalkIterator: uniform random walks of fixed
    length from each vertex in turn. ``next()`` returns an int32 array
    of vertex ids (walkLength + 1 entries; walks from isolated vertices
    stay in place, as the reference's NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)."""

    def __init__(self, graph, walk_length, seed=123):
        self.graph = graph
        self.walk_length = int(walk_length)
        self._rng = np.random.RandomState(seed)
        self._order = None
        self._pos = 0
        self.reset()

    def reset(self):
        self._order = self._rng.permutation(self.graph.numVertices())
        self._pos = 0

    def hasNext(self):
        return self._pos < len(self._order)

    def _step(self, v):
        nbrs = self.graph._adj[v]
        if not nbrs:
            return v
        return nbrs[self._rng.randint(len(nbrs))][0]

    def next(self):
        v = int(self._order[self._pos])
        self._pos += 1
        walk = [v]
        for _ in range(self.walk_length):
            v = self._step(v)
            walk.append(v)
        return np.array(walk, np.int32)


class WeightedRandomWalkIterator(RandomWalkIterator):
    """≡ iterator.WeightedRandomWalkIterator: transition probability
    proportional to edge weight."""

    def _step(self, v):
        nbrs = self.graph._adj[v]
        if not nbrs:
            return v
        ws = np.array([w for _, w in nbrs], np.float64)
        p = ws / ws.sum()
        return nbrs[self._rng.choice(len(nbrs), p=p)][0]

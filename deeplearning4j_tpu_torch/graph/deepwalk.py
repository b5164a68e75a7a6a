"""DeepWalk vertex embeddings: the port of
`deeplearning4j_tpu/graph/deepwalk.py` (≡ deeplearning4j-graph ::
org.deeplearning4j.graph.models.deepwalk.DeepWalk + GraphVectors).

Reference shape: random walks over the graph feed a skip-gram model;
the reference trains it with hierarchical softmax over a Huffman tree
built from vertex-visit frequencies (``GraphHuffman``), updating one
pair at a time on the JVM.

As in the JAX package, walks are generated host-side into (center,
context) batches and trained with the same skip-gram negative-sampling
step the Word2Vec module uses (``nlp.word2vec._sgns_step``, on the
device: the card unless the builder's ``device("cpu")``), with
degree^0.75 negatives drawn per batch from ``RandomState(seed + 1)``.
The starting tables come from numpy's ``RandomState(seed)``, so they and
the walks equal the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.graph.graph import RandomWalkIterator
from deeplearning4j_tpu_torch.nlp.word2vec import (_drop_host_copies,
                                                   _host_copy, _sgns_step)

__all__ = ["DeepWalk", "GraphVectors", "GraphVectorsSerializer"]


class GraphVectors:
    """Lookup surface (≡ models.embeddings.GraphVectors), in numpy on a
    host copy of syn0 taken once and reused until the tables change."""

    def _syn0(self):
        return _host_copy(self, "syn0", lambda: self.params["syn0"])

    def getVertexVector(self, idx):
        return self._syn0()[int(idx)]

    def numVertices(self):
        return int(self.params["syn0"].shape[0])

    def getVectorSize(self):
        return int(self.params["syn0"].shape[1])

    def similarity(self, v1, v2):
        a, b = self.getVertexVector(v1), self.getVertexVector(v2)
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 0.0
        return float(a @ b / (na * nb))

    def verticesNearest(self, idx, top=5):
        tab = self._syn0()
        v = tab[int(idx)]
        sims = tab @ v / np.maximum(
            np.linalg.norm(tab, axis=1) * max(np.linalg.norm(v), 1e-12),
            1e-12)
        order = [i for i in np.argsort(-sims) if i != int(idx)]
        return np.array(order[:top], np.int32)


class DeepWalk(GraphVectors):
    class Builder:
        def __init__(self):
            self._window = 4
            self._vector_size = 100
            self._lr = 0.025
            self._seed = 123
            self._negative = 5
            self._batch = 1024
            self._epochs = 1
            self._device = None

        def windowSize(self, v):
            self._window = int(v); return self

        def vectorSize(self, v):
            self._vector_size = int(v); return self

        def learningRate(self, v):
            self._lr = float(v); return self

        def seed(self, v):
            self._seed = int(v); return self

        def negativeSample(self, v):
            self._negative = int(v); return self

        def batchSize(self, v):
            self._batch = int(v); return self

        def epochs(self, v):
            self._epochs = int(v); return self

        def device(self, device):
            """Where the tables live and the steps run: the card unless
            "cpu" (resolved at `initialize`)."""
            self._device = device; return self

        def build(self):
            return DeepWalk(self)

    def __init__(self, b):
        self.b = b
        self.params = None
        self._neg_table = None

    def initialize(self, graph):
        """≡ DeepWalk.initialize(IGraph): allocate tables."""
        dev = resolve(self.b._device)
        n = graph.numVertices()
        rng = np.random.RandomState(self.b._seed)
        d = self.b._vector_size
        self.params = {
            "syn0": torch.from_numpy(
                (rng.rand(n, d).astype(np.float32) - 0.5) / d).to(dev),
            "syn1": torch.zeros((n, d), dtype=torch.float32, device=dev),
        }
        deg = np.array([max(graph.getVertexDegree(i), 1) for i in range(n)],
                       np.float64) ** 0.75
        self._neg_table = (deg / deg.sum()).astype(np.float64)
        _drop_host_copies(self)

    def _walk_pairs(self, it):
        """(centers, contexts) of every walk of `it` (host side)."""
        it.reset()
        centers, contexts = [], []
        while it.hasNext():
            walk = it.next()
            for i, c in enumerate(walk):
                lo = max(0, i - self.b._window)
                hi = min(len(walk), i + self.b._window + 1)
                for j in range(lo, hi):
                    if j != i:
                        centers.append(c)
                        contexts.append(walk[j])
        return np.array(centers, np.int32), np.array(contexts, np.int32)

    def fit(self, graph_or_iter, walk_length=None):
        """≡ fit(IGraph, walkLength) or fit(GraphWalkIterator)."""
        if walk_length is not None:
            it = RandomWalkIterator(graph_or_iter, walk_length,
                                    seed=self.b._seed)
            graph = graph_or_iter
        else:
            it = graph_or_iter
            graph = it.graph
        if self.params is None:
            self.initialize(graph)
        dev = self.params["syn0"].device
        rng = np.random.RandomState(self.b._seed + 1)
        for _ in range(self.b._epochs):
            centers, contexts = self._walk_pairs(it)
            order = rng.permutation(len(centers))
            centers, contexts = centers[order], contexts[order]
            bsz, k = self.b._batch, self.b._negative
            n_vocab = len(self._neg_table)
            for s in range(0, len(centers), bsz):
                c = centers[s:s + bsz]
                t = contexts[s:s + bsz]
                m = len(c)
                if m < bsz:  # pad to the batch shape, mask the tail
                    c = np.pad(c, (0, bsz - m))
                    t = np.pad(t, (0, bsz - m))
                negs = rng.choice(n_vocab, size=(bsz, k),
                                  p=self._neg_table)
                w = np.zeros(bsz, np.float32)
                w[:m] = 1.0
                _sgns_step(self.params, self.b._lr,
                           *(torch.from_numpy(a.astype(np.int64)).to(dev)
                             for a in (c, t, negs)),
                           torch.from_numpy(w).to(dev))
        _drop_host_copies(self)
        return self


class GraphVectorsSerializer:
    """≡ deeplearning4j-graph :: models.embeddings.GraphVectorsSerializer.
    Vertex embeddings in word2vec C format with vertex ids as the words —
    interoperable with WordVectorSerializer/loadStaticModel tooling."""

    @staticmethod
    def writeGraphVectors(deepwalk, path, binary=False):
        from deeplearning4j_tpu_torch.nlp.serializer import (
            StaticWordVectors, WordVectorSerializer)
        table = deepwalk._syn0()
        shim = StaticWordVectors(table,
                                 [str(i) for i in range(table.shape[0])])
        WordVectorSerializer.writeWord2VecModel(shim, path, binary=binary)

    @staticmethod
    def readGraphVectors(path, binary=None):
        """Returns a GraphVectors with vertex i at table row i. The file
        must use contiguous integer vertex ids as its words."""
        from deeplearning4j_tpu_torch.nlp.serializer import (
            WordVectorSerializer)
        sv = WordVectorSerializer.readWord2VecModel(path, binary=binary)
        table = np.asarray(sv._table(), np.float32)
        order = []
        for i in range(table.shape[0]):
            idx = sv.vocab.indexOf(str(i))
            if idx < 0:
                raise ValueError(
                    f"not a graph-vectors file: vertex id {i} missing "
                    f"(words must be the contiguous ids 0..{table.shape[0] - 1})")
            order.append(idx)
        gv = GraphVectors()
        gv.params = {"syn0": table[order]}
        return gv

"""The port's graph/ (`deeplearning4j_tpu_torch/graph/`) against the JAX
package's, on the CPU: the graph structure and its edge cases, random
walks (uniform and weighted) equal bit for bit, DeepWalk's starting
tables equal bit for bit and its whole fit within FIT_RTOL (neighbour
lists equal where the cosine margin exceeds NEAREST_MARGIN), the JAX
tests' community contracts, graph-vectors files across packages, and the
`unsupervised_analysis` example twin."""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as J
import deeplearning4j_tpu_torch.graph as T
from deeplearning4j_tpu.nlp.serializer import (
    StaticWordVectors as JStatic, WordVectorSerializer as JSerializer)

#: tables after a whole small fit, relative to the largest entry
FIT_RTOL = 1e-4
#: neighbours closer than this in cosine are ties
NEAREST_MARGIN = 1e-4


def _barbell(mod, k=6):
    """Two k-cliques joined by a single bridge edge."""
    g = mod.Graph(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.addEdge(base + i, base + j)
    g.addEdge(k - 1, k)
    return g


def _weighted(mod):
    g = mod.Graph(5)
    for f, t, w in ((0, 1, 10.0), (0, 2, 1.0), (1, 2, 3.0), (2, 3, 0.5),
                    (3, 4, 2.0)):
        g.addEdge(f, t, w)
    return g


def _deepwalk(mod, **kw):
    b = mod.DeepWalk.Builder()
    for k, v in kw.items():
        b = getattr(b, k)(v)
    if mod is T:
        b = b.device("cpu")
    return b.build()


def test_graph_structure_equal():
    ops = [(0, 1, 1.0, False), (1, 0, 2.0, False), (2, 3, 1.0, True),
           (3, 2, 1.0, False), (2, 3, 5.0, True), (4, 4, 1.0, False),
           (1, 4, None, True)]
    for multi in (False, True):
        gs = []
        for mod in (J, T):
            g = mod.Graph(5, allow_multiple_edges=multi)
            for f, t, w, d in ops:
                g.addEdge(f, t, w, directed=d)
            gs.append(g)
        a, b = gs
        assert a._adj == b._adj and a.numEdges() == b.numEdges()
        for v in range(5):
            assert a.getVertexDegree(v) == b.getVertexDegree(v)
            np.testing.assert_array_equal(a.getConnectedVertexIndices(v),
                                          b.getConnectedVertexIndices(v))
    with pytest.raises(ValueError, match="out of range"):
        T.Graph(3).addEdge(0, 3)


def test_load_edge_list_equal(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text("# comment\n0 1 2.5\n1 2\n\n2 3 0.5\n3 0\n")
    for weighted in (False, True):
        a = J.Graph.loadEdgeList(str(p), 4, weighted=weighted)
        b = T.Graph.loadEdgeList(str(p), 4, weighted=weighted)
        assert a._adj == b._adj


@pytest.mark.parametrize("kind", ["uniform", "weighted"])
def test_random_walks_equal(kind):
    walks = []
    for mod in (J, T):
        g = _barbell(mod) if kind == "uniform" else _weighted(mod)
        g.addEdge(0, 0) if kind == "uniform" else None
        it = (mod.RandomWalkIterator(g, 9, seed=4) if kind == "uniform"
              else mod.WeightedRandomWalkIterator(g, 9, seed=4))
        got = []
        for _ in range(3):               # reset draws a new order
            it.reset()
            while it.hasNext():
                got.append(it.next())
        walks.append(got)
    assert len(walks[0]) == len(walks[1]) > 10
    for a, b in zip(*walks):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    g = T.Graph(3)
    g.addEdge(0, 1)
    it = T.RandomWalkIterator(g, 4, seed=0)
    while it.hasNext():
        w = it.next()
        if w[0] == 2:
            assert (w == 2).all()       # isolated vertex stays in place


def test_deepwalk_initial_tables_and_pairs_equal():
    pair = []
    for mod in (J, T):
        dw = _deepwalk(mod, vectorSize=16, windowSize=3, seed=11)
        g = _barbell(mod)
        dw.initialize(g)
        pair.append((dw, g))
    (j, jg), (t, tg) = pair
    np.testing.assert_array_equal(t.params["syn0"].numpy(),
                                  np.asarray(j.params["syn0"]))
    np.testing.assert_array_equal(t._neg_table, j._neg_table)
    c, x = t._walk_pairs(T.RandomWalkIterator(tg, 12, seed=3))
    it = J.RandomWalkIterator(jg, 12, seed=3)
    it.reset()                           # as the JAX package's fit does
    centers, contexts = [], []
    while it.hasNext():
        walk = it.next()
        for i, v in enumerate(walk):
            for k in range(max(0, i - 3), min(len(walk), i + 4)):
                if k != i:
                    centers.append(v)
                    contexts.append(walk[k])
    np.testing.assert_array_equal(c, np.array(centers, np.int32))
    np.testing.assert_array_equal(x, np.array(contexts, np.int32))


@pytest.fixture(scope="module")
def fitted():
    kw = dict(vectorSize=16, windowSize=3, learningRate=0.01, epochs=50,
              batchSize=256, seed=11)
    return tuple(_deepwalk(mod, **kw).fit(_barbell(mod), walk_length=12)
                 for mod in (J, T))


def test_deepwalk_fit_matches_the_jax_package(fitted):
    j, t = fitted
    for k in ("syn0", "syn1"):
        a, b = t.params[k].numpy(), np.asarray(j.params[k])
        assert np.abs(a - b).max() <= FIT_RTOL * np.abs(b).max()
    for v in (0, 5, 6, 11):
        got, want = t.verticesNearest(v, top=4), j.verticesNearest(v, top=5)
        sims = [j.similarity(v, int(u)) for u in want]
        for k in range(4):
            if sims[k] - sims[k + 1] <= NEAREST_MARGIN:
                break
            assert got[k] == want[k]


def test_deepwalk_communities_embed_closer(fitted):
    _, dw = fitted
    assert dw.numVertices() == 12 and dw.getVectorSize() == 16
    intra, inter = [], []
    for i in range(12):
        for j in range(i + 1, 12):
            (intra if (i < 6) == (j < 6) else inter).append(
                dw.similarity(i, j))
    assert np.mean(intra) > np.mean(inter) + 0.1
    g = _barbell(T)
    near = (_deepwalk(T, vectorSize=16, windowSize=3, learningRate=0.01,
                      epochs=50, batchSize=256, seed=4)
            .fit(g, walk_length=12).verticesNearest(0, top=3))
    assert all(v < 6 for v in near)


def test_deepwalk_fit_from_an_iterator_matches():
    j = _deepwalk(J, vectorSize=8, epochs=2, seed=1).fit(
        J.RandomWalkIterator(_barbell(J), walk_length=8, seed=2))
    t = _deepwalk(T, vectorSize=8, epochs=2, seed=1).fit(
        T.RandomWalkIterator(_barbell(T), walk_length=8, seed=2))
    assert t.getVertexVector(0).shape == (8,)
    b = np.asarray(j.params["syn0"])
    assert np.abs(t.params["syn0"].numpy() - b).max() <= \
        FIT_RTOL * np.abs(b).max()


@pytest.mark.parametrize("binary", [False, True])
def test_graph_vectors_files_read_back_in_either_package(fitted, tmp_path,
                                                         binary):
    j, t = fitted
    pj, pt = str(tmp_path / "j.gv"), str(tmp_path / "t.gv")
    J.GraphVectorsSerializer.writeGraphVectors(j, pj, binary=binary)
    T.GraphVectorsSerializer.writeGraphVectors(t, pt, binary=binary)
    for path, src, mine in ((pj, j, False), (pt, t, True)):
        back_t = T.GraphVectorsSerializer.readGraphVectors(path)
        back_j = J.GraphVectorsSerializer.readGraphVectors(path)
        assert back_t.numVertices() == 12 and back_t.getVectorSize() == 16
        np.testing.assert_array_equal(back_t.params["syn0"],
                                      np.asarray(back_j.params["syn0"]))
        want = (t.params["syn0"].numpy() if mine
                else np.asarray(src.params["syn0"]))
        if binary:
            np.testing.assert_array_equal(back_t.params["syn0"], want)
        else:
            np.testing.assert_allclose(back_t.params["syn0"], want,
                                       atol=1e-5)
        assert back_t.similarity(0, 1) == pytest.approx(
            back_j.similarity(0, 1), abs=1e-6)


def test_graph_vectors_reader_rejects_a_word_file(tmp_path):
    p = str(tmp_path / "words.txt")
    JSerializer.writeWord2VecModel(
        JStatic(np.eye(3, dtype=np.float32), ["0", "1", "cat"]), p)
    with pytest.raises(ValueError, match="vertex id 2 missing"):
        T.GraphVectorsSerializer.readGraphVectors(p)


def test_unsupervised_analysis_twin():
    from deeplearning4j_tpu_torch.examples import unsupervised_analysis
    out = unsupervised_analysis.main(device="cpu")
    assert sorted(out["cluster_sizes"]) == [60, 60, 60]
    np.testing.assert_allclose(out["query_center"], [6, 6, 0, 0], atol=0.5)
    assert out["vptree_0"] == out["knn_0"] and out["knn_0"][0] == 0
    assert out["tsne_intra"] < out["tsne_inter"]
    assert out["dw_same"] > out["dw_across"]
    assert all(v < 8 for v in out["dw_nearest_0"])
    assert torch.isfinite(torch.tensor([out["dw_same"]])).all()

"""The port's clustering (`deeplearning4j_tpu_torch/clustering/`) against
the JAX package's, on the CPU.

- Lloyd from the same start: centers within LLOYD_RTOL, assignments and
  iteration counts equal, for each distance; `applyTo` from the JAX
  package's start (its `jax.random.permutation` seeding, which the port
  does not reproduce: see ROADMAP's differences) gives the same clusters,
  the empty-cluster repair included. The port's own seeding (random and
  k-means++) recovers separated blobs.
- `knn`, `VPTree.search` and `KDTree.knn` return the JAX package's indices
  exactly; distances within DIST_RTOL.
- t-SNE: the calibrated P rows within P_ATOL (one block and ragged blocks);
  the start equals `1e-4·jax.random.normal(PRNGKey(seed))` within 1e-10
  absolute (1e-6 of the draw); DESCENT_RTOL after one to three descent steps
  from the same start.
- `NearestNeighborsServer` answers as the JAX package's, in process and
  over loopback HTTP; `UIServer.attachTsne` embeds 3-D vectors.
"""
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import clustering as J
from deeplearning4j_tpu.clustering import kmeans as jkm
from deeplearning4j_tpu.clustering import tsne as jts
from deeplearning4j_tpu_torch import clustering as T
from deeplearning4j_tpu_torch.clustering import kmeans as tkm
from deeplearning4j_tpu_torch.clustering import tsne as tts
from deeplearning4j_tpu_torch.ops.random import normal, seed_key

#: Lloyd centers, port against JAX package from the same start: f32 GEMM
#: sums in another order, relative to max |center|
LLOYD_RTOL = 1e-5
#: knn / tree distances against the JAX package's (f32 GEMM sums)
DIST_RTOL = 1e-5
#: calibrated conditional P entries (each in [0, 1])
P_ATOL = 1e-5
#: the embedding after 3 descent steps (AdaGrad: 1) from the same start
#: and P, relative to max |y|. One step agrees to ~3e-7; the gains update
#: and AdaGrad's normalised step are sign-discontinuous, so f32 noise
#: grows by ~10× a step after that (5 steps: ~1e-4, AdaGrad ~5e-4)
DESCENT_RTOL = 1e-5


def _blobs(n_per=40, centers=((0, 0), (8, 8), (-8, 8)), seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    for i, c in enumerate(centers):
        xs.append(rng.randn(n_per, len(c)) * scale + np.asarray(c))
        ys.append(np.full(n_per, i))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def _wide_blobs(k=6, n_per=30, d=32, seed=1):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 4, (k, d))
    x = np.concatenate([m + rng.normal(0, 1, (n_per, d)) for m in means])
    return x.astype(np.float32), np.repeat(np.arange(k), n_per)


@pytest.mark.parametrize("distance", ["euclidean", "sqeuclidean",
                                      "manhattan", "cosinesimilarity",
                                      "dot"])
def test_lloyd_from_the_same_start_equals_the_jax_package(distance):
    x, _ = _wide_blobs()
    c0 = x[np.random.default_rng(2).choice(len(x), 6, replace=False)]
    jc, ja, jit = jkm._lloyd(jnp.asarray(x), jnp.asarray(c0), 6, distance,
                             25, 0.0)
    tc, ta, tit = tkm._lloyd(torch.as_tensor(x), torch.as_tensor(c0), 6,
                             distance, 25, 0.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert tit == int(jit)
    jc = np.asarray(jc)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0,
                               atol=LLOYD_RTOL * np.abs(jc).max())


@pytest.mark.parametrize("allow_empty", [True, False])
def test_apply_to_from_the_jax_start_equals_the_jax_package(allow_empty,
                                                            monkeypatch):
    x, _ = _blobs(seed=4)
    # duplicated points force empty clusters for the repair path
    x = np.concatenate([x, np.repeat(x[:1], 30, 0)]) if not allow_empty \
        else x
    k = 5 if not allow_empty else 3
    jk = J.KMeansClustering.setup(k, maxIterationCount=30,
                                  allowEmptyClusters=allow_empty, seed=9)
    tk = T.KMeansClustering.setup(k, maxIterationCount=30,
                                  allowEmptyClusters=allow_empty, seed=9,
                                  device="cpu")
    start = np.asarray(jnp.asarray(x)[
        jax.random.permutation(jax.random.PRNGKey(9), len(x))[:k]])
    monkeypatch.setattr(tk, "initialCenters",
                        lambda t: torch.as_tensor(start.copy()))
    jcs, tcs = jk.applyTo(x), tk.applyTo(x)
    for jcl, tcl in zip(jcs.getClusters(), tcs.getClusters()):
        assert [p.getId() for p in tcl.getPoints()] == \
            [p.getId() for p in jcl.getPoints()]
        np.testing.assert_allclose(tcl.getCenter(), jcl.getCenter(),
                                   rtol=0, atol=1e-5)
    pj, pt = (cs.classifyPoint([8.2, 7.9]) for cs in (jcs, tcs))
    assert pt.getCluster().getId() == pj.getCluster().getId()
    assert np.isclose(pt.getDistanceFromCenter(),
                      pj.getDistanceFromCenter(), atol=1e-5)


@pytest.mark.parametrize("pp", [False, True])
def test_the_ports_seeding_recovers_separated_blobs(pp):
    x, y = _blobs(seed=3)
    cs = T.KMeansClustering.setup(3, maxIterationCount=50,
                                  useKMeansPlusPlus=pp,
                                  device="cpu").applyTo(T.Point.toPoints(x))
    for cl in cs.getClusters():
        ids = [int(p.getId()) for p in cl.getPoints()]
        assert ids and len(set(y[ids])) == 1
    centers = sorted(tuple(np.round(c.getCenter()).astype(int))
                     for c in cs.getClusters())
    assert centers == [(-8, 8), (0, 0), (8, 8)]


def test_kmeanspp_choice_is_jax_random_choice():
    """The k-means++ index draw is jax.random.choice's inverse CDF at the
    same threefry uniform."""
    p = np.random.default_rng(0).random(50).astype(np.float32)
    p /= p.sum()
    for seed in range(20):
        want = int(jax.random.choice(jax.random.PRNGKey(seed), 50,
                                     p=jnp.asarray(p)))
        got = int(tkm._choice(seed_key(seed), torch.as_tensor(p)))
        assert got == want, seed


def test_kmeans_rejects_bad_args_like_the_jax_package():
    for P in (J, T):
        with pytest.raises(ValueError, match="need maxIterationCount"):
            P.KMeansClustering.setup(3)
        with pytest.raises(ValueError, match="inverse"):
            P.KMeansClustering.setup(3, 10, "euclidean", inverse=True)
    with pytest.raises(ValueError, match="need >= k"):
        T.KMeansClustering.setup(5, 10, device="cpu").applyTo(
            np.zeros((3, 2), np.float32))


@pytest.mark.parametrize("fn", ["euclidean", "manhattan",
                                "cosinesimilarity", "dot"])
def test_knn_equals_the_jax_package(fn):
    rng = np.random.default_rng(6)
    items = rng.normal(size=(300, 16)).astype(np.float32)
    q = rng.normal(size=(40, 16)).astype(np.float32)
    ji, jd = J.knn(q, items, 7, fn)
    ti, td = T.knn(q, items, 7, fn, device="cpu")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=DIST_RTOL)
    # query blocks of three rows give the same answers
    old = T.vptree._KNN_BLOCK_ELEMS
    try:
        T.vptree._KNN_BLOCK_ELEMS = 300 * 3
        bi, _ = T.knn(q, items, 7, fn, device="cpu")
    finally:
        T.vptree._KNN_BLOCK_ELEMS = old
    np.testing.assert_array_equal(bi, ji)


@pytest.mark.parametrize("fn", ["euclidean", "manhattan",
                                "cosinesimilarity"])
def test_vptree_search_equals_the_jax_package(fn):
    rng = np.random.default_rng(7)
    items = rng.normal(size=(200, 8)).astype(np.float32)
    jt, tt = J.VPTree(items, fn), T.VPTree(items, fn)
    for q in rng.normal(size=(10, 8)).astype(np.float32):
        jr, jd = jt.search(q, 6)
        tr, td = tt.search(q, 6)
        assert [r.getIndex() for r in tr] == [r.getIndex() for r in jr]
        np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=DIST_RTOL)
        ki, _ = T.knn(q, items, 6, fn, device="cpu")
        assert [r.getIndex() for r in tr] == list(ki[0])
    with pytest.raises(ValueError, match="not a metric"):
        T.VPTree(items, "dot")


def test_kdtree_equals_the_jax_package():
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(150, 3)).astype(np.float32)
    trees = [P.KDTree(3) for P in (J, T)]
    for p in pts:
        for t in trees:
            t.insert(p)
    for q in rng.normal(size=(12, 3)).astype(np.float32):
        jr, tr = trees[0].knn(q, 5), trees[1].knn(q, 5)
        for (jp, jd), (tp, td) in zip(jr, tr):
            np.testing.assert_array_equal(tp, jp)
            assert td == jd
        d = np.sqrt(((pts - q) ** 2).sum(-1))
        np.testing.assert_array_equal(np.stack([p for p, _ in tr]),
                                      pts[np.argsort(d)[:5]])
    assert trees[1].size() == 150 and trees[1].knn(pts[0], 0) == []


@pytest.mark.parametrize("n,block", [(45, 45), (45, 7)])
def test_tsne_p_rows_equal_the_jax_package(n, block):
    x, _ = _blobs(n_per=15, seed=9)
    x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-12)
    npad = -(-n // block) * block
    xp = np.pad(x, ((0, npad - n), (0, 0)))
    jp = np.asarray(jts._calibrated_p_rows(jnp.asarray(xp), 8.0, n, block))
    tp = tts._calibrated_p_rows(torch.as_tensor(xp), 8.0, n, block).numpy()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=P_ATOL)
    assert np.abs(tp[n:]).max(initial=0) == 0


def test_tsne_start_is_the_jax_draw():
    want = 1e-4 * np.asarray(jax.random.normal(jax.random.PRNGKey(42),
                                               (49, 2), jnp.float32))
    got = (1e-4 * normal(seed_key(42), (49, 2), "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("adagrad,block,steps", [(False, 45, 3),
                                                 (False, 7, 3),
                                                 (True, 45, 1)])
def test_tsne_descent_steps_equal_the_jax_package(adagrad, block, steps):
    x, _ = _blobs(n_per=15, seed=9)
    x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-12)
    n = 45
    npad = -(-n // block) * block
    xp = np.pad(x, ((0, npad - n), (0, 0)))
    p = np.asarray(jts._calibrated_p_rows(jnp.asarray(xp), 8.0, n, block))
    y0 = 1e-4 * np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                             (npad, 2)), np.float32)
    jy = np.asarray(jts._descend(jnp.asarray(p), jnp.asarray(y0), n, block,
                                 steps, 3, 3, jnp.float32(200.0),
                                 jnp.float32(0.5), jnp.float32(0.8),
                                 adagrad))
    ty = tts._descend(torch.as_tensor(p.copy()), torch.as_tensor(y0), n,
                      block, steps, 3, 3, 200.0, 0.5, 0.8, adagrad).numpy()
    np.testing.assert_allclose(ty, jy, rtol=0,
                               atol=DESCENT_RTOL * np.abs(jy).max())
    assert np.abs(ty[n:]).max(initial=0) == 0


def test_tsne_fit_preserves_blob_structure_and_saves(tmp_path):
    x, y = _blobs(n_per=15, seed=5)
    t = (T.BarnesHutTsne.Builder().setMaxIter(300).perplexity(10)
         .stopLyingIteration(100).setSwitchMomentumIteration(100)
         .seed(0).rowBlockSize(16).build())
    emb = t.fit(x, device="cpu").getData()
    assert emb.shape == (45, 2) and np.isfinite(emb).all()
    d = np.sqrt(((emb[:, None] - emb[None, :]) ** 2).sum(-1))
    assert d[y[:, None] == y[None, :]].mean() < \
        0.5 * d[y[:, None] != y[None, :]].mean()
    path = tmp_path / "tsne.txt"
    t.saveAsFile([str(v) for v in y], str(path))
    assert len(path.read_text().strip().splitlines()) == 45


def _servers(pts, **kw):
    return (J.NearestNeighborsServer(pts, **kw),
            T.NearestNeighborsServer(pts, device="cpu", **kw))


@pytest.mark.parametrize("tree", [False, True])
def test_nn_server_answers_equal_the_jax_package(tree):
    pts = np.random.RandomState(0).randn(50, 4).astype(np.float32)
    js, ts = _servers(pts, useVpTree=tree)
    for q in (3, -1, 17):
        assert [r["index"] for r in ts.query_index(q, 4)] == \
            [r["index"] for r in js.query_index(q, 4)]
    a, b = ts.query_vectors(pts[:3], 3), js.query_vectors(pts[:3], 3)
    assert [[r["index"] for r in row] for row in a] == \
        [[r["index"] for r in row] for row in b]
    # squared: a self-distance is f32 cancellation noise under the root
    np.testing.assert_allclose(
        np.square([[r["distance"] for r in row] for row in a]),
        np.square([[r["distance"] for r in row] for row in b]),
        rtol=0, atol=DIST_RTOL * float((pts ** 2).sum(-1).max()))
    with pytest.raises(IndexError):
        ts.query_index(50, 2)


def test_nn_server_http_answers_equal_the_jax_package():
    pts = np.random.RandomState(1).randn(60, 5).astype(np.float32)
    answers = []
    for srv in _servers(pts, port=0):
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"

            def post(path, payload):
                req = urllib.request.Request(
                    base + path, json.dumps(payload).encode(),
                    {"Content-Type": "application/json"})
                with urllib.request.urlopen(req) as r:
                    return json.loads(r.read())

            with urllib.request.urlopen(f"{base}/status") as r:
                status = json.loads(r.read())
            knn_res = post("/knn", {"index": 3, "k": 3})["results"]
            new = post("/knnnew", {"arr": pts[:2].tolist(), "k": 2})
            try:
                post("/knn", {"k": 2})
                code = 200
            except urllib.error.HTTPError as e:
                code = e.code
            answers.append((status, [r["index"] for r in knn_res],
                            [[r["index"] for r in row]
                             for row in new["results"]], code))
        finally:
            srv.stop()
    assert answers[1] == answers[0]
    assert answers[1][3] == 400


def test_ui_attach_tsne_embeds_three_dimensional_vectors():
    from deeplearning4j_tpu_torch.ui.server import UIServer
    ui = UIServer()
    x, y = _blobs(n_per=6, centers=((0, 0, 0), (9, 9, 9)), seed=2)
    ui.attachTsne(x, labels=[str(v) for v in y], maxIter=50,
                  perplexity=3.0, device="cpu")
    pts = np.asarray(ui._tsne["points"])
    assert pts.shape == (12, 2) and np.isfinite(pts).all()
    assert ui._tsne["labels"] == [str(v) for v in y]

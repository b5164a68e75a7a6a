"""The port's training listeners (optimize/listeners.py) and training
statistics (ui/stats.py, `render_static_html`, `UIServer`'s /stats) against
the JAX package's on the CPU: each listener rides the same training run in
both packages (the same seeded batches, the port's network on the JAX
network's parameters).

Tolerances: logged and collected scores 1e-5 relative to max(1, |JAX|);
update:parameter ratios 1e-4 relative (a mean of parameter differences,
each a difference of two nearly equal f32 values); counts, file names and
record keys exactly equal."""
import json
import os
import re
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                         InMemoryStatsStorage, StatsListener,
                                         UIServer, render_static_html)

from test_torch_multilayer import _close, _np_tree
from test_torch_transfer import J, T, _conf, _data, _iter, _pair

TOL = 1e-5
STEPS = 6


def _run(make_listeners, steps=STEPS, graph=False):
    """`steps` fit steps of the pair, each package's network carrying the
    listeners `make_listeners(P)` builds; returns {package: listeners}."""
    if graph:
        from test_torch_transfer import _graph_pair
        jnet, tnet = _graph_pair()
    else:
        jnet, tnet = _pair()
    out = {}
    for P, net in ((J, jnet), (T, tnet)):
        listeners = make_listeners(P)
        net.setListeners(*listeners)
        for i in range(steps):
            net.fit(_data(P, n=32, seed=i))
        out[P.root] = (listeners, net)
    return out[J.root], out[T.root]


def _floats(lines):
    return [float(re.findall(r"[-+0-9.e]+$", ln)[0]) for ln in lines]


def test_score_iteration_listener():
    logs = {}

    def make(P):
        logs[P.root] = []
        return [P.opt.ScoreIterationListener(2, log_fn=logs[P.root].append)]
    _run(make)
    jl, tl = logs[J.root], logs[T.root]
    assert len(tl) == len(jl) == STEPS // 2
    assert [ln.split(" is ")[0] for ln in tl] == \
        [ln.split(" is ")[0] for ln in jl]
    for a, b in zip(_floats(tl), _floats(jl)):
        _close(a, b, TOL, "logged score")


def test_collect_scores_listener():
    (jls, _), (tls, _) = _run(lambda P: [P.opt.CollectScoresListener(1)])
    js, ts = jls[0].scores, tls[0].scores
    assert [i for i, _ in ts] == [i for i, _ in js] == list(
        range(1, STEPS + 1))
    for (_, a), (_, b) in zip(ts, js):
        _close(a, float(b), TOL, "collected score")


def test_performance_and_time_listeners():
    logs = {}

    def make(P):
        logs[P.root] = {"perf": [], "time": []}
        return [P.opt.PerformanceListener(2, log_fn=logs[P.root]["perf"]
                                          .append),
                P.opt.TimeIterationListener(STEPS, frequency=2,
                                            log_fn=logs[P.root]["time"]
                                            .append)]
    (jls, _), (tls, _) = _run(make)
    for k in ("perf", "time"):
        assert len(logs[T.root][k]) == len(logs[J.root][k]) > 0
    assert tls[0].last_throughput > 0


def test_evaluative_listener():
    (jls, _), (tls, _) = _run(lambda P: [P.opt.EvaluativeListener(
        _iter(P), 3, log_fn=lambda s: None)])
    je, te = jls[0].last_evaluation, tls[0].last_evaluation
    assert te is not None
    assert te.accuracy() == pytest.approx(je.accuracy())
    assert te.f1() == pytest.approx(je.f1())


def test_checkpoint_listener(tmp_path):
    """Every 2 iterations, the last 2 kept: the same file names as the JAX
    package's; the newest restores to the network's parameters bit for bit
    in the port, and the JAX package reads it."""
    dirs = {J.root: tmp_path / "jax", T.root: tmp_path / "port"}
    (_, jnet), (tls, tnet) = _run(lambda P: [P.opt.CheckpointListener(
        str(dirs[P.root]), saveEveryNIterations=2, keepLast=2)])
    names = {r: sorted(os.listdir(d)) for r, d in dirs.items()}
    assert names[T.root] == names[J.root] == [
        f"checkpoint_iter_{STEPS - 2}.zip", f"checkpoint_iter_{STEPS}.zip"]
    last = tls[0].lastCheckpoint()
    from deeplearning4j_tpu.util.model_serializer import \
        ModelSerializer as JSer
    from deeplearning4j_tpu_torch.util.model_serializer import \
        ModelSerializer as TSer
    back = TSer.restoreMultiLayerNetwork(last, device="cpu")
    for n, d in tnet._params.items():
        for k, v in d.items():
            assert torch.equal(back._params[n][k], v)
    jback = JSer.restoreMultiLayerNetwork(last)
    for n, d in _np_tree(jback._params).items():
        for k, v in d.items():
            assert np.array_equal(tnet._params[n][k].numpy(), v)


def test_checkpoint_listener_per_epoch(tmp_path):
    net = _pair()[1]
    cl = T.opt.CheckpointListener(str(tmp_path), saveEveryNEpochs=1,
                                  keepLast=5)
    net.setListeners(cl)
    net.fit(_iter(T), epochs=2)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_epoch_1.zip",
                                            "checkpoint_epoch_2.zip"]


def test_profiler_listener_raises_naming_a16(tmp_path):
    """The listener raised naming ROADMAP A16 until the profiler's capture
    was ported; it now constructs and its window yields a report over the
    network's steps (more in tests/test_torch_profiler.py)."""
    listener = T.opt.ProfilerListener(trace_dir=str(tmp_path / "trace"),
                                      start_iter=1, trace_iters=1)
    net = _pair()[1]
    net.setListeners(listener)
    net.fit(_iter(T), epochs=1)
    assert listener.report is not None and listener.report["steps"] == 1


def test_metrics_listener():
    """One opt-in: the iteration counter, the score gauge and the
    iteration-time histogram, on the JAX package's metric names."""
    monitoring.disable()
    reg = monitoring.MetricsRegistry()
    try:
        net = _pair()[1]
        net.setListeners(T.opt.MetricsListener(registry=reg,
                                               deviceMemoryFrequency=2))
        for i in range(4):
            net.fit(_data(T, n=32, seed=i))
        assert reg.get("dl4j.train.iterations").value == 4
        _close(reg.get("dl4j.train.score").value, net.score(), 0, "score")
        assert reg.get("dl4j.train.iteration_seconds").count == 3
        assert reg.get(monitoring.MODEL_PARAMS_BYTES).value == sum(
            v.numel() * 4 for d in net._params.values() for v in d.values())
    finally:
        monitoring.disable()


# -- StatsListener and the dashboard -------------------------------------------
@pytest.mark.parametrize("graph", [False, True])
def test_stats_listener_matches_jax(graph):
    """A record per iteration: scores 1e-5, update ratios non-zero and 1e-4
    of JAX's (the snapshot is a host copy, not a view of the tensors the
    next step rewrites in place), parameter summaries 1e-5, activation
    histograms on the first record with the same keys."""
    from deeplearning4j_tpu.ui.stats import StatsListener as JStats
    (jls, _), (tls, _) = _run(
        lambda P: [(JStats if P is J else StatsListener)(
            activationFrequency=4)], graph=graph)
    jr, tr = jls[0].storage.all(), tls[0].storage.all()
    assert [r["iteration"] for r in tr] == [r["iteration"] for r in jr] == \
        list(range(1, STEPS + 1))
    for a, b in zip(tr, jr):
        assert set(a) == set(b)
        _close(a["score"], b["score"], TOL, "score")
        for k, s in b["params"].items():
            _close(a["params"][k]["meanMagnitude"], s["meanMagnitude"],
                   TOL, k)
        assert set(a.get("updateRatios", {})) == set(b.get("updateRatios",
                                                           {}))
        for k, v in b.get("updateRatios", {}).items():
            assert a["updateRatios"][k] > 0
            _close(a["updateRatios"][k], v, 1e-4, f"ratio {k}")
        assert set(a.get("activationHistograms", {})) == \
            set(b.get("activationHistograms", {}))
    hist = tr[0]["activationHistograms"]
    assert hist and all(sum(h["counts"]) > 0 for h in hist.values())
    assert "activationHistograms" in tr[4]
    assert "activationHistograms" not in tr[1]


def test_stats_ratios_zero_for_frozen_layers():
    """Through transfer learning: the frozen layer's update ratios read
    exactly 0, the trained ones' not."""
    src = _pair()[1]
    net = (T.tl.TransferLearning.Builder(src).setFeatureExtractor(0)
           .build())
    st = StatsListener(collectActivations=False)
    net.setListeners(st)
    for i in range(3):
        net.fit(_data(T, n=32, seed=i))
    for r in st.storage.all()[1:]:
        ratios = r["updateRatios"]
        assert ratios["0_W"] == 0 and ratios["0_b"] == 0
        assert ratios["1_W"] > 0 and ratios["2_W"] > 0


def test_file_stats_storage_round_trip(tmp_path):
    path = str(tmp_path / "stats.jsonl")
    net = _pair()[1]
    st = StatsListener(FileStatsStorage(path), activationFrequency=2)
    net.setListeners(st)
    for i in range(3):
        net.fit(_data(T, n=32, seed=i))
    again = FileStatsStorage(path)
    assert again.all() == json.loads(json.dumps(st.storage.all()))
    assert again.latest()["iteration"] == 3
    assert st.scores() == [r["score"] for r in again.all()]


def test_render_static_html_matches_jax(tmp_path):
    """The same records render to the same page in both packages."""
    from deeplearning4j_tpu.ui.server import \
        render_static_html as jrender
    from deeplearning4j_tpu.ui.stats import InMemoryStatsStorage as JStore
    net = _pair()[1]
    st = StatsListener(activationFrequency=2)
    net.setListeners(st)
    for i in range(3):
        net.fit(_data(T, n=32, seed=i))
    jstore = JStore()
    for r in st.storage.all():
        jstore.put(r)
    tsne = (np.random.default_rng(0).standard_normal((10, 2)),
            [i % 3 for i in range(10)])
    a = render_static_html(st.storage, str(tmp_path / "p.html"), tsne=tsne)
    b = jrender(jstore, str(tmp_path / "j.html"), tsne=tsne)
    html = open(a).read()
    assert html == open(b).read()
    assert "Activation histograms" in html and "update:parameter" in html


def test_ui_server_serves_stats():
    """GET /stats answers every attached storage's records, one per
    iteration."""
    net = _pair()[1]
    storage = InMemoryStatsStorage()
    net.setListeners(StatsListener(storage, collectActivations=False))
    server = UIServer()
    server.attach(storage)
    server.start(port=0)
    try:
        for i in range(3):
            net.fit(_data(T, n=32, seed=i))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/stats", timeout=10) as r:
            recs = json.loads(r.read())
    finally:
        server.stop()
    assert [r["iteration"] for r in recs] == [1, 2, 3]
    assert recs == json.loads(json.dumps(storage.all()))


def test_last_features_hold_the_batch():
    """The fit loops keep the last training batch's features for the
    listeners: the batch itself, in both network classes."""
    from test_torch_transfer import _graph_pair
    net = _pair()[1]
    ds = _data(T, n=32, seed=9)
    net.fit(ds)
    assert torch.equal(net._last_features, torch.from_numpy(ds.features))
    g = _graph_pair()[1]
    g.fit(ds)
    assert set(g._last_features) == {"in"}
    assert torch.equal(g._last_features["in"], torch.from_numpy(ds.features))

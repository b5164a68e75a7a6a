"""The port's ProfileSession (torch.profiler capture, `optimize/xplane.py`
decode) on the CPU: the JAX package's lifecycle contracts over 3 fit
steps of a small MultiLayerNetwork, the metrics it publishes, its trace
directory, `POST /profile` / `GET /profile` on the UI server and
`ProfilerListener`; and the same lifecycle run through both packages
gives the same states and step counts."""
import json
import os
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch import monitoring as mon
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.monitoring import profiler
from deeplearning4j_tpu_torch.monitoring.profiler import ProfileSession
from deeplearning4j_tpu_torch.monitoring.registry import MetricsRegistry
from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration,
                                         OutputLayer, Sgd)
from deeplearning4j_tpu_torch.optimize import ProfilerListener, xplane


@pytest.fixture(autouse=True)
def _clean():
    yield
    s = profiler.active_session()
    if s is not None:
        s.finish()
    mon.disable()


def _mlp(seed=1):
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Sgd(0.1))
            .activation("relu").list()
            .layer(DenseLayer(nOut=8))
            .layer(OutputLayer(nOut=2, activation="softmax",
                               lossFunction="mcxent"))
            .setInputType(InputType.feedForward(4)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _iterator(n_batches, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_batches * batch, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n_batches * batch)]
    return ArrayDataSetIterator(x, y, batch)


def _one():
    x = np.zeros((8, 4), np.float32)
    return DataSet(x, np.eye(2, dtype=np.float32)[np.zeros(8, int)])


def test_armed_session_captures_three_steps_and_publishes(tmp_path):
    """armed -> tracing -> done inside one fit; the report's per-op table,
    the dl4j.profile.* metrics, the rendered text; the session's own
    temporary trace directory is removed after the decode."""
    reg = MetricsRegistry()
    net = _mlp()
    session = mon.profile_next_steps(3, registry=reg, device="cpu")
    assert profiler.active_session() is session
    assert session.state == "armed"
    net.fit(_iterator(5), epochs=1, prefetch=0)
    assert session.state == "done", session.error
    assert profiler.active_session() is None
    rep = session.report
    assert rep["steps"] == 3 and session.captured_steps == 3
    assert rep["device_substr"] == ""          # a CPU trace: host threads
    assert rep["op_count"] >= 1 and rep["ops"][0]["count"] >= 1
    assert rep["device_self_ms"] > 0 and rep["categories"]
    assert rep["device_self_ms"] <= sum(r["total_ms"] for r in rep["ops"]) \
        + 1e-9 or rep["op_count"] > len(rep["ops"])
    assert mon.last_report() is rep
    assert reg.get(mon.PROFILE_CAPTURED_STEPS).value == 3
    assert reg.get(mon.PROFILE_DEVICE_MS).value == rep["device_self_ms"]
    assert reg.get(mon.PROFILE_SESSIONS).value == 1
    top = rep["ops"][0]["name"][:80]
    assert reg.get(mon.PROFILE_OP_COUNT, labels={"op": top}).value == \
        rep["ops"][0]["count"]
    text = session.render(top=5)
    assert "device self time" in text and "by category:" in text
    assert rep["trace_dir"] is None and session.trace_dir is not None
    assert not os.path.exists(session.trace_dir)
    json.loads(session.to_json())


def test_finish_closes_a_short_window_and_rearm_finishes_predecessor():
    net = _mlp()
    s1 = mon.profile_next_steps(50, device="cpu")
    net.fit(_one())
    net.fit(_one())
    assert s1.state == "tracing" and s1.captured_steps == 2
    s2 = mon.profile_next_steps(4, device="cpu")   # re-arm: s1 finished
    assert s1.state == "done", s1.error
    assert s1.report["steps"] == 2 and s1.report["op_count"] >= 1
    assert profiler.active_session() is s2
    s2.finish()                                   # never ran: failed
    assert s2.state == "failed" and s2.error == "no steps ran while armed"
    assert profiler.active_session() is None
    # a session that never opened does not overwrite a real report
    assert profiler.last_session() is s1
    assert profiler.last_report() is s1.report


def test_a_second_window_fails_and_fit_goes_on():
    """torch.profiler allows one window per process: a session that cannot
    open fails with the error, fit runs on, and the failure does not
    overwrite the last real report."""
    from torch.profiler import ProfilerActivity, profile
    net = _mlp()
    done = mon.profile_next_steps(1, device="cpu")
    net.fit(_one())
    assert done.state == "done"
    s = mon.profile_next_steps(2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        net.fit(_one())
    assert s.state == "failed" and "already running" in s.error
    assert profiler.active_session() is None
    assert profiler.last_report() is done.report
    before = net.getIterationCount() if hasattr(
        net, "getIterationCount") else None
    net.fit(_one())
    if before is not None:
        assert net.getIterationCount() == before + 1


def test_a_card_session_whose_trace_has_no_device_events_fails(
        monkeypatch, tmp_path):
    """A session on the card decodes only the card's "GPU" planes: a
    window whose trace holds host events alone ends failed, publishes
    nothing, and reports no host rows as device time."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    reg = MetricsRegistry()
    s = ProfileSession(steps=1, registry=reg, device="cuda",
                       keep_trace=False)
    prof = profile(activities=[ProfilerActivity.CPU])   # what a CUPTI
    prof.__enter__()                                    # that records no
    torch.ones(64, 64) @ torch.ones(64, 64)             # kernel leaves
    s.trace_dir = str(tmp_path / "trace")        # as _begin makes it
    os.makedirs(s.trace_dir)
    s._prof, s._t_begin, s.state = prof, time.perf_counter(), "tracing"
    s.step_end()
    assert s.state == "failed" and "no device activity" in s.error
    assert s.report is None
    assert reg.get(mon.PROFILE_SESSIONS) is None
    assert not os.path.exists(s.trace_dir)


def test_the_window_skips_a_step_that_captures_a_graph(monkeypatch):
    """A step that captures a CUDA graph (here: said to, on the CPU) runs
    before the window opens; the window then covers the next k steps."""
    net = _mlp()
    capturing = {0}
    monkeypatch.setattr(net, "_captures_next", lambda batches, graphs:
                        net.getIterationCount() in capturing)
    session = mon.profile_next_steps(2, device="cpu")
    net.fit(_one())
    assert session.state == "armed" and session.captured_steps == 0
    net.fit(_one())
    assert session.state == "tracing"
    net.fit(_one())
    assert session.state == "done", session.error
    assert session.report["steps"] == 2


def test_kept_trace_dir_holds_a_kineto_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    net = _mlp()
    session = mon.profile_next_steps(2, trace_dir=str(trace_dir),
                                     device="cpu")
    net.fit(_iterator(2), prefetch=0)
    assert session.state == "done", session.error
    assert session.report["trace_dir"] == str(trace_dir)
    files = xplane.find_xplane_files(str(trace_dir))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert xplane.op_table(str(trace_dir), device_substr="") != []


def test_profile_routes_on_the_ui_server():
    from deeplearning4j_tpu_torch.ui.server import UIServer
    server = UIServer.getInstance().start(port=0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        req = urllib.request.Request(base + "/profile?steps=2",
                                     method="POST", data=b"")
        armed = json.loads(urllib.request.urlopen(req, timeout=10).read())
        assert armed == {"armed": True, "steps": 2}
        st = json.loads(urllib.request.urlopen(base + "/profile",
                                               timeout=10).read())
        assert st["active"]["state"] == "armed"
        # the armed session's device: the caller's net runs on the CPU,
        # and without a card the session traces the CPU alone
        _mlp().fit(_iterator(3), prefetch=0)
        st = json.loads(urllib.request.urlopen(base + "/profile",
                                               timeout=10).read())
        assert st["active"] is None
        assert st["last"]["state"] == "done", st["last"]["error"]
        assert st["last"]["report"]["steps"] == 2
        assert len(st["last"]["report"]["ops"]) >= 1
    finally:
        server.stop()


def test_profiler_listener_yields_a_report(tmp_path):
    from deeplearning4j_tpu_torch.runtime.executioner import OpExecutioner
    ex = OpExecutioner.getInstance()
    ex.op_counts.clear()
    ex.op_times.clear()
    trace_dir = str(tmp_path / "trace")
    net = _mlp()
    listener = ProfilerListener(trace_dir=trace_dir, start_iter=1,
                                trace_iters=2)
    net.setListeners(listener)
    for _ in range(5):
        net.fit(_one())
    assert listener.report is not None and listener.report["steps"] == 2
    assert listener.report["op_count"] >= 1
    assert xplane.find_xplane_files(trace_dir)
    # the first iteration only arms the timer
    assert ex.getProfilingStats()["train_step"]["count"] == 4
    assert profiler.active_session() is None


def _lifecycle(mon_mod, prof_mod, net, fit_one, **kw):
    """One script of session calls; the states and step counts seen."""
    out = []
    s1 = mon_mod.profile_next_steps(3, **kw)
    out.append(s1.state)
    for _ in range(4):
        fit_one(net)
    out += [s1.state, s1.captured_steps, s1.report["steps"]]
    s2 = mon_mod.profile_next_steps(5, **kw)
    fit_one(net)
    s3 = mon_mod.profile_next_steps(2, **kw)
    out += [s2.state, s2.report["steps"], s3.state]
    s3.finish()
    out += [s3.state, prof_mod.active_session() is None,
            prof_mod.last_report() is s2.report]
    return out


def test_lifecycle_matches_the_jax_package():
    """The same calls through both packages' sessions (the JAX package
    traces with jax.profiler, the port with torch.profiler): the same
    states, captured steps and last-report rule."""
    from deeplearning4j_tpu import monitoring as jmon
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.monitoring import profiler as jprof
    from deeplearning4j_tpu.nn import (DenseLayer as JDense,
                                       InputType as JInputType,
                                       NeuralNetConfiguration as JNNC,
                                       OutputLayer as JOutput, Sgd as JSgd)
    from deeplearning4j_tpu.nn.multilayer import \
        MultiLayerNetwork as JMultiLayerNetwork
    jconf = (JNNC.Builder().seed(1).updater(JSgd(0.1)).activation("relu")
             .list().layer(JDense(nOut=8))
             .layer(JOutput(nOut=2, activation="softmax",
                            lossFunction="mcxent"))
             .setInputType(JInputType.feedForward(4)).build())
    jnet = JMultiLayerNetwork(jconf).init()
    x = np.zeros((8, 4), np.float32)
    y = np.eye(2, dtype=np.float32)[np.zeros(8, int)]
    try:
        want = _lifecycle(jmon, jprof, jnet,
                          lambda n: n.fit(JDataSet(x, y)))
    finally:
        if jprof.active_session() is not None:
            jprof.active_session().finish()
    got = _lifecycle(mon, profiler, _mlp(), lambda n: n.fit(_one()),
                     device="cpu")
    assert got == want
    assert got[:4] == ["armed", "done", 3, 3]

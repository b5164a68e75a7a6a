"""The port's UIServer (deeplearning4j_tpu_torch/ui/server.py) on an
ephemeral port, over a bert_tiny fleet on the CPU: every GET route of the
JAX package's dashboard answers with a parseable body from the port's
modules, `/health` follows the fleet (503 once serving is dead), the two
POST routes work, an unknown path answers 404, and `attachTsne` embeds
vectors wider than two dimensions through the port's t-SNE."""
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch import monitoring as mon
from deeplearning4j_tpu_torch.generation import (BertDecoder, FleetRouter,
                                                 GenerationServer)
from deeplearning4j_tpu_torch.models import bert_tiny, init_bert_params
from deeplearning4j_tpu_torch.monitoring import events
from deeplearning4j_tpu_torch.ui import UIServer

SERVER = dict(slots=2, cache_lengths=[16, 32], prompt_buckets=[8], seed=3)
JSON_ROUTES = ["/generation", "/fleet", "/requests", "/slo", "/trace",
               "/health", "/events?last=8", "/incidents", "/steps",
               "/executables", "/profile", "/stats", "/tsne"]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    cfg = bert_tiny()
    params = init_bert_params(cfg, seed=0, device="cpu")
    d = str(tmp_path_factory.mktemp("ui-exec"))
    router = FleetRouter(
        factory=lambda i: GenerationServer(BertDecoder(cfg, params),
                                           exec_cache_dir=d, **SERVER),
        num_replicas=2)
    router.warmup()
    mon.enable()
    events.reset()
    try:
        router.submit([5, 17, 99], max_new_tokens=6).result(timeout=60)
        yield router
    finally:
        mon.disable()
        router.shutdown()


@pytest.fixture
def ui():
    server = UIServer()
    server.start(port=0)
    yield server
    server.stop()


def _get(server, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.mark.parametrize("path", JSON_ROUTES)
def test_every_json_route_answers(fleet, ui, path):
    code, ctype, body = _get(ui, path)
    assert code == 200 and ctype == "application/json", body
    doc = json.loads(body)
    if path == "/fleet":
        (router,) = [r for r in doc["routers"]
                     if {x["name"] for x in r["replicas"]} == {"r0", "r1"}]
        assert router["completed"] >= 1
        assert router["autoscale"]["desired_replicas"] >= 1
    if path == "/health":
        assert doc["status"] == "ok"
        assert any(f["state"] == "serving" for f in doc["fleet"])
    if path == "/generation":
        assert sum(s["state"] == "serving" for s in doc["servers"]) >= 2
    if path == "/executables":
        assert doc["stores"]
        assert doc["persistent_compile_cache"]["entries"] >= 1
    if path == "/requests":
        assert any(t["kind"] == "fleet" for t in doc["recent"])


def test_page_metrics_and_unknown_paths(fleet, ui):
    code, ctype, body = _get(ui, "/")
    assert code == 200 and ctype == "text/html"
    assert b"/fleet" in body and b"Fleet (replica routing)" in body
    code, ctype, body = _get(ui, "/metrics")
    assert code == 200 and ctype.startswith("text/plain")
    assert b"dl4j_fleet_routed" in body
    for path in ("/no/such/route", "/fleetx", "/requests/no-such-trace"):
        assert _get(ui, path)[0] == 404, path
    # no coordinator is active: the reference's 404
    assert _get(ui, "/stragglers")[0] == 404
    assert _get(ui, "/nope", method="POST")[0] == 404


def test_post_routes(fleet, ui, tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_CRASH_DUMP_DIR", str(tmp_path))
    code, _, body = _get(ui, "/debug/bundle", method="POST")
    assert code == 200
    doc = json.loads(body)
    assert os.path.dirname(doc["path"]) == str(tmp_path)
    with open(doc["path"]) as f:
        assert set(doc["sections"]) <= set(json.load(f))
    code, _, body = _get(ui, "/profile?steps=2", method="POST")
    assert code == 200 and json.loads(body) == {"armed": True, "steps": 2}
    status = json.loads(_get(ui, "/profile")[2])
    assert status["active"]["steps"] == 2
    # the capture is ported (the route answered 501 before): two steps'
    # hooks close the window into a report that GET /profile serves
    session = mon.profiler.active_session()
    session.device = "cpu"
    session.step_start()
    session.step_end()
    session.step_end()
    status = json.loads(_get(ui, "/profile")[2])
    assert status["active"] is None
    assert status["last"]["state"] == "done", status["last"]["error"]
    assert status["last"]["report"]["steps"] == 2


def test_health_answers_503_once_serving_is_dead(ui):
    cfg = bert_tiny()
    srv = GenerationServer(BertDecoder(cfg, init_bert_params(
        cfg, seed=0, device="cpu")), **SERVER)
    srv.warmup()
    try:
        srv._die(RuntimeError("chaos kill"))
        code, _, body = _get(ui, "/health")
        assert code == 503 and json.loads(body)["status"] == "serving_dead"
    finally:
        srv.shutdown()
    assert _get(ui, "/health")[0] == 200


class _Storage:
    def __init__(self, recs):
        self.recs = recs

    def all(self):
        if isinstance(self.recs, Exception):
            raise self.recs
        return self.recs


def test_stats_tsne_and_a_failing_route(ui):
    rec = {"iteration": 1, "epoch": 0, "score": 0.5, "iterationTimeMs": 2.0}
    storage = _Storage([rec])
    ui.attach(storage)
    assert json.loads(_get(ui, "/stats")[2]) == [rec]
    ui.attachTsne(np.zeros((3, 2)), labels=["a", "b", "a"])
    assert json.loads(_get(ui, "/tsne")[2])["labels"] == ["a", "b", "a"]
    # wider vectors are embedded by the port's BarnesHutTsne
    vecs = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
    ui.attachTsne(vecs, labels=list("abcabc"), maxIter=20, perplexity=2.0,
                  device="cpu")
    tsne = json.loads(_get(ui, "/tsne")[2])
    assert len(tsne["points"]) == 6 and tsne["labels"] == list("abcabc")
    assert np.isfinite(np.asarray(tsne["points"])).all()
    ui.detach(storage)
    ui.attach(_Storage(RuntimeError("broken storage")))
    code, _, body = _get(ui, "/stats")
    assert code == 500 and b"broken storage" in body
    assert _get(ui, "/health")[0] == 200          # the handler lives on
    assert UIServer.getInstance() is UIServer.getInstance()

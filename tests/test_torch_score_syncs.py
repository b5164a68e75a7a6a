"""The lazy score on the port, held to the JAX package's counts: `fit`
leaves the loss on the device, and `score()` floats it once through
`runtime.pipeline.materialize_score`, counted on `dl4j.pipeline.syncs`
and cached (tests/test_pipeline.py's three sync tests, for both network
classes). Each test runs both packages on the same seeded data, from the
same weights (carried across as numpy), and holds the port's counts equal
to the reference's; the first scores agree to 1e-6."""
import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import monitoring as jmon
from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JArrayIterator
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import listeners as jlisteners

from deeplearning4j_tpu_torch import monitoring as tmon
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import (MetricsListener,
                                                         ScoreIterationListener)
from deeplearning4j_tpu_torch.runtime import pipeline

SCORE_TOL = 1e-6
KINDS = ("multilayer", "graph")


@pytest.fixture(autouse=True)
def _clean_monitoring():
    yield
    for mon in (jmon, tmon):
        mon.get_registry().clear()
        mon.disable()


def _conf(nn, kind):
    b = (nn.NeuralNetConfiguration.Builder()
         .seed(3).updater(nn.Sgd(0.1)).activation("tanh"))
    if kind == "multilayer":
        return (b.list()
                .layer(nn.DenseLayer.Builder().nOut(8).build())
                .layer(nn.OutputLayer.Builder("mcxent").nOut(3)
                       .activation("softmax").build())
                .setInputType(nn.InputType.feedForward(5)).build())
    return (b.graphBuilder().addInputs("in")
            .setInputTypes(nn.InputType.feedForward(5))
            .addLayer("hidden", nn.DenseLayer.Builder().nOut(8).build(), "in")
            .addLayer("out", nn.OutputLayer.Builder("mcxent").nOut(3)
                      .activation("softmax").build(), "hidden")
            .setOutputs("out").build())


def _nets(kind):
    """(JAX net, port net) of one configuration, the port's carrying the
    JAX net's initial weights."""
    jnet = (JMLN if kind == "multilayer" else JGraph)(_conf(jnn, kind)).init()
    params, state = (jax.tree_util.tree_map(np.asarray, t)
                     for t in (jnet._params, jnet._state))
    if kind == "multilayer":
        tnet = tnn.multilayer_params_from_numpy(
            MultiLayerNetwork(_conf(tnn, kind)), params, state, device="cpu")
    else:
        tnet = tnn.graph_params_from_numpy(
            ComputationGraph(_conf(tnn, kind)), params, state, device="cpu")
    return jnet, tnet


def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return X, Y


def _count(mon, metric):
    snap = mon.get_registry().snapshot()
    return sum(r["value"] for r in snap.get(metric, []))


def _syncs(mon):
    return _count(mon, mon.PIPELINE_SYNCS)


def _fit_both(kind, listeners=None):
    """50 steps of batch 8 in both packages from the same weights, with
    the registries cleared first; `listeners(package)` makes a net's
    listener list."""
    X, Y = _data()
    jnet, tnet = _nets(kind)
    for mon in (jmon, tmon):
        mon.get_registry().clear()
    if listeners is not None:
        jnet.setListeners(*listeners(jlisteners))
        tnet.setListeners(*listeners(None))
    jnet.fit(JArrayIterator(X, Y, 8), epochs=1)
    tnet.fit(ArrayDataSetIterator(X, Y, 8), epochs=1)
    assert jnet.getIterationCount() == tnet.getIterationCount() == 50
    return jnet, tnet


@pytest.mark.parametrize("kind", KINDS)
def test_listener_free_fit_records_zero_syncs_then_one_score_read(kind):
    for mon in (jmon, tmon):
        mon.enable()
    jnet, tnet = _fit_both(kind)
    assert _syncs(tmon) == _syncs(jmon) == 0, \
        "a fit loop re-introduced a per-step blocking sync"
    staged = _count(tmon, tmon.PIPELINE_STAGED_BATCHES)
    assert staged == _count(jmon, jmon.PIPELINE_STAGED_BATCHES) == 50
    assert torch.is_tensor(tnet._score)      # still on the device
    js, ts = jnet.score(), tnet.score()
    assert isinstance(ts, float) and np.isfinite(ts)
    assert _syncs(tmon) == _syncs(jmon) == 1
    # cached: the second read costs no sync and returns the same float
    assert tnet.score() == ts and jnet.score() == js
    assert _syncs(tmon) == _syncs(jmon) == 1
    assert tnet._score == ts
    assert abs(ts - js) <= SCORE_TOL, (ts, js)


@pytest.mark.parametrize("kind", KINDS)
def test_score_listener_syncs_at_its_own_cadence(kind):
    for mon in (jmon, tmon):
        mon.enable()
    quiet = lambda *_: None  # noqa: E731

    def listeners(mod):
        cls = ScoreIterationListener if mod is None \
            else mod.ScoreIterationListener
        return [cls(10, log_fn=quiet)]

    _fit_both(kind, listeners)
    assert _syncs(tmon) == _syncs(jmon) == 5   # iterations 10, 20, .., 50


@pytest.mark.parametrize("kind", KINDS)
def test_metrics_listener_score_frequency_bounds_syncs(kind):
    def listeners(mod):
        cls = MetricsListener if mod is None else mod.MetricsListener
        return [cls(scoreFrequency=25)]

    jnet, tnet = _fit_both(kind, listeners)
    assert _syncs(tmon) == _syncs(jmon) == 2   # iterations 25, 50
    assert tmon.get_registry().get("dl4j.train.score") is not None
    # the gauge holds the last read, which score() now returns uncounted
    assert tnet.score() == tmon.get_registry().get(
        "dl4j.train.score").value
    assert _syncs(tmon) == 2


def test_blocking_float_counts_only_tensor_reads():
    class Model:
        _score = None

    tmon.enable()
    assert pipeline.blocking_float(None) is None
    assert pipeline.blocking_float(3) == 3.0
    assert pipeline.materialize_score(Model()) is None
    assert _syncs(tmon) == 0
    m = Model()
    m._score = torch.tensor(0.25)
    assert pipeline.materialize_score(m, site="probe") == 0.25
    assert m._score == 0.25 and isinstance(m._score, float)
    snap = tmon.get_registry().snapshot()
    (row,) = snap[tmon.PIPELINE_SYNCS]
    assert row["labels"] == {"site": "probe"} and row["value"] == 1
    assert snap[tmon.PIPELINE_HOST_BLOCKED_MS]
    # monitoring off: floated, cached, not counted
    tmon.get_registry().clear()
    tmon.disable()
    m._score = torch.tensor(0.5)
    assert pipeline.materialize_score(m) == 0.5
    assert _syncs(tmon) == 0

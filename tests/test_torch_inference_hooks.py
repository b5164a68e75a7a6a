"""ParallelInference's fault sites and monitoring, and the prefetch
staging counters, on the CPU, against the JAX package where the contract
is shared.

- A fault injected at `INFERENCE_FORWARD` is counted by the plan and
  delivered to the request's caller as the injected error, in both
  packages; the next request is served.
- A fault at `SERVING_DISPATCH` (the bucket-graph path) falls back to the
  eager forward: the answer is served, `aot_fallbacks` and
  `dl4j.serving.aot_fallbacks` count it.
- A fault at `INFERENCE_COLLECTOR` kills the collector; the next request
  revives it behind the breaker (`dl4j.resilience.collector_restarts`).
- With monitoring on: requests, forwards, batch rows, the request-latency
  histogram and the serving rows; `dl4j.pipeline.staged_batches` equals
  the batches a prefetched fit staged, and the prefetch depth gauge is
  set.
"""
import numpy as np
import pytest

from deeplearning4j_tpu_torch import monitoring as mon
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.monitoring.registry import MetricsRegistry
from deeplearning4j_tpu_torch.nn import (ComputationGraph, DenseLayer,
                                         InputType, NeuralNetConfiguration,
                                         OutputLayer, Sgd)
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import InjectedFault


@pytest.fixture
def registry(monkeypatch):
    """A fresh process registry with monitoring on, for the test only."""
    from deeplearning4j_tpu_torch.monitoring import registry as _reg
    monkeypatch.setattr(_reg, "_global_registry", MetricsRegistry())
    mon.enable()
    yield mon.get_registry()
    mon.disable()


def _conf(builder_mod):
    return (builder_mod.NeuralNetConfiguration.Builder()
            .seed(3).updater(builder_mod.Sgd(0.1)).activation("tanh")
            .graphBuilder().addInputs("in")
            .setInputTypes(builder_mod.InputType.feedForward(5))
            .addLayer("hidden", builder_mod.DenseLayer(nOut=8), "in")
            .addLayer("out", builder_mod.OutputLayer(
                lossFunction="mcxent", nOut=3, activation="softmax"),
                "hidden")
            .setOutputs("out").build())


def _net():
    from deeplearning4j_tpu_torch import nn
    return ComputationGraph(_conf(nn)).init("cpu")


def _value(reg, name, **labels):
    m = reg.get(name, labels=labels or None) if labels else reg.get(name)
    return None if m is None else m.value


def _inference_forward_fault(pi_cls, plan_cls, site, net, x):
    """Three requests; the plan fails the 2nd forward. Returns what each
    request saw and the plan's fire count."""
    plan = plan_cls(seed=1).fail_at(site, 2)
    seen = []
    with plan:
        pi = pi_cls.Builder(net).batchLimit(4).build()
        try:
            for _ in range(3):
                try:
                    out = np.asarray(pi.output(x))
                    seen.append(("ok", out.shape))
                except Exception as e:   # the injected fault
                    seen.append((type(e).__name__, None))
        finally:
            pi.shutdown()
    return seen, plan.fired.get(site, 0)


def test_inference_forward_fault_counted_and_delivered_as_in_jax():
    from deeplearning4j_tpu import nn as jnn
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.parallel.inference import \
        ParallelInference as JPI
    from deeplearning4j_tpu.resilience import faults as jfaults
    x = np.random.default_rng(0).standard_normal((2, 5)).astype(np.float32)
    want = _inference_forward_fault(JPI, jfaults.FaultPlan,
                                    jfaults.INFERENCE_FORWARD,
                                    JGraph(_conf(jnn)).init(), x)
    got = _inference_forward_fault(ParallelInference, faults.FaultPlan,
                                   faults.INFERENCE_FORWARD, _net(), x)
    assert got == want
    assert got == ([("ok", (2, 3)), ("InjectedFault", None),
                    ("ok", (2, 3))], 1)


def test_serving_dispatch_fault_falls_back_to_the_eager_forward(registry):
    net = _net()
    x = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    plan = faults.FaultPlan(seed=2).fail_at(faults.SERVING_DISPATCH, 1)
    with plan:
        pi = ParallelInference.Builder(net).bucketLadder([1, 2, 4]).build()
        try:
            pi.warmup()
            out = pi.output(x)
            assert plan.fired[faults.SERVING_DISPATCH] == 1
            st = pi.status()
            assert st["aot_fallbacks"] == 1
            assert isinstance(pi._aot_error, InjectedFault)
            np.testing.assert_allclose(out, net.output(x).numpy(),
                                       atol=1e-6)
        finally:
            pi.shutdown()
    assert _value(registry, mon.SERVING_AOT_FALLBACKS) == 1


def test_inference_collector_fault_restarts_the_collector(registry):
    net = _net()
    x = np.zeros((2, 5), np.float32)
    plan = faults.FaultPlan(seed=3).fail_at(faults.INFERENCE_COLLECTOR, 1)
    with plan:
        pi = ParallelInference.Builder(net).batchLimit(4).build()
        try:
            pi._thread.join(5)          # the first loop pass dies
            assert not pi._thread.is_alive()
            assert isinstance(pi.collector_error, InjectedFault)
            out = pi.output(x)          # revives behind the breaker
            assert out.shape == (2, 3) and pi.collector_restarts == 1
        finally:
            pi.shutdown()
    assert _value(registry, mon.RESILIENCE_COLLECTOR_RESTARTS) == 1


def test_monitoring_counts_requests_forwards_and_rows(registry):
    net = _net()
    rng = np.random.default_rng(4)
    pi = ParallelInference.Builder(net).bucketLadder([1, 2, 4]).build()
    try:
        pi.warmup()
        for n in (1, 3, 6):
            pi.output(rng.standard_normal((n, 5)).astype(np.float32))
    finally:
        pi.shutdown()
    assert _value(registry, "dl4j.inference.requests") == 3
    # 6 rows split into chunks of 4 and 2: four forwards in all
    assert _value(registry, "dl4j.inference.forwards") == 4
    assert _value(registry, mon.SERVING_ROWS) == 10
    assert _value(registry, mon.SERVING_PADDED_ROWS) == 1   # 3 -> 4
    assert _value(registry, mon.SERVING_SPLITS) == 1
    assert registry.get(mon.INFERENCE_REQUEST_MS).count == 3
    assert registry.get("dl4j.inference.batch_rows").count == 4


def test_staged_batches_equal_the_batches_staged(registry):
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    conf = (NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1))
            .list().layer(DenseLayer(nOut=4, activation="tanh"))
            .layer(OutputLayer(nOut=2, activation="softmax",
                               lossFunction="mcxent"))
            .setInputType(InputType.feedForward(3)).build())
    net = MultiLayerNetwork(conf).init("cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((28, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 28)]
    net.fit(ArrayDataSetIterator(x, y, 4), epochs=2, prefetch=2)
    assert _value(registry, mon.PIPELINE_STAGED_BATCHES) == 14
    depth = _value(registry, mon.PIPELINE_PREFETCH_DEPTH)
    assert depth is not None and 0 <= depth <= 2
    mon.disable()
    net.fit(ArrayDataSetIterator(x, y, 4), epochs=1, prefetch=2)
    assert _value(registry, mon.PIPELINE_STAGED_BATCHES) == 14

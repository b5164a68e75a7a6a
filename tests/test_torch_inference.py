"""The port's ParallelInference (deeplearning4j_tpu_torch/parallel/
inference.py) on a small port graph on the CPU: the contracts of
tests/test_inference.py (concurrent clients get exactly the answers of a
direct output(), and requests coalesce into fewer forwards) and the
degradation contracts of tests/test_resilience.py (deadline, shed,
breaker-guarded collector restart, idempotent shutdown)."""
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.nn import (ComputationGraph, DenseLayer,
                                         InputType, MergeVertex,
                                         NeuralNetConfiguration, OutputLayer,
                                         Sgd)
from deeplearning4j_tpu_torch.parallel.inference import (InferenceMode,
                                                         ParallelInference)
from deeplearning4j_tpu_torch.resilience.errors import (
    CircuitOpenError, InferenceOverloadedError, InferenceTimeoutError)
from deeplearning4j_tpu_torch.resilience.policy import CircuitBreaker


def _net():
    conf = (NeuralNetConfiguration.Builder()
            .seed(3).updater(Sgd(0.1)).activation("tanh")
            .graphBuilder()
            .addInputs("in")
            .setInputTypes(InputType.feedForward(5))
            .addLayer("hidden", DenseLayer(nOut=8), "in")
            .addLayer("out", OutputLayer(lossFunction="mcxent", nOut=3,
                                         activation="softmax"), "hidden")
            .setOutputs("out")
            .build())
    return ComputationGraph(conf).init("cpu")


@pytest.fixture(scope="module")
def net():
    return _net()


def _direct(net, x):
    return net.output(x).numpy()


def test_sequential_mode_matches_direct(net):
    pi = ParallelInference.Builder(net).inferenceMode(
        InferenceMode.SEQUENTIAL).build()
    x = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    np.testing.assert_allclose(pi.output(x), _direct(net, x), atol=1e-6)
    # single example: no batch dim in, none out
    np.testing.assert_allclose(pi.output(x[0]), _direct(net, x[:1])[0],
                               atol=1e-6)


def test_batched_mode_concurrent_clients_exact(net):
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.BATCHED)
          .batchLimit(16).build())
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((40, 5)).astype(np.float32)
    want = _direct(net, xs)
    got = [None] * 40
    errs = []

    def client(i):
        try:
            got[i] = pi.output(xs[i])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(40)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    pi.shutdown()
    assert not errs, errs
    for i in range(40):
        np.testing.assert_allclose(got[i], want[i], atol=1e-5, rtol=1e-5,
                                   err_msg=str(i))
    # coalescing happened: far fewer forwards than requests
    assert pi.model_calls < 40, pi.model_calls


def test_batch_requests_and_padding_buckets(net):
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.BATCHED).batchLimit(8).build())
    rng = np.random.default_rng(2)
    x3 = rng.standard_normal((3, 5)).astype(np.float32)   # pads 3 -> 4
    want = _direct(net, x3)
    got = pi.output(x3)
    pi.shutdown()
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_shutdown_falls_back_to_direct(net):
    pi = ParallelInference.Builder(net).build()
    pi.shutdown()
    x = np.zeros((2, 5), np.float32)
    np.testing.assert_allclose(pi.output(x), _direct(net, x), atol=1e-6)


def test_multi_input_graph_batched():
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Sgd(0.1))
            .graphBuilder()
            .addInputs("a", "b")
            .addLayer("da", DenseLayer(nOut=6, activation="tanh"), "a")
            .addLayer("db", DenseLayer(nOut=6, activation="tanh"), "b")
            .addVertex("merge", MergeVertex(), "da", "db")
            .addLayer("out", OutputLayer(nOut=3, activation="softmax"),
                      "merge")
            .setOutputs("out")
            .setInputTypes(InputType.feedForward(4),
                           InputType.feedForward(5))
            .build())
    net = ComputationGraph(conf).init("cpu")
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.BATCHED).batchLimit(16).build())
    rng = np.random.default_rng(2)
    a = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal((24, 5)).astype(np.float32)
    want = net.output([a, b]).numpy()
    got = [None] * 24
    errs = []

    def client(i):
        try:
            got[i] = pi.output([a[i], b[i]])   # single example, two inputs
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    pi.shutdown()
    assert not errs, errs
    for i in range(24):
        np.testing.assert_allclose(got[i], want[i], atol=1e-5)
    assert pi.model_calls < 24


def test_aot_surface_names_its_slice(net, tmp_path):
    """The executable path's knobs build; lengthBuckets (recurrent
    serving) still raises, naming its slice."""
    b = ParallelInference.Builder(net)
    assert (b.bucketLadder([1, 2]).executableCacheDir(str(tmp_path))
            .stagingDepth(2).aotBreaker(CircuitBreaker())) is b
    for call in (lambda: b.lengthBuckets([8]),
                 lambda: ParallelInference(
                     net, InferenceMode.SEQUENTIAL).warmup(lengths=[8])):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            call()
    pi = b.build()
    try:
        assert pi.warmup()["keys"] == 2
    finally:
        pi.shutdown()


# ===================== degradation ========================================
def _stall(net):
    """Make net.output block until the returned event is set."""
    gate = threading.Event()
    real = net.output

    def slow(x):
        gate.wait(10)
        return real(x)

    net.output = slow
    return gate, real


def test_inference_overload_sheds_with_typed_error():
    net = _net()
    x = np.zeros((2, 5), np.float32)
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.BATCHED)
          .batchLimit(1).queueLimit(1).enqueueTimeoutMs(30).build())
    gate, real = _stall(net)
    try:
        t1 = threading.Thread(target=lambda: pi.output(x))  # in collector
        t1.start()
        time.sleep(0.15)
        t2 = threading.Thread(target=lambda: pi.output(x))  # fills queue
        t2.start()
        time.sleep(0.15)
        t0 = time.monotonic()
        with pytest.raises(InferenceOverloadedError):
            pi.output(x)
        assert time.monotonic() - t0 < 2.0, "shed must be prompt"
    finally:
        gate.set()
        net.output = real
    t1.join(10)
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()
    pi.shutdown()
    assert pi._queue.qsize() == 0, "queue drains clean"
    # still serves (direct) after shutdown
    assert pi.output(x).shape == (2, 3)


def test_inference_timeout_typed_and_late_result_discarded():
    net = _net()
    x = np.zeros((2, 5), np.float32)
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.BATCHED)
          .batchLimit(4).queueLimit(16).build())
    gate, real = _stall(net)
    try:
        t1 = threading.Thread(target=lambda: pi.output(x))  # stalls collector
        t1.start()
        time.sleep(0.15)
        t0 = time.monotonic()
        with pytest.raises(InferenceTimeoutError):
            pi.output(x, timeout_ms=100)
        elapsed = time.monotonic() - t0
        assert elapsed < 2.0, f"deadline not honoured ({elapsed:.2f}s)"
    finally:
        gate.set()
        net.output = real
    t1.join(10)
    assert not t1.is_alive()
    pi.shutdown()
    assert pi._queue.qsize() == 0, "cancelled request discarded on drain"
    assert pi.timeouts >= 1


class _DyingCollector(ParallelInference):
    """A collector that dies on each of its first `deaths` loop passes,
    standing in for the JAX tests' fault plan at inference.collector."""

    def __init__(self, *a, deaths, **kw):
        self._deaths = deaths
        super().__init__(*a, **kw)

    def _collector(self):
        if self._deaths > 0:
            self._deaths -= 1
            raise RuntimeError("injected collector death")
        return super()._collector()


def test_inference_shutdown_idempotent_and_dead_collector_never_blocks():
    net = _net()
    x = np.zeros((2, 5), np.float32)
    # the collector dies at once; the breaker allows one restart, which
    # dies too; then it is OPEN -> direct-serve degradation
    pi = _DyingCollector(
        net, batch_limit=4, queue_limit=4, deaths=50,
        breaker=CircuitBreaker(failure_threshold=1, cooldown=60.0,
                               name="test.collector"))
    time.sleep(0.1)
    out = pi.output(x)          # must not block despite dead collector
    assert out.shape == (2, 3)
    assert isinstance(pi.collector_error, RuntimeError)
    pi.shutdown()
    pi.shutdown()               # idempotent
    assert pi.output(x).shape == (2, 3)   # post-shutdown: direct serve


def test_inference_collector_restarts_behind_breaker():
    net = _net()
    x = np.zeros((2, 5), np.float32)
    pi = _DyingCollector(net, batch_limit=4, queue_limit=8, deaths=1)
    deadline = time.monotonic() + 10
    while pi._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.02)        # wait for the scheduled death
    assert not pi._thread.is_alive()
    out = pi.output(x)          # revives the collector and serves
    assert out.shape == (2, 3)
    assert pi.collector_restarts == 1
    assert pi._breaker.state == CircuitBreaker.CLOSED
    np.testing.assert_allclose(out, _direct(net, x), atol=1e-6)
    pi.shutdown()


def test_breaker_opens_and_half_opens_on_schedule():
    now = [0.0]
    br = CircuitBreaker(failure_threshold=2, cooldown=10.0,
                        clock=lambda: now[0])
    assert br.allow() and br.state == br.CLOSED
    br.record_failure()
    assert br.state == br.CLOSED
    br.record_failure()
    assert br.state == br.OPEN and not br.allow()
    now[0] = 10.0
    assert br.state == br.HALF_OPEN
    assert br.allow()          # the one probe
    assert not br.allow()      # probe in flight: shed
    br.record_failure()        # probe failed -> OPEN again
    assert br.state == br.OPEN
    now[0] = 20.0
    assert br.allow()
    br.record_success()
    assert br.state == br.CLOSED


def test_breaker_call_sheds_with_typed_error():
    br = CircuitBreaker(failure_threshold=1, cooldown=60.0)
    with pytest.raises(ZeroDivisionError):
        br.call(lambda: 1 / 0)
    with pytest.raises(CircuitOpenError):
        br.call(lambda: 1)

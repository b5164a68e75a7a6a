"""`ComputationGraph.fit(prefetch=)` and the port's runtime/pipeline.py on
the CPU: a prefetched fit equals a synchronous one bit for bit (the
reference's test_prefetched_fit_bit_identical_to_synchronous), epochs
restart the staging thread, a failing loader surfaces its error instead
of ending the epoch early, and staged batches own their memory."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import (Adam, ComputationGraph, DenseLayer,
                                         InputType, NeuralNetConfiguration,
                                         OutputLayer, Sgd)
from deeplearning4j_tpu_torch.runtime import pipeline


def _net(updater):
    conf = (NeuralNetConfiguration.Builder()
            .seed(3).updater(updater).activation("tanh")
            .graphBuilder().addInputs("in")
            .setInputTypes(InputType.feedForward(5))
            .addLayer("hidden", DenseLayer(nOut=8), "in")
            .addLayer("out", OutputLayer(lossFunction="mcxent", nOut=3,
                                         activation="softmax"), "hidden")
            .setOutputs("out").build())
    return ComputationGraph(conf).init("cpu")


def _batches(n=30, size=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n * size, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n * size)]
    return [DataSet(x[i:i + size], y[i:i + size])
            for i in range(0, n * size, size)]


def _assert_same(a, b):
    for name in a._params:
        for k in a._params[name]:
            assert torch.equal(a._params[name][k], b._params[name][k])
    assert a.score() == b.score()


@pytest.mark.parametrize("updater", [lambda: Sgd(0.1), lambda: Adam(1e-2)],
                         ids=["sgd", "adam"])
@pytest.mark.parametrize("steps_per_dispatch", [1, 5])
def test_prefetched_fit_bit_identical_to_synchronous(updater,
                                                     steps_per_dispatch):
    data = _batches()
    a, b = _net(updater()), _net(updater())
    a.fit(data, epochs=2, stepsPerDispatch=steps_per_dispatch)  # default 2
    b.fit(data, epochs=2, stepsPerDispatch=steps_per_dispatch, prefetch=0)
    _assert_same(a, b)
    assert a.getIterationCount() == b.getIterationCount() == 60
    assert a.getEpochCount() == 2


class _Loader:
    """A hasNext/next iterator with reset, failing at batch `fail_at`."""

    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at, self.i = batches, fail_at, 0

    def hasNext(self):
        return self.i < len(self.batches)

    def next(self):
        if self.i == self.fail_at:
            raise OSError("disk read failed")
        self.i += 1
        return self.batches[self.i - 1]

    def reset(self):
        self.i = 0

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()


def test_loader_error_surfaces_instead_of_ending_the_epoch():
    net = _net(Sgd(0.1))
    with pytest.raises(OSError, match="disk read failed"):
        net.fit(_Loader(_batches(), fail_at=7), prefetch=3)
    assert net.getIterationCount() == 7       # the batches before it ran


def test_every_epoch_restarts_the_staging_thread():
    data = _batches(n=6)
    a, b = _net(Sgd(0.1)), _net(Sgd(0.1))
    a.fit(_Loader(data), epochs=3, prefetch=2)
    b.fit(data, epochs=3, prefetch=0)
    assert a.getIterationCount() == 18
    _assert_same(a, b)


def test_maybe_prefetch_wraps_only_what_opts_in():
    data = _batches(n=2)
    it, pf = pipeline.maybe_prefetch(data, 0, "cpu")
    assert it is data and pf is None

    class NoAsync(list):
        def asyncSupported(self):
            return False

    it, pf = pipeline.maybe_prefetch(NoAsync(data), 2, "cpu")
    assert pf is None
    it, pf = pipeline.maybe_prefetch(data, 2, "cpu")
    try:
        assert isinstance(it, pipeline.PrefetchIterator) and it is pf
        got = list(it)
        assert len(got) == 2 and all(
            isinstance(s, pipeline.StagedBatch) for s in got)
    finally:
        pf.close()


def test_staged_batches_own_their_memory():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    y = np.eye(4, dtype=np.float32)
    staged = pipeline.stage_dataset(DataSet(x, y), "cpu")
    multi = pipeline.stage_dataset(MultiDataSet([x, x], [y]), "cpu")
    ds = DataSet(x, y)
    x_before = x.copy()
    ds.features[...] = -1            # the DataSet holds the caller's array
    np.testing.assert_array_equal(staged.features.numpy(), x_before)
    np.testing.assert_array_equal(multi.features[1].numpy(), x_before)
    assert staged.event is None and staged.numExamples() == 4
    assert multi.labelsMasks is None and len(multi.features) == 2

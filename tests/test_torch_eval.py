"""The port's evaluators (eval/evaluation.py) and DataSetIterators
(datasets/iterators.py), copies of the JAX package's numpy modules, against
the JAX package on the same arrays: every metric equal, every batch equal
bit for bit. Then the evaluation loop of both network classes: the
features staged by the prefetch of an iterator that opts in give the
synchronous loop's numbers, and its `eval.forward` fault site fires."""
import numpy as np
import pytest

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu.eval.evaluation as jev
import deeplearning4j_tpu_torch.datasets as tds
import deeplearning4j_tpu_torch.eval as tev
from deeplearning4j_tpu_torch.nn import (Adam, DenseLayer, InputType,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import InjectedFault
from deeplearning4j_tpu_torch.runtime import pipeline


def _cls_arrays(seed=0, n=60, c=4, masked=True):
    rng = np.random.default_rng(seed)
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    logits = rng.standard_normal((n, c)).astype(np.float32) + 1.5 * labels
    preds = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = (rng.random(n) < 0.8).astype(np.float32) if masked else None
    return labels, preds, mask


def _feed(ev_t, ev_j, batches):
    for labels, preds, mask in batches:
        ev_t.eval(labels, preds, mask)
        ev_j.eval(labels, preds, mask)


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want)
    else:
        assert got == want or (np.isnan(got) and np.isnan(want))


#: evaluator -> (constructor args, batches, [(method, args)])
EVALUATORS = {
    "Evaluation": ((None, 2), [_cls_arrays(0), _cls_arrays(1)], [
        ("accuracy", ()), ("topNAccuracy", ()), ("precision", ()),
        ("recall", ()), ("f1", ()), ("precision", (2,)), ("f1", (1,)),
        ("confusionMatrix", ()), ("matthewsCorrelation", ()),
        ("gMeasure", ()), ("falseAlarmRate", ()), ("truePositives", (0,)),
        ("falseNegatives", (3,)), ("stats", ())]),
    "EvaluationBinary": ((0.5,), [_cls_arrays(2, c=3)], [
        ("accuracy", ()), ("precision", (1,)), ("recall", ()), ("f1", ()),
        ("stats", ())]),
    "ROC": ((0,), [_cls_arrays(3, c=2), _cls_arrays(4, c=2)], [
        ("calculateAUC", ()), ("getRocCurve", ())]),
    "ROC thresholded": ((10,), [_cls_arrays(3, c=2)], [
        ("calculateAUC", ())]),
    "ROCMultiClass": ((0,), [_cls_arrays(5)], [
        ("calculateAUC", (2,)), ("calculateAverageAUC", ())]),
    "ROCBinary": ((0,), [_cls_arrays(6, c=3)], [
        ("numLabels", ()), ("calculateAUC", (1,)),
        ("calculateAverageAUC", ()), ("stats", ())]),
    "EvaluationCalibration": ((5, 5), [_cls_arrays(7)], [
        ("getReliabilityDiagram", (1,)), ("getProbabilityHistogram", (0,)),
        ("expectedCalibrationError", (2,))]),
    "RegressionEvaluation": ((None,), [
        tuple(np.random.default_rng(8).standard_normal((2, 30, 3)).astype(
            np.float32)) + (None,)], [
        ("meanSquaredError", ()), ("meanAbsoluteError", (1,)),
        ("rootMeanSquaredError", ()), ("rSquared", (0,)),
        ("pearsonCorrelation", (2,)), ("stats", ())]),
}


@pytest.mark.parametrize("case", sorted(EVALUATORS))
def test_evaluator_matches_the_jax_package(case):
    args, batches, calls = EVALUATORS[case]
    name = case.split()[0]
    ev_t, ev_j = getattr(tev, name)(*args), getattr(jev, name)(*args)
    _feed(ev_t, ev_j, batches)
    for method, margs in calls:
        _same(getattr(ev_t, method)(*margs), getattr(ev_j, method)(*margs))


# -- iterators -----------------------------------------------------------------
def _array_pair():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 50)]
    return x, y


def _list_sets(mod):
    x, y = _array_pair()
    return [mod.DataSet(x[i:i + 10], y[i:i + 10]) for i in range(0, 50, 10)]


def _multi_sets(mod):
    x, y = _array_pair()
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti
    cls = tds.MultiDataSet if mod is tds else JMulti
    return [cls([x[i:i + 10], x[i:i + 10] * 2], [y[i:i + 10]])
            for i in range(0, 50, 10)]


#: iterator -> (factory(module), epochs)
ITERATORS = {
    "ArrayDataSetIterator": (lambda m: m.ArrayDataSetIterator(
        *_array_pair(), 16, shuffle=True, seed=3), 2),
    "MnistDataSetIterator": (lambda m: m.MnistDataSetIterator(
        64, num_examples=200), 1),
    "MnistDataSetIterator test": (lambda m: m.MnistDataSetIterator(
        100, train=False, num_examples=150), 1),
    "EmnistDataSetIterator": (lambda m: m.EmnistDataSetIterator(
        32, num_examples=70), 1),
    "CifarDataSetIterator": (lambda m: m.CifarDataSetIterator(
        40, num_examples=90), 1),
    "Cifar100DataSetIterator": (lambda m: m.Cifar100DataSetIterator(
        40, useCoarseLabels=True, num_examples=80), 1),
    "LFWDataSetIterator": (lambda m: m.LFWDataSetIterator(
        8, num_examples=12, imgDim=(32, 32, 3), numLabels=5), 1),
    "IrisDataSetIterator": (lambda m: m.IrisDataSetIterator(40), 2),
    "SyntheticImageNetIterator": (lambda m: m.SyntheticImageNetIterator(
        4, num_examples=10, height=16, width=16, num_classes=20), 1),
    "SvhnDataSetIterator": (lambda m: m.SvhnDataSetIterator(
        50, num_examples=60), 1),
    "TinyImageNetDataSetIterator": (lambda m: m.TinyImageNetDataSetIterator(
        25, num_examples=30), 1),
    "UciSequenceDataSetIterator": (lambda m: m.UciSequenceDataSetIterator(
        100, train=False), 1),
    "ListDataSetIterator": (lambda m: m.ListDataSetIterator(
        _list_sets(m), 15), 2),
    "ListMultiDataSetIterator": (lambda m: m.ListMultiDataSetIterator(
        _multi_sets(m)), 1),
}


def _arrays(ds):
    if hasattr(ds, "featuresMasks"):
        return list(ds.features) + list(ds.labels)
    return [ds.features, ds.labels, ds.featuresMask, ds.labelsMask]


@pytest.mark.parametrize("case", sorted(ITERATORS))
def test_iterator_yields_the_jax_package_batches(case):
    make, epochs = ITERATORS[case]
    it_t, it_j = make(tds), make(jds)
    for _ in range(epochs):
        got, want = list(it_t), list(it_j)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            for x, y in zip(_arrays(a), _arrays(b)):
                if y is None:
                    assert x is None
                else:
                    y = np.asarray(y)
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    if hasattr(it_j, "asyncSupported"):
        assert it_t.asyncSupported() == it_j.asyncSupported()
    for attr in ("totalOutcomes", "inputColumns", "numExamples"):
        if hasattr(it_j, attr):
            assert getattr(it_t, attr)() == getattr(it_j, attr)()


def test_async_iterator_prefetches_the_same_batches():
    base = tds.IrisDataSetIterator(30)
    got = list(tds.AsyncDataSetIterator(base, queue_size=2))
    want = list(tds.IrisDataSetIterator(30))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.features, b.features)


def test_exhausted_iterator_raises_and_reset_restarts():
    it = tds.IrisDataSetIterator(150)
    it.next()
    with pytest.raises(StopIteration):
        it.next()
    it.reset()
    assert it.hasNext() and it.batch() == 150


# -- the evaluation loop -------------------------------------------------------
def _net():
    conf = (NeuralNetConfiguration.Builder().seed(4).updater(Adam(1e-2))
            .activation("tanh").list()
            .layer(DenseLayer(nOut=12))
            .layer(OutputLayer(lossFunction="mcxent", nOut=3,
                               activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())
    return MultiLayerNetwork(conf).init("cpu")


def test_evaluation_loop_stages_features_and_keeps_labels_on_the_host():
    net = _net()
    net.fit(tds.IrisDataSetIterator(50), epochs=5)
    staged = net.evaluate(tds.IrisDataSetIterator(40), prefetch=2)
    direct = net.evaluate(tds.IrisDataSetIterator(40), prefetch=0)
    np.testing.assert_array_equal(staged.confusionMatrix(),
                                  direct.confusionMatrix())
    one = pipeline.stage_for_eval(tds.DataSet(np.ones((2, 4), np.float32),
                                              np.eye(2, dtype=np.float32)),
                                  "cpu")
    assert isinstance(one.labels, np.ndarray) and one.features.shape == (2, 4)


def test_evaluation_loop_fires_its_fault_site():
    net = _net()
    plan = faults.FaultPlan(seed=1).fail_at(faults.EVAL_FORWARD, 3)
    with plan:
        with pytest.raises(InjectedFault):
            net.evaluate(tds.IrisDataSetIterator(30), prefetch=0)
    assert plan.calls(faults.EVAL_FORWARD) == 3
    assert plan.fired[faults.EVAL_FORWARD] == 1
    assert net.evaluate(tds.IrisDataSetIterator(30))._count == 150

"""The port's recurrent, sequence and embedding layers (nn/conf/recurrent.py,
nn/conf/sequence_layers.py, the sequence front ends of nn/conf/layers.py),
truncated BPTT and rnnTimeStep against the JAX package on the CPU: the same
seeded numpy inputs and masks, and the same parameters carried across by
`multilayer_params_from_numpy`, go through both packages. Then the masked
hold contract and the recurrent vertices of ComputationGraph.

Tolerance: 1e-5 relative to max(1, max |JAX|) in f32 (sums in another
order), for outputs, scores, gradients and parameters after training
steps (Sgd, whose step is linear in the gradient)."""
import types

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.conf.graph_vertices as jgv
import deeplearning4j_tpu.nn.conf.layers as jlayers
import deeplearning4j_tpu.nn.conf.recurrent as jrec
import deeplearning4j_tpu.nn.conf.sequence_layers as jseq
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.datasets import DataSet

B, T, F, C = 4, 10, 6, 3
TOL = 1e-5


def _ns(nn, layers, rec, seq, gv):
    return types.SimpleNamespace(
        nn=nn, LSTM=rec.LSTM, GravesLSTM=rec.GravesLSTM,
        SimpleRnn=rec.SimpleRnn, Bidirectional=rec.Bidirectional,
        RnnOutputLayer=rec.RnnOutputLayer, LastTimeStep=rec.LastTimeStep,
        GravesBidirectionalLSTM=rec.GravesBidirectionalLSTM,
        MaskLayer=seq.MaskLayer, MaskZeroLayer=seq.MaskZeroLayer,
        RnnLossLayer=seq.RnnLossLayer, DenseLayer=layers.DenseLayer,
        OutputLayer=layers.OutputLayer,
        EmbeddingLayer=layers.EmbeddingLayer,
        EmbeddingSequenceLayer=layers.EmbeddingSequenceLayer,
        TimeDistributed=layers.TimeDistributed,
        GlobalPoolingLayer=layers.GlobalPoolingLayer,
        LastTimeStepVertex=gv.LastTimeStepVertex,
        DuplicateToTimeSeriesVertex=gv.DuplicateToTimeSeriesVertex,
        ReverseTimeSeriesVertex=gv.ReverseTimeSeriesVertex)


J = _ns(jnn, jlayers, jrec, jseq, jgv)
P = _ns(tnn, tnn.layers, tnn, tnn, tnn)


def _close(got, want, what="", tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """{key: {name: array}}, a nested level joined as "sub_name" (the
    port's names for Bidirectional)."""
    out = {}
    for key, d in tree.items():
        out[key] = {}
        for name, v in d.items():
            if isinstance(v, dict):
                out[key].update({f"{name}_{n}": a for n, a in v.items()})
            else:
                out[key][name] = v
    return out


def _conf(ns, layers, input_type, updater=None, tbptt=None, accum=None):
    b = (ns.nn.NeuralNetConfiguration.Builder().seed(1)
         .updater(updater(ns) if updater else ns.nn.Sgd(0.1))
         .weightInit("xavier"))
    if accum:
        b = b.gradientAccumulation(accum)
    b = b.list()
    for layer in layers(ns):
        b.layer(layer)
    if tbptt:
        b.backpropType(ns.nn.BackpropType.TruncatedBPTT) \
            .tBPTTForwardLength(tbptt).tBPTTBackwardLength(tbptt)
    return b.setInputType(input_type(ns)).build()


def _pair(layers, input_type=lambda ns: ns.nn.InputType.recurrent(F, T),
          **kw):
    jnet = jnn.MultiLayerNetwork(_conf(J, layers, input_type, **kw)).init()
    tnet = tnn.multilayer_params_from_numpy(
        tnn.MultiLayerNetwork(_conf(P, layers, input_type, **kw)),
        _np_tree(jnet._params), _np_tree(jnet._state), device="cpu")
    return jnet, tnet


def _seq(seed=0, t=T):
    return np.random.default_rng(seed).standard_normal(
        (B, t, F)).astype(np.float32)


def _mask(lengths, t=T):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


def _labels(seed=1, t=T):
    return np.eye(C, dtype=np.float32)[
        np.random.default_rng(seed).integers(0, C, (B, t))]


def _head(ns):
    return ns.RnnOutputLayer(lossFunction="mcxent", nOut=C,
                             activation="softmax")


LAYERS = {
    "LSTM": lambda ns: [ns.LSTM(nOut=5), _head(ns)],
    "LSTM relu gates hardsigmoid": lambda ns: [
        ns.LSTM(nOut=5, activation="relu", gateActivationFn="hardsigmoid",
                forgetGateBiasInit=0.5), _head(ns)],
    "GravesLSTM": lambda ns: [ns.GravesLSTM(nOut=5), _head(ns)],
    "SimpleRnn": lambda ns: [ns.SimpleRnn(nOut=5), _head(ns)],
    "stacked LSTM, GravesLSTM": lambda ns: [ns.LSTM(nOut=7),
                                            ns.GravesLSTM(nOut=5),
                                            _head(ns)],
    "Bidirectional concat": lambda ns: [
        ns.Bidirectional(ns.LSTM(nOut=4)), _head(ns)],
    "Bidirectional add GravesLSTM": lambda ns: [
        ns.Bidirectional(ns.GravesLSTM(nOut=4), mode="add"), _head(ns)],
    "Bidirectional average SimpleRnn": lambda ns: [
        ns.Bidirectional(ns.SimpleRnn(nOut=4), mode="average"), _head(ns)],
    "Bidirectional mul": lambda ns: [
        ns.Bidirectional(ns.LSTM(nOut=4), mode="mul"), _head(ns)],
    "GravesBidirectionalLSTM": lambda ns: [
        ns.GravesBidirectionalLSTM(nOut=4), _head(ns)],
    "MaskLayer": lambda ns: [ns.LSTM(nOut=5), ns.MaskLayer(), _head(ns)],
    "MaskZeroLayer": lambda ns: [ns.MaskZeroLayer(ns.LSTM(nOut=5), 0.0),
                                 _head(ns)],
    "TimeDistributed": lambda ns: [
        ns.TimeDistributed(ns.DenseLayer(nOut=6, activation="tanh")),
        ns.SimpleRnn(nOut=5), _head(ns)],
    "RnnLossLayer": lambda ns: [ns.LSTM(nOut=C), ns.RnnLossLayer(
        lossFunction="mcxent", activation="softmax")],
    "DenseLayer over time": lambda ns: [
        ns.LSTM(nOut=5), ns.DenseLayer(nOut=4, activation="sigmoid"),
        _head(ns)],
}
LAST_STEP = {
    "LastTimeStep(LSTM)": lambda ns: [
        ns.LastTimeStep(ns.LSTM(nOut=5)),
        ns.OutputLayer(lossFunction="mcxent", nOut=C, activation="softmax")],
    "GlobalPooling avg": lambda ns: [
        ns.GravesLSTM(nOut=5), ns.GlobalPoolingLayer("avg"),
        ns.OutputLayer(lossFunction="mcxent", nOut=C, activation="softmax")],
    "GlobalPooling max": lambda ns: [
        ns.SimpleRnn(nOut=5), ns.GlobalPoolingLayer("max"),
        ns.OutputLayer(lossFunction="mcxent", nOut=C, activation="softmax")],
}
LENGTHS = [10, 7, 3, 1]


def _grads_close(tgrads, jgrads, what):
    jflat = _flat(_np_tree(jgrads))
    assert set(tgrads) == set(jflat), what
    for key, d in jflat.items():
        assert set(tgrads[key]) == set(d), (what, key)
        for name, g in d.items():
            _close(tgrads[key][name], g, f"{what} grad {key}.{name}")


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_sequence_layers_match_the_jax_package(name):
    """Output unmasked and under ragged feature masks, the masked score
    (label mask = feature mask) and every parameter's gradient."""
    jnet, tnet = _pair(LAYERS[name])
    x, y, m = _seq(), _labels(), _mask(LENGTHS)
    _close(tnet.output(x), np.asarray(jnet.output(x).numpy()), name)
    _close(tnet.output(x, fmask=m),
           np.asarray(jnet.output(x, fmask=m).numpy()), f"{name} masked")
    jds, tds = JDataSet(x, y), DataSet(x, y)
    jds.featuresMask = jds.labelsMask = m
    tds.featuresMask = tds.labelsMask = m
    _close(tnet.score(tds), jnet.score(jds), f"{name} score")
    _grads_close(tnet.computeGradients(x, y, m, m),
                 jnet.computeGradients(x, y, m, m), name)


@pytest.mark.parametrize("name", sorted(LAST_STEP))
def test_last_step_heads_match_the_jax_package(name):
    jnet, tnet = _pair(LAST_STEP[name])
    x, m = _seq(2), _mask(LENGTHS)
    y = np.eye(C, dtype=np.float32)[[0, 1, 2, 1]]
    _close(tnet.output(x, fmask=m),
           np.asarray(jnet.output(x, fmask=m).numpy()), name)
    _grads_close(tnet.computeGradients(x, y, m),
                 jnet.computeGradients(x, y, m), name)


def test_embedding_front_ends_match_the_jax_package():
    """EmbeddingSequenceLayer over (B, T) token ids into an LSTM, and
    EmbeddingLayer over (B,) ids and one-hot rows."""
    jnet, tnet = _pair(
        lambda ns: [ns.EmbeddingSequenceLayer(nIn=11, nOut=6),
                    ns.LSTM(nOut=5), _head(ns)],
        input_type=lambda ns: ns.nn.InputType.recurrent(1, T))
    ids = np.random.default_rng(3).integers(0, 11, (B, T)).astype(
        np.float32)
    m = _mask(LENGTHS)
    _close(tnet.output(ids, fmask=m),
           np.asarray(jnet.output(ids, fmask=m).numpy()), "embed seq")
    _grads_close(tnet.computeGradients(ids, _labels(), m, m),
                 jnet.computeGradients(ids, _labels(), m, m), "embed seq")
    jnet, tnet = _pair(
        lambda ns: [ns.EmbeddingLayer(nIn=7, nOut=8, hasBias=True),
                    ns.OutputLayer(lossFunction="mcxent", nOut=C,
                                   activation="softmax")],
        input_type=lambda ns: ns.nn.InputType.feedForward(7))
    idx = np.array([[3], [0], [6], [2]], np.int32)
    onehot = np.eye(7, dtype=np.float32)[idx[:, 0]]
    for x in (idx, onehot):
        _close(tnet.output(x), np.asarray(jnet.output(x).numpy()),
               f"embed {x.dtype}")


def test_truncated_bptt_matches_the_jax_package():
    """Three segments of 4 steps (T = 12), two batches with Sgd(0.1):
    every segment is one update and the carries thread across segments;
    the parameters after each batch and the score (the mean segment loss)
    equal the JAX package's."""
    layers = lambda ns: [ns.LSTM(nOut=6), ns.GravesLSTM(nOut=5),  # noqa
                         _head(ns)]
    jnet, tnet = _pair(layers, tbptt=4)
    for seed in (0, 1):
        x, y = _seq(seed, t=12), _labels(seed + 5, t=12)
        m = _mask([12, 9, 5, 12], t=12)
        jds, tds = JDataSet(x, y), DataSet(x, y)
        jds.featuresMask = jds.labelsMask = m
        tds.featuresMask = tds.labelsMask = m
        jnet.fit(jds)
        tnet.fit(tds)
        _close(tnet.score(), jnet.score(), "tbptt score")
        jp = _flat(_np_tree(jnet._params))
        for key, d in jp.items():
            for name, v in d.items():
                _close(tnet._params[key][name], v, f"tbptt {key}.{name}")
    assert tnet.getIterationCount() == jnet.getIterationCount() == 2


def test_truncated_bptt_makes_one_update_a_segment_under_accumulation():
    """Under TruncatedBPTT, `fit` on an iterable runs each batch through its
    segments, one update a segment, whatever `.gradientAccumulation(2)`
    says (the JAX package's rule, deeplearning4j_tpu/nn/multilayer.py:
    909-910): LSTM(5) and an RnnOutputLayer, T = 12 in segments of 4, two
    batches of 4, Sgd(0.1). The iteration count and every parameter equal
    the JAX package's to 1e-6."""
    layers = lambda ns: [ns.LSTM(nOut=5), _head(ns)]  # noqa: E731
    jnet, tnet = _pair(layers, tbptt=4, accum=2)
    data = [(_seq(seed, t=12), _labels(seed + 5, t=12)) for seed in (0, 1)]
    jnet.fit([JDataSet(x, y) for x, y in data])
    tnet.fit([DataSet(x, y) for x, y in data])
    assert tnet.getIterationCount() == jnet.getIterationCount() == 2
    _close(tnet.score(), jnet.score(), "score", tol=1e-6)
    for key, d in _flat(_np_tree(jnet._params)).items():
        for name, v in d.items():
            _close(tnet._params[key][name], v, f"{key}.{name}", tol=1e-6)


def test_rnn_time_step_matches_the_jax_package():
    """rnnTimeStep over (B, F) and (B, t, F) chunks threads the carries
    like the JAX package, and the steps together equal output() on the
    whole sequence; rnnClearPreviousState starts over."""
    jnet, tnet = _pair(LAYERS["stacked LSTM, GravesLSTM"])
    x = _seq(4)
    outs = []
    for sl in (slice(0, 1), slice(1, 4), slice(4, 5), slice(5, 10)):
        xs = x[:, sl][:, 0] if sl.stop - sl.start == 1 else x[:, sl]
        t_out, j_out = tnet.rnnTimeStep(xs), jnet.rnnTimeStep(xs)
        _close(t_out, np.asarray(j_out.numpy()), f"rnnTimeStep {sl}")
        outs.append(t_out if t_out.ndim == 3 else t_out[:, None])
    _close(torch.cat(outs, dim=1), tnet.output(x).numpy(), "steps vs whole")
    for i in ("0", "1"):
        for a, b in zip(tnet.rnnGetPreviousState(int(i)),
                        jnet.rnnGetPreviousState(int(i))):
            _close(a, np.asarray(b), f"carry {i}")
    tnet.rnnClearPreviousState()
    assert tnet.rnnGetPreviousState(0) is None
    _close(tnet.rnnTimeStep(x[:, 0]), tnet.output(x[:, :1])[:, 0].numpy(),
           "after clear")


@pytest.mark.parametrize("layer", ["LSTM", "GravesLSTM", "SimpleRnn"])
def test_masked_steps_hold_the_carry_exactly(layer):
    """A masked step emits zeros and holds the carry by an exact select:
    with steps 2, 3 and 6 masked, the valid outputs and the final carry
    equal those of the sequence with those steps removed, bit for bit,
    and NaN inputs at the masked steps reach nothing."""
    net = tnn.MultiLayerNetwork(_conf(
        P, lambda ns: [getattr(ns, layer)(nOut=5), _head(ns)],
        lambda ns: ns.nn.InputType.recurrent(F, T))).init("cpu")
    cell, params = net.layers[0], net._params["0"]
    x = torch.from_numpy(_seq(6))
    keep = [0, 1, 4, 5, 7, 8, 9]
    m = torch.zeros(B, T)
    m[:, keep] = 1
    xn = x.clone()
    xn[:, [2, 3, 6]] = float("nan")
    y, carry = cell.scan_apply(params, xn, None, m)
    y_short, carry_short = cell.scan_apply(params, x[:, keep], None, None)
    assert torch.isfinite(y).all()
    assert torch.equal(y[:, keep], y_short)
    assert (y[:, [2, 3, 6]] == 0).all()
    for a, b in zip(carry, carry_short):
        assert torch.equal(a, b)


def _vertex_graph(ns, vertex, parents, size):
    g = (ns.nn.NeuralNetConfiguration.Builder().seed(3)
         .updater(ns.nn.Sgd(0.1)).graphBuilder().addInputs("in")
         .setInputTypes(ns.nn.InputType.recurrent(F, T))
         .addLayer("rnn", ns.LSTM(nOut=5), "in")
         .addLayer("ff", ns.LastTimeStep(ns.SimpleRnn(nOut=4)), "in")
         .addVertex("v", vertex(ns), *parents))
    out = (ns.RnnOutputLayer(lossFunction="mcxent", nOut=C,
                             activation="softmax") if size == "seq"
           else ns.OutputLayer(lossFunction="mcxent", nOut=C,
                               activation="softmax"))
    return g.addLayer("out", out, "v").setOutputs("out").build()


VERTICES = {
    "LastTimeStepVertex": (lambda ns: ns.LastTimeStepVertex("in"),
                           ("rnn",), "ff"),
    "ReverseTimeSeriesVertex": (lambda ns: ns.ReverseTimeSeriesVertex("in"),
                                ("rnn",), "seq"),
    "DuplicateToTimeSeriesVertex": (
        lambda ns: ns.DuplicateToTimeSeriesVertex("in"), ("ff", "rnn"),
        "seq"),
}


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_recurrent_vertices_match_the_jax_package(name):
    """ComputationGraph with the recurrent vertices under a ragged feature
    mask: output, score and gradients; and the graph's rnnTimeStep."""
    vertex, parents, size = VERTICES[name]
    jnet = JGraph(
        _vertex_graph(J, vertex, parents, size)).init()
    tnet = tnn.graph_params_from_numpy(
        tnn.ComputationGraph(_vertex_graph(P, vertex, parents, size)),
        _np_tree(jnet._params), _np_tree(jnet._state), device="cpu")
    x, m = _seq(7), _mask(LENGTHS)
    _close(tnet.output(x, fmasks={"in": m}),
           np.asarray(jnet.output(x, fmasks={"in": m}).numpy()), name)
    y = _labels(8) if size == "seq" else np.eye(C, dtype=np.float32)[
        [2, 0, 1, 1]]
    jds, tds = JDataSet(x, y), DataSet(x, y)
    jds.featuresMask = tds.featuresMask = m
    _close(tnet.score(tds), jnet.score(jds), f"{name} score")
    if name != "ReverseTimeSeriesVertex":
        # a reversal under a mask cannot run step by step
        _close(tnet.rnnTimeStep(x[:, 0]),
               np.asarray(jnet.rnnTimeStep(x[:, 0]).numpy()),
               f"{name} rnnTimeStep")

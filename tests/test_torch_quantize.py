"""The port's int8 path (quantize/: core, policy, calibrate, infer, traffic)
against the JAX package on the CPU, with the contracts of
tests/test_quantize.py mirrored on the port.

The same seeded numpy inputs go through both packages, the JAX weights
carried across with `nn/convert.py`. On the CPU the port's "dot" route
runs `int8_matmul_epilogue`'s plain version (exact f64 sums), the JAX
package's `lax.dot_general` int32 product; "chain" is plain f32 in both.

Tolerances: int8 weight bytes, the scales of BN-derived and default
calibration, the chain plans and `_quant_stats` exactly equal; scales
observed from data 1e-6 relative (the absmax of an activation each package
computed, f32 sums in another order); outputs and QAT training losses 1e-5
relative to max(1, max |JAX|); fake_quant and its straight-through
gradient bit for bit."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu import monitoring as jmon
from deeplearning4j_tpu import quantize as jq
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch import quantize as tq
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.quantize.infer import recalibrate
from deeplearning4j_tpu_torch.runtime.executables import (ExecutableStore,
                                                          model_fingerprint)

from test_torch_layers_rest import J, T
from test_torch_multilayer import _close, _np_tree

TOL = 1e-5


# -- fixtures: built alike in both packages -------------------------------------
def _residual_conf(nn, remat="none", wide=12, narrow=6, blocks=2, hw=6,
                   seed=7, policy=None):
    """tests/test_quantize.py's residual graph: blocks of conv1x1-BN(relu)-
    conv1x1-BN + the block input, relu."""
    b = (nn.NeuralNetConfiguration.Builder().seed(seed)
         .updater(nn.Sgd(0.05)).weightInit("relu"))
    if policy is not None:
        b.precisionPolicy(policy)
    b = (b.graphBuilder().addInputs("input")
         .setInputTypes(nn.InputType.convolutional(hw, hw, wide)))
    if remat != "none":
        b.rematPolicy(remat)
    x = "input"
    for i in range(blocks):
        b.addLayer(f"r{i}_c1", nn.ConvolutionLayer(
            kernelSize=(1, 1), nOut=narrow, convolutionMode="same",
            hasBias=False, activation="identity"), x)
        b.addLayer(f"r{i}_bn1", nn.BatchNormalization(activation="relu"),
                   f"r{i}_c1")
        b.addLayer(f"r{i}_c2", nn.ConvolutionLayer(
            kernelSize=(1, 1), nOut=wide, convolutionMode="same",
            hasBias=False, activation="identity"), f"r{i}_bn1")
        b.addLayer(f"r{i}_bn2",
                   nn.BatchNormalization(activation="identity"), f"r{i}_c2")
        b.addVertex(f"r{i}_add", nn.ElementWiseVertex("add"),
                    f"r{i}_bn2", x)
        b.addLayer(f"r{i}_relu", nn.ActivationLayer(activation="relu"),
                   f"r{i}_add")
        x = f"r{i}_relu"
    b.addLayer("pool", nn.GlobalPoolingLayer(poolingType="avg"), x)
    b.addLayer("out", nn.OutputLayer(lossFunction="mcxent", nOut=4,
                                     activation="softmax"), "pool")
    b.setOutputs("out")
    return b.build()


def _data(seed=0, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6, 6, 12)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _port_graph(jnet, conf):
    return tnn.graph_params_from_numpy(tnn.ComputationGraph(conf),
                                       _np_tree(jnet._params),
                                       _np_tree(jnet._state), device="cpu")


@pytest.fixture(scope="module")
def trained():
    """The JAX residual graph after 5 Sgd steps, and the port's graph on
    its parameters."""
    jnet = JGraph(_residual_conf(J)).init()
    x, y = _data()
    for _ in range(5):
        jnet.fit(JDataSet(x, y))
    return jnet, _port_graph(jnet, _residual_conf(T)), x


def _stats(q):
    s = dict(q._quant_stats)
    s["scales"] = {k: v[1] for k, v in s["scales"].items()}
    return s


def _plans(q):
    return sorted((repr(p.entry), p.exit, tuple(p.steps), tuple(p.keys),
                   tuple(sorted(p.taps)), p.in_key, tuple(p.out_names))
                  for p in q._chain_plans.values())


def _same_int8_params(tqn, jqn, scales_rel):
    """Every quantized layer's int8 bytes equal; its scales equal (within
    `scales_rel` relative: 0 for bit equality); every other tensor 1e-6."""
    assert set(tqn._params) == set(jqn._params)
    for name, jp in jqn._params.items():
        tp = tqn._params[name]
        assert set(tp) == set(jp), name
        for k, v in jp.items():
            got, want = tp[k].numpy(), np.asarray(v)
            assert got.dtype == want.dtype, (name, k)
            if k == "Wq":
                assert np.array_equal(got, want), name
            elif k in ("scale", "x_scale") and scales_rel == 0:
                assert np.array_equal(got, want), (name, k)
            else:
                _close(got, want, max(scales_rel, 1e-6), f"{name}/{k}")


# -- core --------------------------------------------------------------------
def test_round_trip_and_fake_quant_match_jax():
    """The codec's bytes, fake_quant's forward (per tensor and per channel)
    and its clipped straight-through gradient (tests/test_quantize.py:84-
    104), bit for bit."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((16, 8)) * 3).astype(np.float32)
    s = tq.per_channel_scales(torch.from_numpy(w), -1)
    assert np.array_equal(s.numpy(),
                          np.asarray(jq.per_channel_scales(jnp.asarray(w))))
    q = tq.quantize(torch.from_numpy(w), s, channel_axis=1)
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq.quantize(
        jnp.asarray(w), jnp.asarray(s.numpy()), channel_axis=1)))
    back = tq.dequantize(q, s, channel_axis=1)
    assert float(((back - torch.from_numpy(w)).abs()
                  / s[None, :]).max()) <= 0.5 + 1e-6
    # QAT's fake-quant as the JAX package's compiled training step runs it
    for fn in ("fake_quant_weight", "fake_quant_act"):
        for v in (w, np.random.default_rng(5).standard_normal(
                (64, 32)).astype(np.float32)):
            assert np.array_equal(
                getattr(tq, fn)(torch.from_numpy(v)).numpy(),
                np.asarray(jax.jit(getattr(jq, fn))(jnp.asarray(v))))
    x = torch.tensor([-300.0, -1.0, 0.3, 0.5, 1.0, 300.0],
                     requires_grad=True)
    sc = torch.tensor(1.0 / tq.INT8_MAX)
    tq.fake_quant(x, sc).sum().backward()
    assert x.grad.tolist() == [0.0, 1.0, 1.0, 1.0, 1.0, 0.0]
    jg = jax.grad(lambda v: jnp.sum(jq.fake_quant(v, 1.0 / jq.INT8_MAX)))(
        jnp.asarray(x.detach().numpy()))
    assert np.array_equal(x.grad.numpy(), np.asarray(jg))
    xq = torch.from_numpy(rng.integers(-127, 128, (5, 40)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (40, 3)).astype(np.int8))
    acc = tq.int8_dot(xq, wq)
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(), np.asarray(jq.int8_dot(
        jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()))))
    assert torch.equal(tq.scaled_int8_dot(xq, wq, 1.0), acc.float())


def _qat_mlp(nn):
    return (nn.NeuralNetConfiguration.Builder().seed(0).updater(nn.Sgd(0.1))
            .precisionPolicy((jq if nn is J else tq)
                             .PrecisionPolicy.int8())
            .list()
            .layer(nn.DenseLayer(nOut=16, activation="relu"))
            .layer(nn.OutputLayer(lossFunction="mcxent", nOut=3,
                                  activation="softmax"))
            .setInputType(nn.InputType.feedForward(8)).build())


def _qat_cnn(nn):
    """A QAT graph with a 3×3 conv, a 1×1 conv, a dense layer and the head
    (excluded by default)."""
    pol = (jq if nn is J else tq).PrecisionPolicy.int8()
    return (nn.NeuralNetConfiguration.Builder().seed(3).updater(nn.Sgd(0.05))
            .precisionPolicy(pol).graphBuilder().addInputs("input")
            .setInputTypes(nn.InputType.convolutional(6, 6, 3))
            .addLayer("c3", nn.ConvolutionLayer(kernelSize=(3, 3), nOut=8,
                                                activation="relu",
                                                convolutionMode="same"),
                      "input")
            .addLayer("c1", nn.ConvolutionLayer(kernelSize=(1, 1), nOut=6,
                                                activation="tanh"), "c3")
            .addLayer("pool", nn.GlobalPoolingLayer(poolingType="avg"), "c1")
            .addLayer("d", nn.DenseLayer(nOut=5, activation="relu"), "pool")
            .addLayer("out", nn.OutputLayer(lossFunction="mcxent", nOut=3,
                                            activation="softmax"), "d")
            .setOutputs("out").build())


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_qat_training_matches_jax(kind):
    """QAT fake-quant (weights per output channel, inputs per tensor,
    straight-through gradients) in both network classes: 5 steps' losses
    and the parameters after them as the JAX package's; the loss falls."""
    rng = np.random.default_rng(2)
    if kind == "multilayer":
        jnet = JMLN(_qat_mlp(J)).init()
        tnet = tnn.multilayer_params_from_numpy(
            tnn.MultiLayerNetwork(_qat_mlp(T)), _np_tree(jnet._params),
            _np_tree(jnet._state), device="cpu")
        x = rng.standard_normal((16, 8)).astype(np.float32)
    else:
        jnet = JGraph(_qat_cnn(J)).init()
        tnet = _port_graph(jnet, _qat_cnn(T))
        x = rng.standard_normal((16, 6, 6, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    losses = []
    for _ in range(5):
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        _close(tnet.score(), jnet.score(), TOL, "loss")
        losses.append(tnet.score())
    assert losses[-1] < losses[0]
    for n, d in _np_tree(jnet._params).items():
        for k, v in d.items():
            _close(tnet._params[n][k], v, TOL, f"{n}/{k}")
    if kind == "multilayer":
        grads = tnet.computeGradients(x, y)
        assert all(torch.isfinite(g).all() for d in grads.values()
                   for g in d.values())


# -- the int8 rewrite ------------------------------------------------------------
@pytest.mark.parametrize("impl", ["dot", "chain"])
def test_quantize_network_matches_jax(trained, impl):
    """quantize_network on the residual graph, observed calibration: the
    int8 bytes equal, the scales within 1e-6, the same `_quant_stats` and
    chain plans, outputs within 1e-5 of the JAX package's twin and top-1
    equal to the fp net's (tests/test_quantize.py:118-131)."""
    jnet, tnet, x = trained
    jqn = jq.quantize_network(jnet, data=[x], impl=impl)
    tqn = tq.quantize_network(tnet, data=[x], impl=impl)
    assert _stats(tqn) == _stats(jqn)
    assert _plans(tqn) == _plans(jqn)
    assert tqn._quant_stats["folded_bns"] == 4
    assert (tqn._quant_stats["chains"] >= 1) == (impl == "chain")
    _same_int8_params(tqn, jqn, 1e-6)
    for k, (s, _) in jqn._quant_stats["scales"].items():
        _close(tqn._quant_stats["scales"][k][0], s, 1e-6, k)
    out = tqn.outputSingle(x).tensor
    _close(out, jqn.outputSingle(x).numpy(), TOL, f"output {impl}")
    fp = tnet.outputSingle(x).tensor
    assert torch.equal(fp.argmax(-1), out.argmax(-1))
    assert float((fp - out).abs().max()) < 0.05
    # the source is untouched and shares no tensor with its twin
    ptrs = {v.data_ptr() for d in tnet._params.values() for v in d.values()}
    assert not ptrs & {v.data_ptr() for d in tqn._params.values()
                       for v in d.values()}


def test_bn_calibration_without_data_matches_jax(trained):
    """No calibration data (tests/test_quantize.py:163-173): the convs fed
    by a BN derive their scales from its γ/β, the rest take the default;
    every scale and int8 byte equal to the JAX package's, bit for bit."""
    jnet, tnet, x = trained
    jqn = jq.quantize_network(jnet, impl="dot")
    tqn = tq.quantize_network(tnet, impl="dot")
    srcs = {k: v[1] for k, v in tqn._quant_stats["scales"].items()}
    assert srcs["r0_c2"] == "bn-stats" and srcs["r0_c1"] == "default"
    assert tqn._quant_stats["scales"] == jqn._quant_stats["scales"]
    _same_int8_params(tqn, jqn, 0)
    _close(tqn.outputSingle(x).tensor, jqn.outputSingle(x).numpy(), TOL,
           "output")
    fp = tnet.outputSingle(x).tensor.argmax(-1)
    agree = float((fp == tqn.outputSingle(x).tensor.argmax(-1))
                  .float().mean())
    assert agree >= 0.75


def test_lenet_top1_and_fallbacks_match_jax():
    """LeNet (tests/test_quantize.py:131-144): the 5×5 convs fall back,
    the dense layer quantizes, the head stays fp; the twin's output within
    1e-5 of the JAX twin's; top-1 agreement with fp ≥ 0.95."""
    from deeplearning4j_tpu.models.zoo import LeNet as JLeNet
    from deeplearning4j_tpu_torch.models.zoo import LeNet as TLeNet
    jnet = JLeNet(numClasses=10, inputShape=(14, 14, 1)).init()
    tnet = tnn.multilayer_params_from_numpy(
        TLeNet(numClasses=10, inputShape=(14, 14, 1)).init("cpu"),
        _np_tree(jnet._params), _np_tree(jnet._state), device="cpu")
    x = np.random.default_rng(3).standard_normal(
        (32, 14, 14, 1)).astype(np.float32)
    jqn = jq.quantize_network(jnet, data=[x])
    tqn = tq.quantize_network(tnet, data=[x])
    assert _stats(tqn) == _stats(jqn)
    assert tqn._quant_stats["int8_layers"] == 1
    assert tqn._quant_stats["fallbacks"] == 2
    _same_int8_params(tqn, jqn, 1e-6)
    qo = tqn.output(x).tensor
    _close(qo, jqn.output(x).numpy(), TOL, "output")
    fp = tnet.output(x).tensor
    assert float((fp.argmax(-1) == qo.argmax(-1)).float().mean()) >= 0.95
    assert float((fp - qo).abs().max()) < 0.05
    assert list(tqn.predict(x)) == list(qo.argmax(-1).numpy())


def test_opt_outs_and_inference_only(trained):
    """tests/test_quantize.py:183-220: a policy nothing qualifies for
    raises; `.precisionPolicy(None)` on a layer opts it out of QAT and of
    the rewrite despite an inherited policy; the twin refuses to train."""
    jnet, tnet, x = trained
    conf = (tnn.NeuralNetConfiguration.Builder().seed(0)
            .updater(tnn.Sgd(0.1)).list()
            .layer(tnn.DenseLayer(nOut=8, nIn=4, activation="relu"))
            .layer(tnn.OutputLayer(lossFunction="mcxent", nOut=3,
                                   activation="softmax"))
            .setInputType(tnn.InputType.feedForward(4)).build())
    net = tnn.MultiLayerNetwork(conf).init("cpu")
    with pytest.raises(ValueError, match="nothing to quantize"):
        tq.quantize_network(net,
                            policy=tq.PrecisionPolicy.int8(min_channels=100))
    conf = (tnn.NeuralNetConfiguration.Builder().seed(0)
            .updater(tnn.Sgd(0.1))
            .precisionPolicy(tq.PrecisionPolicy.int8()).list()
            .layer(tnn.DenseLayer.Builder().nOut(16).activation("relu")
                   .precisionPolicy(None).build())
            .layer(tnn.DenseLayer(nOut=16, activation="relu"))
            .layer(tnn.OutputLayer(lossFunction="mcxent", nOut=3,
                                   activation="softmax"))
            .setInputType(tnn.InputType.feedForward(8)).build())
    assert conf.layers[0].precisionPolicy.enabled is False
    assert conf.layers[0].precisionPolicy.applies_to(conf.layers[0]) is False
    assert conf.layers[1].precisionPolicy.enabled is True
    net = tnn.MultiLayerNetwork(conf).init("cpu")
    x8 = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    # the opted-out layer runs no fake-quant: its output is the plain one
    h = net.feedForward(x8)[0].tensor
    p = net._params["0"]
    assert torch.equal(h, torch.relu(torch.from_numpy(x8) @ p["W"] + p["b"]))
    q = tq.quantize_network(net, data=[x8])
    assert not isinstance(q.layers[0], tq.QuantizedDense)
    assert isinstance(q.layers[1], tq.QuantizedDense)
    assert q._quant_stats["fallbacks"] == 1
    twin = tq.quantize_network(tnet, data=[x])
    for fn in (twin.fit, twin.computeGradients, q.fit, q.pretrain):
        with pytest.raises(RuntimeError, match="inference-only"):
            fn(None)


def test_quantize_counters_match_jax(trained):
    """tests/test_quantize.py:223-235: the rewrite counts its int8 layers,
    fallbacks and calibrations on the same metric names as the JAX
    package, and publishes the activation-traffic gauge labelled by the
    twin's fingerprint."""
    jnet, tnet, x = trained
    got = {}
    for mon, qmod, net in ((monitoring, tq, tnet), (jmon, jq, jnet)):
        mon.enable()
        try:
            reg = mon.get_registry()
            before = {n: (reg.get(n).value if reg.get(n) is not None else 0)
                      for n in (mon.QUANT_INT8_LAYERS,
                                mon.QUANT_CALIBRATIONS)}
            qn = qmod.quantize_network(net, data=[x])
            got[qmod] = {n: reg.get(n).value - v for n, v in before.items()}
            text = reg.prometheus_text()
        finally:
            mon.disable()
        assert "dl4j_quant_activation_traffic_bytes" in text
        if qmod is tq:
            assert model_fingerprint(qn)[:8] in text
    assert got[tq] == got[jq]
    assert got[tq][monitoring.QUANT_INT8_LAYERS] == 4


def test_serving_through_the_executable_store(trained, tmp_path):
    """The twin serves through the port's ExecutableStore: its fingerprint
    differs from the fp net's; the store's forward equals `output()`; a
    recalibration written in place changes the answer with no new entry
    or rebind (the tensors keep their addresses)."""
    jnet, tnet, x = trained
    q = tq.quantize_network(tnet, data=[x], impl="dot")
    assert model_fingerprint(q) != model_fingerprint(tnet)
    store = ExecutableStore(q, directory=str(tmp_path))
    sig = ((tuple(x.shape), "float32"),)
    store.warmup([sig])
    args = store.ensure(sig)
    args[0].copy_(torch.from_numpy(x))
    out = store.run(("forward", sig)).clone()
    assert torch.equal(out, q.outputSingle(x).tensor)
    before = dict(store.stats)
    key = "r0_c2"
    recalibrate(q, {key: 2.0 * float(q._params[key]["x_scale"])})
    again = store.run(("forward", sig))
    assert not torch.equal(again, out)
    assert torch.equal(again, q.outputSingle(x).tensor)
    for k in ("compiled", "captures", "live_captures", "rebinds"):
        assert store.stats[k] == before[k], k


def test_activation_report_matches_jax():
    """activation_report gives the JAX package's dictionary for the same
    configuration: plain, under block remat, and for a quantized twin."""
    for remat in ("none", "blocks"):
        tconf = _residual_conf(T, remat, wide=16, narrow=8, blocks=3, hw=8)
        jconf = _residual_conf(J, remat, wide=16, narrow=8, blocks=3, hw=8)

        class _Conf:
            def __init__(self, conf):
                self.conf = conf
        assert tq.activation_report(_Conf(tconf), batch=4) == \
            jq.activation_report(_Conf(jconf), batch=4)
    jnet = JGraph(_residual_conf(J)).init()
    tnet = _port_graph(jnet, _residual_conf(T))
    assert tq.activation_report(tq.quantize_network(tnet), batch=2) == \
        jq.activation_report(jq.quantize_network(jnet), batch=2)


def _qat_json_conf(nn, qmod):
    return (nn.NeuralNetConfiguration.Builder().seed(0)
            .updater(nn.Sgd(0.1))
            .precisionPolicy(qmod.PrecisionPolicy.int8(min_channels=2))
            .list()
            .layer(nn.DenseLayer.Builder().nOut(16).activation("relu")
                   .precisionPolicy(None).build())
            .layer(nn.DenseLayer(nOut=16, activation="relu"))
            .layer(nn.OutputLayer(lossFunction="mcxent", nOut=3,
                                  activation="softmax"))
            .setInputType(nn.InputType.feedForward(8)).build())


def test_serde_json_matches_jax(trained):
    """The JSON of a QAT configuration and of a quantized twin's
    configuration equals the JAX package's key for key; each package reads
    the other's."""
    jconf, tconf = _qat_json_conf(J, jq), _qat_json_conf(T, tq)
    want = json.loads(jconf.toJson())
    assert json.loads(tconf.toJson()) == want
    back = type(tconf).fromJson(jconf.toJson())
    assert type(back.layers[1].precisionPolicy) is tq.PrecisionPolicy
    assert back.layers[0].precisionPolicy.enabled is False
    assert json.loads(back.toJson()) == want
    assert json.loads(type(jconf).fromJson(tconf.toJson()).toJson()) == want
    jnet, tnet, x = trained
    for impl in ("dot", "chain"):
        jqn = jq.quantize_network(jnet, data=[x], impl=impl)
        tqn = tq.quantize_network(tnet, data=[x], impl=impl)
        want = json.loads(jqn.conf.toJson())
        assert json.loads(tqn.conf.toJson()) == want
        back = type(tqn.conf).fromJson(jqn.conf.toJson())
        assert type(back.nodes["r0_c1"].ref) is tq.QuantizedConv1x1
        assert type(back.nodes["r0_bn1"].ref) is tq.QuantPassthrough
        assert json.loads(back.toJson()) == want
        assert json.loads(type(jqn.conf).fromJson(
            tqn.conf.toJson()).toJson()) == want


def test_fused_pairs_skip_qat_in_both_packages(monkeypatch):
    """A defect of the JAX package that the port reproduces: with
    DL4J_TPU_FUSE_CONV_BN=1 a fused conv1x1+BN pair trains with the raw
    weights (its conv's precisionPolicy is never read), so its conv runs
    no fake-quant. Both packages agree step for step under the fusion; the
    fused net's losses equal those of the unfused net whose paired convs
    have the policy switched off, and differ from full QAT's."""
    int8 = tq.PrecisionPolicy.int8
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    jnet = JGraph(_residual_conf(J, policy=jq.PrecisionPolicy.int8())
                  ).init()
    params, state = _np_tree(jnet._params), _np_tree(jnet._state)
    assert len(jnet._fused_pairs) == 4

    def port(fuse, off=()):
        monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", fuse)
        conf = _residual_conf(T, policy=int8())
        for name in off:
            conf.nodes[name].ref.precisionPolicy = tq.PrecisionPolicy.off()
        return tnn.graph_params_from_numpy(tnn.ComputationGraph(conf),
                                           params, state, device="cpu")

    fused = port("1")
    assert fused._fused_pairs == jnet._fused_pairs
    plain_off = port("0", off=jnet._fused_pairs.values())
    plain_qat = port("0")
    x, y = _data(4)
    ds = DataSet(x, y)
    _close(fused.score(ds), plain_off.score(ds), TOL, "fused = QAT off")
    assert abs(fused.score(ds) - plain_qat.score(ds)) > 1e-5
    for _ in range(3):
        jnet.fit(JDataSet(x, y))
        for net in (fused, plain_off, plain_qat):
            net.fit(ds)
        _close(fused.score(), jnet.score(), TOL, "fused QAT loss vs JAX")
        _close(plain_off.score(), fused.score(), 1e-4, "fused = QAT off")

"""The port's builder DSL, layers, conv1x1+BN fusion pass and
ComputationGraph inference (deeplearning4j_tpu_torch/nn) against the JAX
package on the CPU. One configuration function builds the same graph in
both packages; the weights carry across as numpy
(`graph_params_from_numpy`). The JAX side runs its jitted forward, so a
fused pair goes through its Pallas epilogue kernel (interpret mode); the
port runs the kernel's plain version.

Tolerance: 1e-5 × max(1, max |JAX|) per node (f32 sums in another
order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.nn.conf.graph_vertices import \
    ElementWiseVertex as JElementWise
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.nn.conf import layers as tl

PKGS = {"jax": (jnn, JElementWise, JGraph),
        "torch": (tnn, tnn.ElementWiseVertex, tnn.ComputationGraph)}


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _resnetish_conf(pkg):
    """tests/test_fused.py's tiny bottleneck-ish graph: two fusable
    conv1x1+BN pairs (stride 1 + relu, stride 2 + identity), one
    NON-fusable pair (conv output feeds both BN and the residual add), a
    3x3 conv, and a residual join."""
    nn, EW, _ = PKGS[pkg]
    g = (nn.NeuralNetConfiguration.Builder()
         .seed(11).updater(nn.Nesterovs(0.05, 0.9)).weightInit("relu")
         .graphBuilder()
         .addInputs("input")
         .setInputTypes(nn.InputType.convolutional(8, 8, 4)))
    conv = nn.ConvolutionLayer
    bn = nn.BatchNormalization
    g.addLayer("c1", conv(kernelSize=(1, 1), nOut=8, hasBias=False,
                          activation="identity"), "input")
    g.addLayer("bn1", bn(activation="relu"), "c1")
    g.addLayer("c2", conv(kernelSize=(3, 3), nOut=8, convolutionMode="same",
                          hasBias=False, activation="identity"), "bn1")
    g.addLayer("bn2", bn(activation="identity"), "c2")
    g.addLayer("c3", conv(kernelSize=(1, 1), nOut=8, hasBias=False,
                          activation="identity"), "bn2")
    g.addLayer("bn3", bn(activation="identity"), "c3")
    g.addVertex("add", EW("add"), "bn3", "c3")
    g.addLayer("relu", nn.ActivationLayer(activation="relu"), "add")
    g.addLayer("c4", conv(kernelSize=(1, 1), stride=(2, 2),
                          convolutionMode="same", nOut=12, hasBias=False,
                          activation="identity"), "relu")
    g.addLayer("bn4", bn(activation="relu"), "c4")
    g.addLayer("pool", nn.GlobalPoolingLayer(poolingType="avg"), "bn4")
    g.addLayer("out", nn.OutputLayer(lossFunction="mcxent", nOut=3,
                                     activation="softmax"), "pool")
    g.setOutputs("out")
    return g.build()


def _data():
    rng = np.random.default_rng(5)
    return rng.standard_normal((16, 8, 8, 4)).astype(np.float32)


def _perturbed(jnet, seed=7):
    """The JAX graph's trees as numpy, with the BN parameters and running
    statistics drawn away from their init, so the fold is not the
    identity."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, jnet._params)
    state = jax.tree_util.tree_map(np.asarray, jnet._state)
    for name, st in state.items():
        n = st["mean"].shape[0]
        st["mean"] = (rng.standard_normal(n) * 0.3).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        params[name]["gamma"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        params[name]["beta"] = (rng.standard_normal(n) * 0.2).astype(
            np.float32)
    jnet._params = jax.tree_util.tree_map(jnp.asarray, params)
    jnet._state = jax.tree_util.tree_map(jnp.asarray, state)
    return params, state


def _pair_of_nets(monkeypatch, fuse):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1" if fuse else "0")
    jnet = JGraph(_resnetish_conf("jax")).init()
    params, state = _perturbed(jnet)
    tnet = tnn.graph_params_from_numpy(
        tnn.ComputationGraph(_resnetish_conf("torch")), params, state,
        device="cpu")
    return jnet, tnet


def _jax_acts(jnet, x):
    fwd = jax.jit(lambda p, s, xx: jnet._forward(p, s, {"input": xx}, False,
                                                 None)[0])
    return fwd(jnet._params, jnet._state, jnp.asarray(x))


@pytest.mark.parametrize("fuse", [False, True])
def test_every_node_matches_the_jax_jitted_forward(monkeypatch, fuse):
    jnet, tnet = _pair_of_nets(monkeypatch, fuse)
    assert tnet._fused_pairs == jnet._fused_pairs
    x = _data()
    want = _jax_acts(jnet, x)
    got = tnet.feedForward(x)
    assert set(got) == set(want)
    for name in want:
        _close(got[name].numpy(), want[name], what=name)
    _close(tnet.output(x).numpy(), want["out"], what="output")
    _close(tnet.outputSingle(x).numpy(), want["out"], what="outputSingle")


def test_fused_and_unfused_agree_within_the_port(monkeypatch):
    _, plain = _pair_of_nets(monkeypatch, False)
    _, fused = _pair_of_nets(monkeypatch, True)
    x = _data()
    a, b = plain.feedForward(x), fused.feedForward(x)
    for name in a:
        _close(b[name].numpy(), a[name].numpy(), what=name)


def test_train_mode_forward_matches_jax(monkeypatch):
    """Batch-statistics BN (no dropout in this graph), on the unfused graph
    and on the fused one (its pairs through fused_conv1x1_bn)."""
    x = _data()
    for fuse in (False, True):
        jnet, tnet = _pair_of_nets(monkeypatch, fuse)
        want = jnet.output(x, train=True).numpy()
        _close(tnet.output(x, train=True).numpy(), want, rel=1e-4)


def test_marking_picks_exactly_the_fusable_pairs(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    net = tnn.ComputationGraph(_resnetish_conf("torch")).init("cpu")
    assert net._fused_pairs == {"bn1": "c1", "bn4": "c4"}
    assert net._fused_convs == {"c1", "c4"}


def test_padded_conv1x1_not_fused(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    g = (tnn.NeuralNetConfiguration.Builder()
         .seed(3).updater(tnn.Nesterovs(0.05, 0.9))
         .graphBuilder()
         .addInputs("input")
         .setInputTypes(tnn.InputType.convolutional(8, 8, 4)))
    g.addLayer("c", tnn.ConvolutionLayer(kernelSize=(1, 1), padding=(1, 1),
                                         nOut=8, hasBias=False,
                                         activation="identity"), "input")
    g.addLayer("bn", tnn.BatchNormalization(activation="relu"), "c")
    g.addLayer("pool", tnn.GlobalPoolingLayer(poolingType="avg"), "bn")
    g.addLayer("out", tnn.OutputLayer(lossFunction="mcxent", nOut=3,
                                      activation="softmax"), "pool")
    g.setOutputs("out")
    net = tnn.ComputationGraph(g.build()).init("cpu")
    assert net._fused_pairs == {}
    assert net.output(_data()).shape == (16, 3)


def test_fusion_is_per_instance_not_per_conf(monkeypatch):
    conf = _resnetish_conf("torch")
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    fused = tnn.ComputationGraph(conf).init("cpu")
    assert fused._fused_pairs == {"bn1": "c1", "bn4": "c4"}
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "0")
    plain = tnn.ComputationGraph(conf).init("cpu")
    assert plain._fused_pairs == {}
    assert fused._fused_pairs == {"bn1": "c1", "bn4": "c4"}
    clone = fused.clone()
    assert clone._fused_pairs == {"bn1": "c1", "bn4": "c4"}
    assert plain.clone()._fused_pairs == {}
    # the clone owns its tensors
    clone._params["c1"]["W"].zero_()
    assert fused._params["c1"]["W"].abs().sum() > 0


def test_same_seed_same_parameters_and_accessors(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "0")
    a = tnn.ComputationGraph(_resnetish_conf("torch")).init("cpu")
    b = tnn.ComputationGraph(_resnetish_conf("torch")).init("cpu")
    jnet = JGraph(_resnetish_conf("jax")).init()
    assert a.numParams() == b.numParams() == jnet.numParams()
    assert torch.equal(a.params(), b.params())
    assert a.params().shape == (a.numParams(),)
    assert set(a.paramTable()) == set(jnet.paramTable())
    assert a.getLayer("c2").kernelSize == (3, 3)
    back_p, back_s = tnn.graph_params_to_numpy(a)
    assert jax.tree_util.tree_structure(back_p) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, jnet._params))
    assert set(back_s) == {"bn1", "bn2", "bn3", "bn4"}


def test_converter_checks_nodes_keys_and_shapes(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "0")
    jnet = JGraph(_resnetish_conf("jax")).init()
    params, state = _perturbed(jnet)
    net = tnn.ComputationGraph(_resnetish_conf("torch"))
    bad = {k: dict(v) for k, v in params.items()}
    bad["c2"]["W"] = np.zeros((1, 1, 8, 8), np.float32)
    with pytest.raises(ValueError, match=r"params\.c2\.W: expected shape"):
        tnn.graph_params_from_numpy(net, bad, state, device="cpu")
    bad = {k: v for k, v in params.items() if k != "out"}
    with pytest.raises(ValueError, match="expected nodes"):
        tnn.graph_params_from_numpy(net, bad, state, device="cpu")
    bad = {k: dict(v) for k, v in state.items()}
    bad["bn1"].pop("var")
    with pytest.raises(ValueError, match=r"state\.bn1: expected keys"):
        tnn.graph_params_from_numpy(net, params, bad, device="cpu")


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type and text are compared
        return type(e), str(e)
    return None, None


def _graph(pkg, layer, input_type, inputs=True, outputs=True):
    nn, _, G = PKGS[pkg]
    g = nn.NeuralNetConfiguration.Builder().seed(1).graphBuilder()
    if inputs:
        g.addInputs("input").setInputTypes(input_type)
    g.addLayer("l", layer(nn), "input")
    if outputs:
        g.setOutputs("l")
    return G(g.build()).init(**({} if pkg == "jax" else {"device": "cpu"}))


_BAD = {
    "unknown activation": lambda nn: nn.DenseLayer(nOut=3,
                                                   activation="relux"),
    "activation parameter": lambda nn: nn.DenseLayer(
        nOut=3, activation="relu:2"),
    "unknown weight init": lambda nn: nn.DenseLayer(nOut=3,
                                                    weightInit="bogus"),
    "unknown loss": lambda nn: nn.OutputLayer(lossFunction="bogus", nOut=3),
    "dense without nOut": lambda nn: nn.DenseLayer(),
    "conv without nOut": lambda nn: nn.ConvolutionLayer(kernelSize=(3, 3)),
    "unknown pooling": lambda nn: nn.SubsamplingLayer(poolingType="l3"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_build_errors_match_the_jax_package(case):
    conv_input = case in ("conv without nOut", "unknown pooling")
    input_types = {"jax": jnn.InputType, "torch": tnn.InputType}
    got = {}
    for pkg in ("jax", "torch"):
        it = (input_types[pkg].convolutional(6, 6, 2) if conv_input
              else input_types[pkg].feedForward(4))
        got[pkg] = _error(lambda: _graph(pkg, _BAD[case], it)
                          if case != "unknown pooling" else
                          _graph(pkg, _BAD[case], it).output(
                              np.zeros((1, 6, 6, 2), np.float32)))
    assert got["torch"][0] is ValueError
    assert got["torch"] == got["jax"]


def test_structural_errors_match_the_jax_package():
    for kw in ({"inputs": False}, {"outputs": False}):
        got = [_error(lambda: _graph(
            pkg, lambda nn: nn.DenseLayer(nOut=2),
            PKGS[pkg][0].InputType.feedForward(3), **kw))
            for pkg in ("jax", "torch")]
        assert got[0] == got[1] and got[1][0] is ValueError
    # a cycle, and an unknown input name
    for edges in ((("a", "b"), ("b", "a")), (("a", "nope"),)):
        got = []
        for pkg in ("jax", "torch"):
            nn = PKGS[pkg][0]
            g = (nn.NeuralNetConfiguration.Builder().graphBuilder()
                 .addInputs("input")
                 .setInputTypes(nn.InputType.feedForward(3)))
            for name, src in edges:
                g.addLayer(name, nn.DenseLayer(nOut=3), src)
            g.setOutputs(edges[0][0])
            got.append(_error(g.build))
        assert got[0] == got[1] and got[1][0] is ValueError
    # every loss name of the JAX package resolves at build; an unknown one
    # is a ValueError there too
    tl.OutputLayer(lossFunction="mse", nOut=2).apply_defaults({})
    with pytest.raises(ValueError, match="Unknown loss"):
        tl.OutputLayer(lossFunction="msee", nOut=2).apply_defaults({})


@pytest.mark.parametrize("size,k,s,mode", [(32, 7, 2, "same"),
                                           (15, 3, 2, "same"),
                                           (9, 3, 1, "truncate")])
def test_convolution_padding_matches_jax(size, k, s, mode):
    """The stem's 7×7/2 SAME conv pads (2, 3): uneven, through F.pad."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    kw = dict(kernelSize=(k, k), stride=(s, s), nIn=3, nOut=5,
              convolutionMode=mode, padding=(1, 1), activation="identity")
    jy = jnn.ConvolutionLayer(**kw).apply(
        {"W": jnp.asarray(w), "b": jnp.asarray(b)}, {}, jnp.asarray(x))[0]
    ty = tnn.ConvolutionLayer(**kw).apply(
        {"W": torch.from_numpy(w), "b": torch.from_numpy(b)}, {},
        torch.from_numpy(x))[0]
    _close(ty.numpy(), jy)


def test_space_to_depth_stem_is_the_plain_conv():
    """The JAX stem computes the conv in space-to-depth form (a TPU
    trick); the port keeps the field and computes the plain conv."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 3, 8)) * 0.1).astype(np.float32)
    kw = dict(kernelSize=(7, 7), stride=(2, 2), nIn=3, nOut=8,
              convolutionMode="same", hasBias=False, spaceToDepth=2,
              activation="identity")
    jy = jnn.ConvolutionLayer(**kw).apply({"W": jnp.asarray(w)}, {},
                                          jnp.asarray(x))[0]
    ty = tnn.ConvolutionLayer(**kw).apply({"W": torch.from_numpy(w)}, {},
                                          torch.from_numpy(x))[0]
    assert ty.shape == (2, 16, 16, 8)
    _close(ty.numpy(), jy)


@pytest.mark.parametrize("pooling,size,mode", [("max", 16, "same"),
                                               ("max", 112, "same"),
                                               ("avg", 15, "same"),
                                               ("avg", 9, "truncate"),
                                               ("max", 9, "truncate")])
def test_pooling_padding_matches_jax(pooling, size, mode):
    """stem_pool's 3×3/2 SAME max pool on 112 pads (0, 1) with -inf; SAME
    avg pooling divides by the count of real inputs."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    kw = dict(poolingType=pooling, kernelSize=(3, 3), stride=(2, 2),
              convolutionMode=mode, padding=(1, 1))
    jy = jnn.SubsamplingLayer(**kw).apply({}, {}, jnp.asarray(x))[0]
    ty = tnn.SubsamplingLayer(**kw).apply({}, {}, torch.from_numpy(x))[0]
    _close(ty.numpy(), jy)


def test_activation_catalog_matches_jax():
    from deeplearning4j_tpu.nn.activations import (ACTIVATIONS,
                                                   get_activation as jget)
    from deeplearning4j_tpu_torch.nn.activations import \
        get_activation as tget
    x = np.linspace(-4, 4, 41).astype(np.float32)
    for name in sorted(ACTIVATIONS) + ["leakyrelu:0.2", "relucap:2",
                                       "thresholdedrelu:0.5"]:
        _close(tget(name)(torch.from_numpy(x)).numpy(),
               jget(name)(jnp.asarray(x)), rel=2e-6, what=name)

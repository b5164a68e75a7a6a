"""Activation remat in the port: per-layer `remat`,
`rematPolicy("layers")` (both network classes) and `rematPolicy("blocks")`
(ComputationGraph, over `conf.remat_plan()`). A remat step equals the
plain step bit for bit inside the port (dropout included: the recompute
reads the forward's draws back), BN running state is written once, the
JAX package's rule that block remat skips a graph with fused pairs holds,
and a blocks-remat step agrees with the JAX package's remat step to
1e-5."""
import collections

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import nn
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import \
    ElementWiseVertex
from deeplearning4j_tpu_torch.resilience import guardian as guardian_mod


def _residual_conf(pkg_nn, EW, policy="none", drop=0.0, blocks=3,
                   act="relu"):
    """A stem and `blocks` residual blocks (conv3x3 + BN, conv3x3 + BN,
    add, activation), global pooling and a softmax head."""
    g = (pkg_nn.NeuralNetConfiguration.Builder()
         .seed(11).updater(pkg_nn.Sgd(0.05)).weightInit("relu")
         .graphBuilder().rematPolicy(policy)
         .addInputs("input")
         .setInputTypes(pkg_nn.InputType.convolutional(6, 6, 3)))
    conv, bn = pkg_nn.ConvolutionLayer, pkg_nn.BatchNormalization
    g.addLayer("stem", conv(kernelSize=(3, 3), nOut=4,
                            convolutionMode="same", activation=act), "input")
    prev = "stem"
    for i in range(blocks):
        g.addLayer(f"a{i}", conv(kernelSize=(3, 3), nOut=4, hasBias=False,
                                 convolutionMode="same",
                                 activation="identity", dropOut=drop), prev)
        g.addLayer(f"abn{i}", bn(activation=act), f"a{i}")
        g.addLayer(f"b{i}", conv(kernelSize=(3, 3), nOut=4, hasBias=False,
                                 convolutionMode="same",
                                 activation="identity"), f"abn{i}")
        g.addLayer(f"bbn{i}", bn(activation="identity"), f"b{i}")
        g.addVertex(f"add{i}", EW("add"), f"bbn{i}", prev)
        g.addLayer(f"out{i}", pkg_nn.ActivationLayer(activation=act),
                   f"add{i}")
        prev = f"out{i}"
    g.addLayer("pool", pkg_nn.GlobalPoolingLayer(poolingType="avg"), prev)
    g.addLayer("out", pkg_nn.OutputLayer(lossFunction="mcxent", nOut=3,
                                         activation="softmax",
                                         dropOut=drop), "pool")
    g.setOutputs("out")
    return g.build()


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.standard_normal((8, 6, 6, 3)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(n)]


def _state(net):
    return [t.detach().clone() for t in
            [net._params[n][k] for n in sorted(net._params)
             for k in sorted(net._params[n])]
            + [net._state[n][k] for n in sorted(net._state)
               for k in sorted(net._state[n])]]


def _assert_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(autouse=True)
def _clean():
    yield
    guardian_mod.clear_guardian()


@pytest.mark.parametrize("drop", [0.0, 0.7])
def test_block_remat_steps_equal_plain_bit_for_bit(drop):
    nets = {}
    for policy in ("none", "blocks"):
        net = nn.ComputationGraph(_residual_conf(
            nn, ElementWiseVertex, policy, drop)).init(device="cpu")
        for ds in _batches():
            net.fit(ds)
        nets[policy] = net
    _assert_equal(_state(nets["none"]), _state(nets["blocks"]))
    assert nets["none"].score() == nets["blocks"].score()


def test_block_remat_runs_the_plan_and_recomputes_in_the_backward():
    conf = _residual_conf(nn, ElementWiseVertex, "blocks")
    plan = conf.remat_plan()
    assert len(plan) >= 4, "stem, three blocks and the head"
    net = nn.ComputationGraph(conf).init(device="cpu")
    calls = []
    real = net._run_node_plain
    net._run_node_plain = lambda *a, **k: (calls.append(a[0]),
                                           real(*a, **k))[1]
    ins, labels, lmasks = net._unpack(_batches(1)[0])
    loss, grads, _ = net._value_and_grad(ins, labels, lmasks)
    nodes = [n for seg, _ in plan for n in seg]
    counts = collections.Counter(calls)
    assert set(counts) == set(nodes)
    # every convolution and BN runs in the forward and once more in the
    # backward (the recompute stops early once the saved tensors it needs
    # exist, so a trailing pooling node may run once)
    for n in nodes:
        assert counts[n] == (2 if n[0] in "ab" or n == "stem"
                             else counts[n]), (n, counts)
        assert 1 <= counts[n] <= 2


def test_block_remat_skips_fused_pairs_masks_and_carries(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    g = (nn.NeuralNetConfiguration.Builder().seed(3).updater(nn.Sgd(0.1))
         .graphBuilder().rematPolicy("blocks").addInputs("input")
         .setInputTypes(nn.InputType.convolutional(4, 4, 3))
         .addLayer("c", nn.ConvolutionLayer(kernelSize=(1, 1), nOut=4,
                                            hasBias=False,
                                            activation="identity"), "input")
         .addLayer("bn", nn.BatchNormalization(activation="relu"), "c")
         .addLayer("pool", nn.GlobalPoolingLayer(poolingType="avg"), "bn")
         .addLayer("out", nn.OutputLayer(lossFunction="mcxent", nOut=2,
                                         activation="softmax"), "pool")
         .setOutputs("out").build())
    net = nn.ComputationGraph(g).init(device="cpu")
    assert net._fused_pairs, "the 1x1 conv + BN pair is fused"
    net._forward_remat_blocks = None       # must not be reached
    rng = np.random.default_rng(1)
    net.fit(DataSet(rng.standard_normal((4, 4, 4, 3)).astype(np.float32),
                    np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]))
    assert net.getIterationCount() == 1


def _mln_conf(remat_policy=None, per_layer=False, drop=0.5):
    b = (nn.NeuralNetConfiguration.Builder().seed(5)
         .updater(nn.Nesterovs(0.05, 0.9)).list())
    if remat_policy:
        b = b.rematPolicy(remat_policy)
    return (b
            .layer(nn.ConvolutionLayer(kernelSize=(3, 3), nOut=4,
                                       activation="relu"))
            .layer(nn.BatchNormalization(activation="relu"))
            .layer(nn.SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                       stride=(2, 2)))
            .layer(nn.DenseLayer(nOut=16, activation="relu", dropOut=drop,
                                 remat=per_layer or None))
            .layer(nn.OutputLayer(nOut=3, lossFunction="mcxent",
                                  activation="softmax"))
            .setInputType(nn.InputType.convolutional(8, 8, 2)).build())


@pytest.mark.parametrize("how", ["layers", "one_layer"])
def test_multilayer_remat_steps_equal_plain(how):
    rng = np.random.default_rng(2)
    data = [DataSet(rng.standard_normal((6, 8, 8, 2)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)])
            for _ in range(3)]
    plain = nn.MultiLayerNetwork(_mln_conf()).init(device="cpu")
    conf = _mln_conf("layers") if how == "layers" \
        else _mln_conf(per_layer=True)
    assert any(getattr(l, "remat", False) for l in conf.layers)
    remat = nn.MultiLayerNetwork(conf).init(device="cpu")
    for ds in data:
        plain.fit(ds)
        remat.fit(ds)
    _assert_equal(_state(plain), _state(remat))


def test_remat_under_the_guardian_equals_plain():
    from deeplearning4j_tpu_torch.resilience.guardian import \
        TrainingGuardian
    plain = nn.ComputationGraph(_residual_conf(
        nn, ElementWiseVertex)).init(device="cpu")
    remat = nn.ComputationGraph(_residual_conf(
        nn, ElementWiseVertex, "blocks")).init(device="cpu")
    for ds in _batches():
        plain.fit(ds)
    with TrainingGuardian(check_every=2) as g:
        for ds in _batches():
            remat.fit(ds)
    assert g.step == 3 and g.skipped == 0
    _assert_equal(_state(plain), _state(remat))


@pytest.mark.parametrize("how", ["float", "Dropout", "AlphaDropout",
                                 "SpatialDropout", "DropConnect"])
def test_remat_tape_keeps_boolean_dropout_masks(how):
    """The remat tape keeps each dropout draw as its one-byte keep mask,
    not the f32 uniform draw behind it, and the recompute reads that mask
    back instead of drawing."""
    from deeplearning4j_tpu_torch.nn._network import _DrawTape
    from deeplearning4j_tpu_torch.nn.conf.weightnoise import DropConnect
    x = torch.randn(4, 3, 3, 5)
    if how == "DropConnect":
        def draw(g):
            return DropConnect(0.7).apply_to_params({"W": x}, g)["W"]
    else:
        layer = nn.DenseLayer(nOut=2, dropOut=(
            0.7 if how == "float" else getattr(nn, how)(0.7)))

        def draw(g):
            return layer._dropout_in(x, True, g)
    tape = []
    with _DrawTape(tape, replay=False):
        first = draw(torch.Generator().manual_seed(0))
    assert [t.dtype for t in tape] == [torch.bool]
    with _DrawTape(tape, replay=True):
        again = draw(torch.Generator().manual_seed(1))
    assert torch.equal(first, again)


def test_block_remat_step_matches_the_jax_package():
    """One Sgd step of the 3-block graph under rematPolicy("blocks") in
    both packages, from the same parameters: parameters and BN state to
    1e-5 (tanh activations, so no relu mask sits within f32 noise of 0)."""
    import jax

    from deeplearning4j_tpu import nn as jnn
    from deeplearning4j_tpu.nn.conf.graph_vertices import \
        ElementWiseVertex as JEW
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    jnet = JGraph(_residual_conf(jnn, JEW, "blocks",
                                               act="tanh")).init()
    params = jax.tree_util.tree_map(np.asarray, jnet._params)
    state = jax.tree_util.tree_map(np.asarray, jnet._state)
    tnet = nn.graph_params_from_numpy(
        nn.ComputationGraph(_residual_conf(nn, ElementWiseVertex, "blocks",
                                           act="tanh")),
        params, state, device="cpu")
    ds = _batches(1)[0]
    jnet.fit(JDataSet(ds.features, ds.labels))
    tnet.fit(ds)
    from deeplearning4j_tpu_torch.nn.convert import jax_tree
    for tree, jtree in ((tnet._params, jnet._params),
                        (tnet._state, jnet._state)):
        got = jax_tree(tnet, {n: {k: v.numpy() for k, v in d.items()}
                              for n, d in tree.items()})
        for n in got:
            for k in got[n]:
                np.testing.assert_allclose(
                    got[n][k], np.asarray(jtree[n][k]), rtol=1e-5,
                    atol=1e-5, err_msg=f"{n}/{k}")

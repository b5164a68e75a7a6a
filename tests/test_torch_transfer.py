"""Transfer learning, the frozen wrappers and early stopping in the port
(transfer/, nn/conf/layers.py FrozenLayer*, graph_vertices.FrozenVertex,
optimize/early_stopping.py) against the JAX package on the CPU: the
contracts of tests/test_transfer.py, each run in both packages on
the same seeded inputs and the same starting parameters (carried across
as numpy).

A re-initialised layer (`nOutReplace`, an added layer) draws from each
package's own generator, so its JAX weights are carried across before any
training is compared. Tolerances: parameters, scores and outputs 1e-5
relative to max(1, max |JAX|) (f32 sums in another order); frozen
parameters, the source network after the new one trains and snapshots
after further training bit for bit (within the port)."""
import importlib
import json
import os
import types

import numpy as np
import pytest
import torch

from test_torch_multilayer import _close, _np_tree

TOL = 1e-5


def _pkg(root):
    mods = {"nn": "nn", "ds": "datasets", "opt": "optimize",
            "tl": "transfer", "gv": "nn.conf.graph_vertices",
            "layers": "nn.conf.layers", "mln": "nn.multilayer",
            "cg": "nn.graph"}
    return types.SimpleNamespace(
        root=root, **{k: importlib.import_module(f"{root}.{m}")
                      for k, m in mods.items()})


J, T = _pkg("deeplearning4j_tpu"), _pkg("deeplearning4j_tpu_torch")


def _init(P, net):
    return net.init("cpu") if P is T else net.init()


def _conf(P, n_out=3, seed=7, updater=None, bn=False):
    nn = P.nn
    b = (nn.NeuralNetConfiguration.Builder().seed(seed)
         .updater(updater or nn.Adam(1e-2))
         .weightInit(nn.WeightInit.XAVIER).activation(nn.Activation.RELU)
         .list()
         .layer(nn.DenseLayer.Builder().nOut(16).build()))
    b = b.layer(nn.BatchNormalization.Builder().build() if bn
                else nn.DenseLayer.Builder().nOut(16).build())
    return (b.layer(nn.OutputLayer.Builder(nn.LossFunction.MCXENT)
                    .nOut(n_out).activation(nn.Activation.SOFTMAX).build())
            .setInputType(nn.InputType.feedForward(4)).build())


def _pair(make=_conf, **kw):
    """(JAX network, port network) from one configuration, the port's on
    the JAX network's parameters."""
    jnet = J.mln.MultiLayerNetwork(make(J, **kw)).init()
    tnet = T.nn.multilayer_params_from_numpy(
        T.mln.MultiLayerNetwork(make(T, **kw)), _np_tree(jnet._params),
        _np_tree(jnet._state), device="cpu")
    return jnet, tnet


def _graph_conf(P):
    nn = P.nn
    return (nn.NeuralNetConfiguration.Builder()
            .seed(7).updater(nn.Adam(1e-2)).activation("relu")
            .graphBuilder().addInputs("in")
            .addLayer("d1", nn.DenseLayer.Builder().nOut(8).build(), "in")
            .addLayer("d2", nn.DenseLayer.Builder().nOut(8).build(), "in")
            .addVertex("merge", P.gv.MergeVertex(), "d1", "d2")
            .addLayer("out", nn.OutputLayer.Builder(nn.LossFunction.MCXENT)
                      .nOut(3).activation("softmax").build(), "merge")
            .setOutputs("out").setInputTypes(nn.InputType.feedForward(4))
            .build())


def _graph_pair():
    jnet = J.cg.ComputationGraph(_graph_conf(J)).init()
    tnet = T.nn.graph_params_from_numpy(
        T.cg.ComputationGraph(_graph_conf(T)), _np_tree(jnet._params),
        _np_tree(jnet._state), device="cpu")
    return jnet, tnet


def _data(P, n=64, n_classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    labels = (x[:, 0] > 0).astype(int) + (x[:, 1] > 0).astype(int)
    return P.ds.DataSet(x, np.eye(n_classes, dtype=np.float32)[labels])


def _iter(P, n=64, batch=32):
    ds = _data(P, n)
    return P.ds.ArrayDataSetIterator(ds.features, ds.labels, batch)


def _carry(jnet, tnet, keys):
    """The JAX network's parameters and state of `keys` written into the
    port's (the layers each package drew afresh)."""
    with torch.no_grad():
        for tree_j, tree_t in ((jnet._params, tnet._params),
                               (jnet._state, tnet._state)):
            for key in keys:
                for k, v in tree_j.get(key, {}).items():
                    tree_t[key][k].copy_(torch.from_numpy(np.array(v)))


def _same(jnet, tnet, what, rel=TOL):
    for n, d in _np_tree(jnet._params).items():
        for k, v in d.items():
            _close(tnet._params[n][k], v, rel, f"{what} {n}/{k}")


def _snap(tree):
    return {n: {k: v.clone() for k, v in d.items()} for n, d in tree.items()}


def _bit_equal(a, b):
    return all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


def _both(build, *a, **kw):
    """build(P, src) in each package on its network of the pair."""
    jsrc, tsrc = _pair(*a, **kw)
    return build(J, jsrc), build(T, tsrc)


# -- TransferLearning.Builder --------------------------------------------------
def test_feature_extractor_freezes_params():
    """Layers 0 and 1 frozen: bit for bit unchanged after 3 steps, the head
    trained as the JAX package's."""
    def build(P, src):
        return (P.tl.TransferLearning.Builder(src)
                .fineTuneConfiguration(P.tl.FineTuneConfiguration.Builder()
                                       .updater(P.nn.Sgd(0.5)).build())
                .setFeatureExtractor(1).build())
    jnet, tnet = _both(build)
    assert tnet.layers[0].frozen and tnet.layers[1].frozen
    before = _snap(tnet._params)
    for _ in range(3):
        jnet.fit(_data(J))
        tnet.fit(_data(T))
    for li in ("0", "1"):
        assert _bit_equal({li: before[li]}, tnet._params)
    assert not torch.equal(before["2"]["W"], tnet._params["2"]["W"])
    _same(jnet, tnet, "after 3 steps")
    _close(tnet.score(), jnet.score(), TOL, "score")


def test_transferred_params_are_copies():
    """The new network starts from the source's values, in tensors of its
    own."""
    tsrc = _pair()[1]
    net = T.tl.TransferLearning.Builder(tsrc).setFeatureExtractor(0).build()
    for li in ("0", "1", "2"):
        for k, v in tsrc._params[li].items():
            assert torch.equal(v, net._params[li][k])
            assert v.data_ptr() != net._params[li][k].data_ptr()


def test_nout_replace():
    """nOutReplace re-initialises the layer and the next one's nIn; with the
    re-drawn weights carried across, output and one step as JAX's."""
    def build(P, src):
        return (P.tl.TransferLearning.Builder(src).setFeatureExtractor(0)
                .nOutReplace(1, 8, P.nn.WeightInit.XAVIER).build())
    jnet, tnet = _both(build)
    assert tuple(tnet._params["1"]["W"].shape) == (16, 8)
    assert tuple(tnet._params["2"]["W"].shape) == (8, 3)
    _carry(jnet, tnet, ("1", "2"))
    x = _data(J).features
    _close(tnet.output(x).tensor, jnet.output(x).numpy(), TOL, "output")
    jnet.fit(_data(J))
    tnet.fit(_data(T))
    _same(jnet, tnet, "after a step")


def test_nout_replace_reinits_batchnorm():
    """Dense(replaced) → BatchNormalization → Output: the BN re-sizes and
    the head re-infers nIn; one step through the new widths as JAX's."""
    def build(P, src):
        return (P.tl.TransferLearning.Builder(src)
                .nOutReplace(0, 8, P.nn.WeightInit.XAVIER).build())
    jnet, tnet = _both(build, bn=True, seed=3)
    assert tuple(tnet._params["0"]["W"].shape) == (4, 8)
    assert tuple(tnet._params["1"]["gamma"].shape) == (8,)
    assert tuple(tnet._state["1"]["mean"].shape) == (8,)
    assert tuple(tnet._params["2"]["W"].shape) == (8, 3)
    _carry(jnet, tnet, ("0", "1", "2"))
    jnet.fit(_data(J))
    tnet.fit(_data(T))
    _same(jnet, tnet, "after a step")
    _close(tnet._state["1"]["mean"], np.asarray(jnet._state["1"]["mean"]),
           TOL, "BN mean")


def test_remove_and_add_output_layer():
    def build(P, src):
        nn = P.nn
        return (P.tl.TransferLearning.Builder(src).setFeatureExtractor(1)
                .removeOutputLayer()
                .addLayer(nn.OutputLayer.Builder(nn.LossFunction.MCXENT)
                          .nIn(16).nOut(5).activation(nn.Activation.SOFTMAX)
                          .build())
                .build())
    jnet, tnet = _both(build)
    _carry(jnet, tnet, ("2",))
    x = np.zeros((2, 4), np.float32)
    assert tuple(tnet.output(x).tensor.shape) == (2, 5)
    jnet.fit(_data(J, n_classes=5))
    tnet.fit(_data(T, n_classes=5))
    _same(jnet, tnet, "after a step")


def test_frozen_training_still_learns_head():
    def build(P, src):
        return (P.tl.TransferLearning.Builder(src)
                .fineTuneConfiguration(P.tl.FineTuneConfiguration.Builder()
                                       .updater(P.nn.Adam(5e-2)).build())
                .setFeatureExtractor(0).build())
    jnet, tnet = _both(build)
    first = None
    for _ in range(10):
        jnet.fit(_data(J, n=128))
        tnet.fit(_data(T, n=128))
        first = tnet.score() if first is None else first
    assert tnet.score() < first
    _close(tnet.score(), jnet.score(), TOL, "score after 10 Adam steps")


def test_helper_featurize_path():
    """TransferLearningHelper: the featurized batch as JAX's; training the
    unfrozen tail on it writes back into the network (in place), whose
    output then equals the tail's on the features."""
    def build(P, src):
        return (P.tl.TransferLearning.Builder(src).setFeatureExtractor(0)
                .build())
    jnet, tnet = _both(build)
    jh, th = J.tl.TransferLearningHelper(jnet), T.tl.TransferLearningHelper(
        tnet)
    jf, tf = jh.featurize(_data(J)), th.featurize(_data(T))
    assert tf.features.shape == (64, 16)
    _close(tf.features, np.asarray(jf.features), TOL, "features")
    ptr = tnet._params["2"]["W"].data_ptr()
    before = _snap(tnet._params)
    jh.fitFeaturized(jf)
    th.fitFeaturized(tf)
    assert not torch.equal(before["2"]["W"], tnet._params["2"]["W"])
    assert tnet._params["2"]["W"].data_ptr() == ptr
    _same(jnet, tnet, "after fitFeaturized")
    full = tnet.output(_data(T).features).tensor
    sub = th.outputFromFeaturized(tf.features).tensor
    torch.testing.assert_close(full, sub, rtol=2e-3, atol=2e-5)


def test_source_net_survives_transfer_training():
    """Copies, not shared tensors: after the new network trains, the
    source's parameters are their old values bit for bit, and the other
    way round."""
    tsrc = _pair()[1]
    net = T.tl.TransferLearning.Builder(tsrc).setFeatureExtractor(0).build()
    src_before, net_before = _snap(tsrc._params), _snap(net._params)
    net.fit(_data(T))
    assert _bit_equal(src_before, tsrc._params)
    assert not _bit_equal(net_before, net._params)
    net_after = _snap(net._params)
    tsrc.fit(_data(T))
    assert _bit_equal(net_after, net._params)


def test_requires_initialized_network():
    with pytest.raises(ValueError, match="initialized"):
        T.tl.TransferLearning.Builder(T.mln.MultiLayerNetwork(_conf(T)))
    with pytest.raises(ValueError, match="initialized"):
        T.tl.TransferLearning.GraphBuilder(T.cg.ComputationGraph(
            _graph_conf(T)))


# -- TransferLearning.GraphBuilder ---------------------------------------------
def test_nout_replace_through_vertex():
    jg, tg = _graph_pair()
    j2 = J.tl.TransferLearning.GraphBuilder(jg).nOutReplace(
        "d1", 6, J.nn.WeightInit.XAVIER).build()
    t2 = T.tl.TransferLearning.GraphBuilder(tg).nOutReplace(
        "d1", 6, T.nn.WeightInit.XAVIER).build()
    assert tuple(t2._params["d1"]["W"].shape) == (4, 6)
    assert tuple(t2._params["out"]["W"].shape) == (14, 3)
    _carry(j2, t2, ("d1", "out"))
    x = _data(J).features
    _close(t2.output(x).tensor, j2.output(x).numpy(), TOL, "output")


def test_freeze_and_train_graph():
    """setFeatureExtractor("merge") freezes every ancestor: d1 and d2 bit
    for bit after 3 steps, the head as JAX's; the source unharmed."""
    jg, tg = _graph_pair()
    j2 = J.tl.TransferLearning.GraphBuilder(jg).setFeatureExtractor(
        "merge").build()
    t2 = T.tl.TransferLearning.GraphBuilder(tg).setFeatureExtractor(
        "merge").build()
    before, src = _snap(t2._params), _snap(tg._params)
    for _ in range(3):
        j2.fit(_data(J))
        t2.fit(_data(T))
    assert _bit_equal({k: before[k] for k in ("d1", "d2")}, t2._params)
    assert not torch.equal(before["out"]["W"], t2._params["out"]["W"])
    assert _bit_equal(src, tg._params)
    _same(j2, t2, "after 3 steps")


def test_remove_vertex_and_rewire():
    def build(P, g):
        nn = P.nn
        return (P.tl.TransferLearning.GraphBuilder(g)
                .removeVertexAndConnections("out")
                .addLayer("newOut", nn.OutputLayer.Builder(
                    nn.LossFunction.MCXENT).nIn(16).nOut(5)
                    .activation("softmax").build(), "merge")
                .setOutputs("newOut").build())
    jg, tg = _graph_pair()
    j2, t2 = build(J, jg), build(T, tg)
    _carry(j2, t2, ("newOut",))
    x = _data(J).features
    assert tuple(t2.output(x).tensor.shape) == (64, 5)
    _close(t2.output(x).tensor, j2.output(x).numpy(), TOL, "output")
    assert "out" not in t2.conf.nodes


def test_remove_vertex_keep_connections():
    """removeVertexKeepConnections splices the vertex's inputs into its
    consumers: the same configuration JSON as the JAX package's."""
    def build(P, g):
        nn = P.nn
        return (P.tl.TransferLearning.GraphBuilder(g)
                .removeVertexKeepConnections("d2")
                .build())
    jg, tg = _graph_pair()
    j2, t2 = build(J, jg), build(T, tg)
    assert t2.conf.nodes["merge"].inputs == ["d1", "in"]
    assert json.loads(t2.conf.toJson()) == json.loads(j2.conf.toJson())


# -- the frozen wrappers -------------------------------------------------------
def _wrapped_conf(P, wrap):
    nn = P.nn
    inner = nn.DenseLayer(nOut=6, activation="tanh", dropOut=0.5)
    return (nn.NeuralNetConfiguration.Builder().seed(5)
            .updater(nn.Sgd(0.1)).l2(1e-2).list()
            .layer(nn.DenseLayer(nOut=6, activation="tanh"))
            .layer(getattr(P.layers, wrap)(inner))
            .layer(nn.OutputLayer(nOut=3))
            .setInputType(nn.InputType.feedForward(4)).build())


@pytest.mark.parametrize("wrap", ["FrozenLayer", "FrozenLayerWithBackprop"])
def test_frozen_wrappers_match_jax(wrap):
    """FrozenLayer: inference mode in training (no dropout), NoOp updates,
    no regularization. FrozenLayerWithBackprop: parameters detached (no
    gradient, no penalty), dropout on, gradients flowing through it to
    layer 0. Gradients (the backprop wrapper) and 3 steps as JAX's; the
    wrapped layer bit for bit unchanged."""
    jnet, tnet = _pair(lambda P: _wrapped_conf(P, wrap))
    x, y = _data(J).features, _data(J).labels
    if wrap == "FrozenLayerWithBackprop":
        tg = tnet.computeGradients(x, y)
        jg = jnet.computeGradients(x, y)
        assert not tg["1"]["W"].any() and not tg["1"]["b"].any()
        assert tg["0"]["W"].abs().max() > 0
        _close(tg["0"]["W"], np.asarray(jg["0"]["W"]), TOL, "grad 0/W")
    else:
        # inference mode: a train-mode forward draws no dropout
        g = torch.Generator().manual_seed(0)
        assert torch.equal(tnet.output(x, train=True, generator=g).tensor,
                           tnet.output(x).tensor)
    before = _snap(tnet._params)
    for _ in range(3):
        jnet.fit(J.ds.DataSet(x, y))
        tnet.fit(T.ds.DataSet(x, y))
    assert _bit_equal({"1": before["1"]}, tnet._params)
    if wrap == "FrozenLayer":
        _same(jnet, tnet, "after 3 steps")
        _close(tnet.score(), jnet.score(), TOL, "score")


def test_frozen_vertex():
    """FrozenVertex wraps a vertex: the same output, its parameters
    detached, and the same configuration JSON as JAX's, each package
    reading the other's."""
    from deeplearning4j_tpu_torch.nn.conf.attention import AttentionVertex

    def conf(P):
        nn = P.nn
        return (nn.NeuralNetConfiguration.Builder().seed(2)
                .updater(nn.Sgd(0.1)).graphBuilder().addInputs("a", "b")
                .addVertex("m", P.gv.FrozenVertex(P.gv.ElementWiseVertex(
                    "add")), "a", "b")
                .addLayer("out", nn.OutputLayer(nOut=2), "m")
                .setOutputs("out")
                .setInputTypes(nn.InputType.feedForward(3),
                               nn.InputType.feedForward(3)).build())
    jc, tc = conf(J), conf(T)
    assert json.loads(tc.toJson()) == json.loads(jc.toJson())
    back = type(tc).fromJson(jc.toJson())
    assert type(back.nodes["m"].ref) is T.gv.FrozenVertex
    assert json.loads(type(jc).fromJson(tc.toJson()).toJson()) == \
        json.loads(jc.toJson())
    jnet = J.cg.ComputationGraph(jc).init()
    tnet = T.nn.graph_params_from_numpy(T.cg.ComputationGraph(tc),
                                        _np_tree(jnet._params),
                                        _np_tree(jnet._state), device="cpu")
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((4, 3)).astype(np.float32) for _ in "ab")
    _close(tnet.output(a, b).tensor, jnet.output(a, b).numpy(), TOL, "out")
    att = T.gv.FrozenVertex(AttentionVertex(nInKeys=3, nInValues=3,
                                            nInQueries=3, nOut=3,
                                            nHeads=1))
    assert hasattr(att, "initialize")
    p = {k: v.requires_grad_() for k, v in att.initialize(
        torch.Generator().manual_seed(0),
        *[T.nn.InputType.recurrent(3, 4)] * 3)[0].items()}
    x = torch.randn(2, 4, 3, requires_grad=True)
    att.apply(x, x, x, params=p).sum().backward()
    assert x.grad is not None
    assert all(v.grad is None for v in p.values())


# -- early stopping ------------------------------------------------------------
def _es(P, net, *conds, calc=True, every=1, saver=None, save_last=False,
        iteration=()):
    b = P.opt.EarlyStoppingConfiguration.Builder().epochTerminationConditions(
        *conds)
    if iteration:
        b = b.iterationTerminationConditions(*iteration)
    if calc:
        b = b.scoreCalculator(P.opt.DataSetLossCalculator(_iter(P), True))
    if saver is not None:
        b = b.modelSaver(saver)
    b = b.evaluateEveryNEpochs(every).saveLastModel(save_last)
    return P.opt.EarlyStoppingTrainer(b.build(), net, _iter(P)).fit()


def _es_both(*conds, **kw):
    """`_es` in each package on its network of the pair, the conditions
    made by `conds` (functions of the package)."""
    jnet, tnet = _pair()
    return [_es(P, net, *[c(P) for c in conds], **kw)
            for P, net in ((J, jnet), (T, tnet))]


def test_max_epochs_terminates():
    jr, tr = _es_both(lambda P: P.opt.MaxEpochsTerminationCondition(3))
    assert tr.terminationReason == \
        T.opt.TerminationReason.EpochTerminationCondition
    assert "MaxEpochs" in tr.terminationDetails
    assert tr.totalEpochs == jr.totalEpochs == 3
    assert tr.bestModel is not None and len(tr.scoreVsEpoch) == 3
    for e, s in jr.scoreVsEpoch.items():
        _close(tr.scoreVsEpoch[e], s, TOL, f"epoch {e}")
    assert tr.bestModelEpoch == jr.bestModelEpoch


def test_score_improvement_stops_when_stuck():
    """A learning rate of 0 never improves the score: both packages stop
    after the patience, at the same epoch."""
    res = {}
    for P in (J, T):
        stuck = _init(P, P.mln.MultiLayerNetwork(
            _conf(P, updater=P.nn.Sgd(0.0))))
        res[P.root] = _es(P, stuck,
                          P.opt.MaxEpochsTerminationCondition(50),
                          P.opt.ScoreImprovementEpochTerminationCondition(2))
    r = res[T.root]
    assert r.terminationReason == \
        T.opt.TerminationReason.EpochTerminationCondition
    assert "ScoreImprovement" in r.terminationDetails
    assert r.totalEpochs == res[J.root].totalEpochs < 50


def test_iteration_condition_divergence_guard():
    for P in (J, T):
        net = _init(P, P.mln.MultiLayerNetwork(_conf(P)))
        r = _es(P, net, P.opt.MaxEpochsTerminationCondition(5), calc=False,
                iteration=(P.opt.MaxScoreIterationTerminationCondition(1e-9),
                           P.opt.InvalidScoreIterationTerminationCondition()))
        assert r.terminationReason == \
            P.opt.TerminationReason.IterationTerminationCondition


def test_max_epochs_no_overshoot_with_sparse_eval():
    jr, tr = _es_both(lambda P: P.opt.MaxEpochsTerminationCondition(3),
                      every=5)
    assert tr.totalEpochs == jr.totalEpochs == 3
    assert sorted(tr.scoreVsEpoch) == sorted(jr.scoreVsEpoch) == [0]


def test_best_model_survives_further_training():
    """InMemoryModelSaver snapshots copy the tensors: after 3 more steps
    of the live network, the snapshot holds its values bit for bit, and
    it trains on its own."""
    net = _pair()[1]
    saver = T.opt.InMemoryModelSaver()
    net.fit(_data(T))            # the step's tensors exist before the save
    saver.saveBestModel(net, 0.0)
    at_save = _snap(net._params)
    for _ in range(3):
        net.fit(_data(T))
    best = saver.getBestModel()
    assert _bit_equal(at_save, best._params)
    assert not _bit_equal(at_save, net._params)
    assert tuple(best.output(np.zeros((2, 4), np.float32)).tensor.shape) \
        == (2, 3)
    best.fit(_data(T))
    assert not _bit_equal(at_save, best._params)


def test_best_model_is_tracked():
    out = {}
    jnet, tnet = _pair()
    for P, net in ((J, jnet), (T, tnet)):
        b = (P.opt.EarlyStoppingConfiguration.Builder()
             .epochTerminationConditions(
                 P.opt.MaxEpochsTerminationCondition(4))
             .scoreCalculator(P.opt.ClassificationScoreCalculator(
                 "accuracy", _iter(P))).build())
        out[P.root] = P.opt.EarlyStoppingTrainer(b, net, _iter(P)).fit()
    r = out[T.root]
    assert 0.0 <= r.bestModelScore <= 1.0 and r.bestModelEpoch >= 0
    assert r.bestModelScore == pytest.approx(out[J.root].bestModelScore)
    assert r.bestModelEpoch == out[J.root].bestModelEpoch
    assert tuple(r.bestModel.output(np.zeros((2, 4), np.float32))
                 .tensor.shape) == (2, 3)
    assert r.totalEpochs == out[J.root].totalEpochs == 4


def test_latest_saved_every_epoch_with_sparse_eval():
    net = _pair()[1]
    saver = T.opt.InMemoryModelSaver()
    _es(T, net, T.opt.MaxEpochsTerminationCondition(4), every=3,
        saver=saver, save_last=True)
    assert _bit_equal(net._params, saver.getLatestModel()._params)


def test_latest_saved_on_iteration_termination():
    net = _pair()[1]
    saver = T.opt.InMemoryModelSaver()
    r = _es(T, net, T.opt.MaxEpochsTerminationCondition(10), calc=False,
            saver=saver, save_last=True,
            iteration=(T.opt.MaxScoreIterationTerminationCondition(-1.0),))
    assert r.terminationReason == \
        T.opt.TerminationReason.IterationTerminationCondition
    assert saver.getLatestModel() is not None


def test_local_file_model_saver(tmp_path):
    """LocalFileModelSaver writes the archive format both packages read:
    the restored best model equals the saved network bit for bit, and the
    JAX package restores the same parameters."""
    net = _pair()[1]
    net.fit(_data(T))
    saver = T.opt.LocalFileModelSaver(str(tmp_path), device="cpu")
    assert saver.getBestModel() is None
    saver.saveBestModel(net, 0.5)
    best = saver.getBestModel()
    assert type(best) is T.mln.MultiLayerNetwork
    assert _bit_equal(net._params, best._params)
    jbest = J.opt.LocalFileModelSaver(str(tmp_path)).getBestModel()
    for n, d in _np_tree(jbest._params).items():
        for k, v in d.items():
            assert np.array_equal(net._params[n][k].cpu().numpy(), v)
    assert os.path.exists(tmp_path / "bestModel.zip")


def test_parallel_trainer_raises_naming_a15():
    """EarlyStoppingParallelTrainer runs now (it raised naming ROADMAP A15
    before the port had ParallelWrapper): in a world of one rank, 3 dp
    epochs under the inherited loop equal the JAX package's
    EarlyStoppingTrainer on the same starting parameters (scores and
    parameters 1e-5). tests/test_torch_parallel.py runs it at two
    ranks."""
    jnet, tnet = _pair()

    def conf(P):
        return (P.opt.EarlyStoppingConfiguration.Builder()
                .epochTerminationConditions(
                    P.opt.MaxEpochsTerminationCondition(3))
                .scoreCalculator(P.opt.DataSetLossCalculator(_iter(P), True))
                .build())

    tr = T.opt.EarlyStoppingParallelTrainer(conf(T), tnet, _iter(T),
                                            workers=1).fit()
    jr = J.opt.EarlyStoppingTrainer(conf(J), jnet, _iter(J)).fit()
    assert tr.totalEpochs == jr.totalEpochs == 3
    for e, sc in jr.scoreVsEpoch.items():
        _close(tr.scoreVsEpoch[e], sc, TOL)
    for n, d in _np_tree(jnet._params).items():
        for k, v in d.items():
            _close(tnet._params[n][k], v, TOL)

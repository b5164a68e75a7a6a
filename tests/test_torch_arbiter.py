"""The port's arbiter (`deeplearning4j_tpu_torch/arbiter/`) against the
JAX package's, on the CPU.

- The spaces and the candidate generators (random, grid, TPE) yield the
  JAX package's candidates exactly, for the same seed and the same
  reported scores; the runner's results and best candidate are equal.
- `MultiLayerSpace` and `ComputationGraphSpace` build configurations
  whose JSON equals the JAX package's for the same candidate; with the
  JAX network's weights carried across (`multilayer_params_from_numpy`,
  `graph_params_from_numpy`) their outputs agree within RTOL.
- An LR and layer-size search runs end to end over the port's networks.
"""
import json

import numpy as np
import pytest

from deeplearning4j_tpu import arbiter as J
from deeplearning4j_tpu.nn.conf import inputs as jinputs
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu_torch import arbiter as T
from deeplearning4j_tpu_torch.nn.conf import inputs as tinputs
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.convert import (graph_params_from_numpy,
                                                 multilayer_params_from_numpy)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

#: the network outputs of the port against the JAX package on the same
#: weights, relative to max(1, max |JAX|)
RTOL = 1e-5


def _space(P):
    return {"lr": P.ContinuousParameterSpace(0.01, 1.0),
            "loglr": P.ContinuousParameterSpace(1e-4, 1e-1, log=True),
            "layers": P.IntegerParameterSpace(1, 6),
            "act": P.DiscreteParameterSpace("relu", "tanh", "elu"),
            "fixed": P.FixedValue(7)}


def _score(p):
    return ((p["lr"] - 0.3) ** 2 + 0.05 * (p["layers"] - 3) ** 2
            + 0.01 * np.log10(p.get("loglr", 1e-2)) ** 2
            + (0.1 if p["act"] == "tanh" else 0.0))


def _generator(P, kind, seed):
    if kind == "random":
        return P.RandomSearchGenerator(_space(P), seed=seed)
    if kind == "grid":
        sp = _space(P)
        del sp["loglr"]
        return P.GridSearchCandidateGenerator(sp, discretizationCount=3)
    return P.TPEGenerator(_space(P), seed=seed, startupTrials=5)


@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 42),
                                       ("grid", 0), ("tpe", 3), ("tpe", 5)])
def test_generators_yield_the_jax_packages_candidates(kind, seed):
    seqs = []
    for P in (J, T):
        gen, seq = _generator(P, kind, seed), []
        while gen.has_more() and len(seq) < 30:
            c = gen.next_candidate()
            gen.report(c, _score(c))     # the same scores in both
            seq.append(c)
        seqs.append(seq)
    assert len(seqs[0]) == len(seqs[1]) > 0
    assert seqs[1] == seqs[0]


@pytest.mark.parametrize("kind", ["random", "grid", "tpe"])
def test_runner_results_equal_the_jax_packages(kind):
    runs = []
    for P in (J, T):
        r = P.LocalOptimizationRunner(_generator(P, kind, 7),
                                      model_builder=lambda p: p,
                                      scorer=_score, maxCandidates=25)
        best = r.execute()
        runs.append(([(x.params, x.score, x.index) for x in r.results],
                     best.params, r.bestScore(),
                     r.numCandidatesCompleted()))
    assert runs[1] == runs[0]


def test_spaces_sample_and_grid_like_the_jax_package():
    for name in _space(J):
        js, ts = _space(J)[name], _space(T)[name]
        jr, tr = np.random.default_rng(1), np.random.default_rng(1)
        assert [ts.sample(tr) for _ in range(20)] == \
            [js.sample(jr) for _ in range(20)]
        assert ts.grid(4) == js.grid(4)
    with pytest.raises(ValueError, match="minValue > 0"):
        T.ContinuousParameterSpace(0.0, 1.0, log=True)


def _mls(P, I, L):
    return (P.MultiLayerSpace.Builder().seed(0).weightInit("xavier")
            .updater(P.AdamSpace(P.ContinuousParameterSpace(1e-3, 1e-1,
                                                            log=True)))
            .l2(P.ContinuousParameterSpace(1e-5, 1e-3))
            .addLayer(P.LayerSpace(L.DenseLayer,
                                   nOut=P.IntegerParameterSpace(4, 32),
                                   activation=P.DiscreteParameterSpace(
                                       "tanh", "relu")),
                      repeat=P.IntegerParameterSpace(1, 3))
            .addLayer(P.LayerSpace(L.OutputLayer, nOut=3,
                                   activation="softmax",
                                   lossFunction="mcxent"))
            .setInputType(I.InputType.feedForward(4)).build())


def _lenet_space(P, I, L):
    """The zoo LeNet's layer widths (conv 5×5×20, pool, conv 5×5×50, pool,
    dense 500, output 10), the learning rate and the dense width as
    spaces."""
    return (P.MultiLayerSpace.Builder().seed(12345).weightInit("xavier")
            .updater(P.NesterovsSpace(P.ContinuousParameterSpace(
                1e-3, 1e-1, log=True)))
            .addLayer(P.LayerSpace(L.ConvolutionLayer, kernelSize=(5, 5),
                                   nOut=20, activation="identity"))
            .addLayer(P.LayerSpace(L.SubsamplingLayer, poolingType="max",
                                   kernelSize=(2, 2), stride=(2, 2)))
            .addLayer(P.LayerSpace(L.ConvolutionLayer, kernelSize=(5, 5),
                                   nOut=50, activation="identity"))
            .addLayer(P.LayerSpace(L.SubsamplingLayer, poolingType="max",
                                   kernelSize=(2, 2), stride=(2, 2)))
            .addLayer(P.LayerSpace(L.DenseLayer, activation="relu",
                                   nOut=P.DiscreteParameterSpace(250, 500)))
            .addLayer(P.LayerSpace(L.OutputLayer, nOut=10,
                                   activation="softmax",
                                   lossFunction="negativeloglikelihood"))
            .setInputType(I.InputType.convolutionalFlat(28, 28, 1)).build())


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("space,seed", [("mlp", 0), ("mlp", 1),
                                        ("lenet", 0)])
def test_multilayer_space_builds_the_jax_packages_network(space, seed):
    make = _mls if space == "mlp" else _lenet_space
    jm, tm = make(J, jinputs, jlayers), make(T, tinputs, tlayers)
    assert set(tm.collectLeaves()) == set(jm.collectLeaves())
    cand = jm.randomCandidate(seed)
    assert tm.randomCandidate(seed) == cand
    jconf, tconf = jm.getValue(cand), tm.getValue(cand)
    assert json.loads(tconf.toJson()) == json.loads(jconf.toJson())
    jnet = jm.model_builder()(cand)
    tnet = multilayer_params_from_numpy(
        MultiLayerNetwork(tconf), _np_tree(jnet._params),
        _np_tree(jnet._state), device="cpu")
    shape = (5, 4) if space == "mlp" else (5, 784)
    x = np.random.default_rng(2).random(shape, np.float32)
    _close(np.asarray(tnet.output(x).numpy()),
           np.asarray(jnet.output(x).numpy()))


def _cgs(P, I, L):
    return (P.ComputationGraphSpace.Builder().seed(0)
            .updater(P.SgdSpace(P.ContinuousParameterSpace(0.01, 0.1)))
            .addInputs("in")
            .addLayer("h", P.LayerSpace(L.DenseLayer,
                                        nOut=P.IntegerParameterSpace(4, 16),
                                        activation="tanh"), "in")
            .addLayer("h2", L.DenseLayer(nOut=6, activation="relu"), "in")
            .addLayer("out", P.LayerSpace(L.OutputLayer, nOut=2,
                                          activation="softmax"), "h", "h2")
            .setOutputs("out")
            .setInputTypes(I.InputType.feedForward(3)).build())


def test_computation_graph_space_builds_the_jax_packages_network():
    jc, tc = _cgs(J, jinputs, jlayers), _cgs(T, tinputs, tlayers)
    assert set(tc.collectLeaves()) == set(jc.collectLeaves()) == {
        "global.updater", "node.h.nOut"}
    rngs = [np.random.default_rng(4), np.random.default_rng(4)]
    cands = [{k: v.sample(r) for k, v in sp.collectLeaves().items()}
             for sp, r in zip((jc, tc), rngs)]
    assert cands[1] == cands[0]
    jconf, tconf = jc.getValue(cands[0]), tc.getValue(cands[0])
    assert json.loads(tconf.toJson()) == json.loads(jconf.toJson())
    jnet = jc.model_builder()(cands[0])
    tnet = graph_params_from_numpy(ComputationGraph(tconf),
                                   _np_tree(jnet._params),
                                   _np_tree(jnet._state), device="cpu")
    x = np.random.default_rng(5).normal(size=(6, 3)).astype(np.float32)
    _close(np.asarray(tnet.output(x).numpy()),
           np.asarray(jnet.output(x).numpy()))


def test_lr_and_layer_size_search_runs_over_the_ports_networks():
    """The reference's end-to-end search, on the port: candidates vary,
    every score is finite, the best is the minimum."""
    mls = _mls(T, tinputs, tlayers)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(48, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(3, size=48)]

    def scorer(net):
        for _ in range(6):
            net.fit(x, y)
        return float(net.score())

    runner = T.LocalOptimizationRunner(
        T.RandomSearchGenerator(mls.collectLeaves(), seed=1),
        mls.model_builder(device="cpu"), scorer, maxCandidates=3)
    best = runner.execute()
    scores = [r.score for r in runner.results]
    assert runner.numCandidatesCompleted() == 3
    assert np.isfinite(scores).all() and best.score == min(scores)
    assert len({r.params["layer0.nOut"] for r in runner.results}) >= 2

"""The executable store's CUDA graphs against the eager runs of the same
functions, on the card: the decode superstep at two rungs, admit, grow and
retire; three `fit` steps of a small fused CNN (Nesterovs and Adam, and
dropout); an inference bucket; and both after a weight load rebinds the
tensors their graphs were captured with. Every replay must give the eager
run's bits, and the kernels' launch counters must advance on replay as they do
on an eager call. Every test is marked `cuda` and skips without a CUDA
device; the file imports nothing of JAX, so it runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_graphs.py
"""
import importlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.generation import BertDecoder, GenerationServer
from deeplearning4j_tpu_torch.kernels import pointwise_conv as tpc
from deeplearning4j_tpu_torch.models import bert_tiny, init_bert_params
from deeplearning4j_tpu_torch.nn import (Adam, BatchNormalization,
                                         ComputationGraph, ConvolutionLayer,
                                         DenseLayer, GlobalPoolingLayer,
                                         InputType, Nesterovs,
                                         NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.nn.convert import (graph_params_from_numpy,
                                                 graph_params_to_numpy)
from deeplearning4j_tpu_torch.runtime.executables import (ExecutableStore,
                                                          tensor_leaves)

tfa = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.flash_attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs capture on a CUDA "
                    "device (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


# -- the decode keys ----------------------------------------------------------
def _servers(card):
    """A graph server and an eager one over the same bert_tiny weights
    (head dim 64 for the kernels), both warm, their decode loops idle."""
    cfg = bert_tiny(hidden_size=128, num_heads=2, intermediate_size=256)
    params = init_bert_params(cfg, seed=0, device=card)
    out = []
    for graphs in (True, False):
        srv = GenerationServer(BertDecoder(cfg, params), slots=2,
                               cache_lengths=[16, 32],
                               prompt_buckets=[8, 16], superstep=3,
                               cuda_graphs=graphs)
        srv.warmup()
        out.append(srv)
    return cfg, out


def _state(srv):
    return ([t for r in sorted(srv._caches) for t in
             srv._caches[r].values()] + list(srv._cols))


def test_cuda_decode_keys_replay_bit_identical_to_eager(card):
    cfg, (graph, eager) = _servers(card)
    try:
        assert graph._store.stats["captures"] == len(graph._store)
        assert eager._store.stats["captures"] == 0
        prompt = np.arange(3, 14)
        steps = [
            ("admit", 16, 8, dict(slot=0, prompt=prompt[:5], key=(7, 9),
                                  method=0, top_k=0, temp=1.0)),
            ("superstep", 16, 3, dict(eos=(-1, -1), budget=(9, 0))),
            ("admit", 16, 16, dict(slot=1, prompt=prompt, key=(1, 2),
                                   method=1, top_k=5, temp=0.7)),
            ("superstep", 16, 3, dict(eos=(-1, 4), budget=(6, 9))),
            ("grow_to_32", 16, None, {}),
            ("superstep", 32, 3, dict(eos=(-1, -1), budget=(3, 9))),
            ("retire", None, None, dict(slot=0)),
            ("superstep", 32, 3, dict(eos=(-1, -1), budget=(0, 9))),
        ]
        for name, rung, extra, a in steps:
            outs = []
            for srv in (graph, eager):
                if name == "admit":
                    ints = np.zeros(srv._admit_in.shape, np.int64)
                    ints[:6] = (a["slot"], len(a["prompt"]), *a["key"],
                                a["method"], a["top_k"])
                    ints[6:6 + len(a["prompt"])] = a["prompt"]
                    srv._ring.stage([ints, np.float32([a["temp"]])],
                                    [srv._admit_in, srv._admit_temp])
                    key = ("admit", rung, extra)
                elif name == "superstep":
                    srv._ring.stage([np.int64([a["eos"], a["budget"]])],
                                    [srv._block_in])
                    key = ("superstep", rung, extra)
                elif name == "retire":
                    srv._ring.stage([np.int64([a["slot"]])],
                                    [srv._retire_in])
                    key = ("retire",)
                else:
                    key = (name, rung)
                before = (tfa.flash_fwd.launches, tfa.flash_decode.launches)
                out = srv._store.run(key)
                torch.cuda.synchronize()
                launched = (tfa.flash_fwd.launches - before[0],
                            tfa.flash_decode.launches - before[1])
                outs.append((None if out is None else out.clone(),
                             [t.clone() for t in _state(srv)], launched))
            (go, gs, gl), (eo, es, el) = outs
            assert (go is None) == (eo is None)
            if go is not None:
                assert torch.equal(go, eo), key
            for a_, b_ in zip(gs, es):
                assert torch.equal(a_, b_), key
            # a replay counts the launches the eager call makes
            assert gl == el, key
            want = {"admit": (cfg.num_layers, 0),
                    "superstep": (0, 3 * cfg.num_layers)}.get(name, (0, 0))
            assert gl == want, key
        st = graph._store.status()
        assert st["replays"] == len(steps) and st["eager_calls"] == 0
        assert st["live_captures"] == 0 and st["degradations"] == 0
    finally:
        graph.shutdown()
        eager.shutdown()


def test_cuda_graph_server_streams_equal_the_eager_server(card):
    cfg, (graph, eager) = _servers(card)
    reqs = [dict(prompt=[5, 17, 99], max_new_tokens=6, method="greedy"),
            dict(prompt=list(range(1, 12)), max_new_tokens=19,
                 method="temperature", temperature=0.8),
            dict(prompt=[42, 7], max_new_tokens=9, method="top_k", top_k=5),
            dict(prompt=[8] * 14, max_new_tokens=15, method="greedy")]
    streams = []
    try:
        for srv in (graph, eager):
            hs = [srv.submit(**r) for r in reqs]
            streams.append([h.result(timeout=120) for h in hs])
        assert streams[0] == streams[1]
        st = graph.status()
        assert st["rung"] == 32 and st["cuda_graphs"]
        ex = st["executables"]
        assert ex["live_captures"] == 0 and ex["eager_calls"] == 0
        assert ex["replays"] > 0
    finally:
        graph.shutdown()
        eager.shutdown()


# -- the fit step -------------------------------------------------------------
def _cnn_conf(updater, dropout=False):
    """Two fusable conv1x1+BN pairs, a pooled dense head."""
    g = (NeuralNetConfiguration.Builder()
         .seed(11).updater(updater).weightInit("relu")
         .graphBuilder().addInputs("input")
         .setInputTypes(InputType.convolutional(8, 8, 16)))
    g.addLayer("c1", ConvolutionLayer(kernelSize=(1, 1), nOut=32,
                                      hasBias=False, activation="identity"),
               "input")
    g.addLayer("bn1", BatchNormalization(activation="relu"), "c1")
    g.addLayer("c2", ConvolutionLayer(kernelSize=(1, 1), nOut=16,
                                      hasBias=False, activation="identity"),
               "bn1")
    g.addLayer("bn2", BatchNormalization(activation="relu"), "c2")
    g.addLayer("pool", GlobalPoolingLayer(poolingType="avg"), "bn2")
    g.addLayer("dense", DenseLayer(nOut=24, activation="relu",
                                   dropOut=0.5 if dropout else None),
               "pool")
    g.addLayer("out", OutputLayer(lossFunction="mcxent", nOut=5,
                                  activation="softmax"), "dense")
    g.setOutputs("out")
    return g.build()


def _batches(n=3):
    rng = np.random.default_rng(4)
    return [DataSet(rng.standard_normal((16, 8, 8, 16)).astype(np.float32),
                    np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)])
            for _ in range(n)]


@pytest.mark.parametrize("updater,dropout", [
    (lambda: Nesterovs(0.05, 0.9), False), (lambda: Adam(1e-2), False),
    (lambda: Adam(1e-2), True)], ids=["nesterovs", "adam", "adam-dropout"])
def test_cuda_fit_step_replays_bit_identical_to_eager(card, monkeypatch,
                                                      updater, dropout):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    nets = [ComputationGraph(_cnn_conf(updater(), dropout)).init()
            for _ in range(2)]
    assert len(nets[0]._fused_pairs) == 2
    kernels = (tpc.matmul_stats, tpc.bn_grad_stats, tpc.bn_conv_grads)
    launched, scores = [], []
    for net, graphs, prefetch in ((nets[0], True, 2), (nets[1], False, 0)):
        before = [k.launches for k in kernels]
        net.fit(_batches(), prefetch=prefetch, cudaGraphs=graphs)
        torch.cuda.synchronize()
        launched.append([k.launches - b for k, b in zip(kernels, before)])
        scores.append(net.score())
    graph, eager = nets
    assert scores[0] == scores[1]
    for attr in ("_params", "_opt_state", "_state"):
        for a, b in zip(tensor_leaves(getattr(graph, attr)),
                        tensor_leaves(getattr(eager, attr))):
            assert torch.equal(a, b), attr
    # 2 pairs × 3 steps of each training kernel, replays included
    assert launched[0] == launched[1] == [6, 6, 6]
    st = graph.fit_status()
    assert st["keys"] == 1 and st["captures"] + st["degradations"] == 1
    if st["degradations"]:
        assert dropout and st["degraded"], st
        assert st["eager_calls"] == 2
    else:
        assert st["replays"] == 2
    assert eager.fit_status() is None


def test_cuda_fit_graph_follows_a_weight_load(card, monkeypatch):
    """fit, load other weights (new tensors), fit again: the graph is
    captured again against the loaded tensors and matches eager steps."""
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    other = ComputationGraph(_cnn_conf(Adam(1e-2))).init()
    other.fit(_batches(1), cudaGraphs=False)
    loaded = graph_params_to_numpy(other)
    nets = [ComputationGraph(_cnn_conf(Adam(1e-2))).init()
            for _ in range(2)]
    batches = _batches(4)
    for net, graphs in zip(nets, (True, False)):
        net.fit(batches[:2], prefetch=0, cudaGraphs=graphs)
        graph_params_from_numpy(net, *loaded, device=card)
        net.fit(batches[2:], prefetch=0, cudaGraphs=graphs)
    torch.cuda.synchronize()
    graph, eager = nets
    assert graph.score() == eager.score()
    for attr in ("_params", "_opt_state", "_state"):
        for a, b in zip(tensor_leaves(getattr(graph, attr)),
                        tensor_leaves(getattr(eager, attr))):
            assert torch.equal(a, b), attr
    st = graph.fit_status()
    assert (st["captures"], st["rebinds"], st["replays"]) == (2, 1, 3), st
    assert st["degradations"] == 0


# -- an inference bucket ------------------------------------------------------
def test_cuda_inference_bucket_replays_bit_identical_to_eager(card,
                                                              monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    net = ComputationGraph(_cnn_conf(Nesterovs(0.05, 0.9))).init()
    store = ExecutableStore(net)
    sig = (((4, 8, 8, 16), "float32"),)
    assert store.warmup([sig])["captures"] == 1
    x = np.random.default_rng(6).standard_normal((4, 8, 8, 16)).astype(
        np.float32)
    want = net.output(x)
    for _ in range(2):
        before = tpc.matmul_epilogue.launches
        (static,) = store.ensure(sig)
        static.copy_(torch.as_tensor(x, device=card))
        got = store.run(("forward", sig))
        torch.cuda.synchronize()
        assert tpc.matmul_epilogue.launches - before == 2
        assert torch.equal(got, want)
    assert store.stats["replays"] == 2 and store.stats["live_captures"] == 0


def test_cuda_inference_bucket_follows_a_weight_load(card, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    net = ComputationGraph(_cnn_conf(Nesterovs(0.05, 0.9))).init()
    other = ComputationGraph(_cnn_conf(Nesterovs(0.05, 0.9))).init()
    other.fit(_batches(1), cudaGraphs=False)
    store = ExecutableStore(net)
    sig = (((4, 8, 8, 16), "float32"),)
    store.warmup([sig])
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (4, 8, 8, 16)).astype(np.float32), device=card)
    (static,) = store.ensure(sig)
    static.copy_(x)
    before = store.run(("forward", sig)).clone()
    graph_params_from_numpy(net, *graph_params_to_numpy(other), device=card)
    static.copy_(x)
    got = store.run(("forward", sig))
    torch.cuda.synchronize()
    assert torch.equal(got, net.output(x))
    assert not torch.equal(got, before)
    assert (store.stats["rebinds"], store.stats["captures"],
            store.stats["live_captures"]) == (1, 2, 0)

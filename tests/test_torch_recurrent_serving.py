"""Recurrent serving on the port (generation/decode.py `RecurrentDecoder`,
`GenerationServer` over a recurrent MultiLayerNetwork, `FleetRouter` over
recurrent servers, `ParallelInference.lengthBuckets`) against the JAX
package on the CPU, on the reference's own fleet fixture (one LSTM(16)
over a vocabulary of 16, seed 3) with its parameters carried across by
`multilayer_params_from_numpy`, and against the port's own full-sequence
forward.

Tolerances: decoder logits and carries against the JAX decoder 1e-5
relative to max(1, max |JAX|) (f32); inside the port, decode against the
masked full forward over the same slots 1e-6 (the same operations, but
the head's and the prefill's products run at other row counts, which
CPU BLAS may sum in another order: a few ulp); streams token for token,
on fixtures whose greedy top-2 margin is checked first; lengthBuckets'
answers 1e-6 of `output()` (the same masked pass at another padded
length)."""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.generation import GenerationServer as JaxServer
from deeplearning4j_tpu.generation.decode import \
    RecurrentDecoder as JaxRecurrentDecoder
from deeplearning4j_tpu.nn.conf.recurrent import LSTM as JLSTM
from deeplearning4j_tpu.nn.conf.recurrent import \
    RnnOutputLayer as JRnnOutputLayer
from deeplearning4j_tpu_torch.generation import (FleetRouter,
                                                 GenerationServer,
                                                 RecurrentDecoder)
from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.parallel.inference import (InferenceMode,
                                                         ParallelInference)

V = 16
TOL = 1e-5

WORKLOAD = [
    dict(prompt=[1, 2, 3], max_new_tokens=8),
    dict(prompt=[5, 4], max_new_tokens=10, method="sample",
         temperature=0.8),
    dict(prompt=[7, 3, 2, 1], max_new_tokens=12, method="top_k",
         temperature=0.9, top_k=3),
    dict(prompt=[2, 2, 5], max_new_tokens=6),
    dict(prompt=[9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11], max_new_tokens=7),
]
SERVER = dict(slots=2, cache_lengths=[48], prompt_buckets=[8, 16],
              method="greedy", seed=11)


def _close(got, want, what="", tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _conf(nn, lstm, head, hidden=16, seed=3):
    return (nn.NeuralNetConfiguration.Builder().seed(seed)
            .updater(nn.Adam(1e-2)).weightInit("xavier").list()
            .layer(lstm(nOut=hidden, activation="tanh"))
            .layer(head(lossFunction="mcxent", nOut=V, activation="softmax"))
            .setInputType(nn.InputType.recurrent(V)).build())


@pytest.fixture(scope="module")
def nets():
    """The reference's fleet fixture in both packages, one parameter set."""
    jnet = jnn.MultiLayerNetwork(_conf(jnn, JLSTM, JRnnOutputLayer)).init()
    tnet = tnn.multilayer_params_from_numpy(
        tnn.MultiLayerNetwork(_conf(tnn, tnn.LSTM, tnn.RnnOutputLayer)),
        jax.tree_util.tree_map(np.asarray, jnet._params),
        jax.tree_util.tree_map(np.asarray, jnet._state), device="cpu")
    return jnet, tnet


def _carries(cache):
    return {k: [np.asarray(t) for t in v]
            for k, v in cache["carries"].items()}


def test_decoder_prefill_and_steps_match_the_jax_decoder(nets):
    """Prefill of two bucketed prompts into slots 1 and 0, then four
    steps of both slots: logits and carries equal the JAX decoder's."""
    jnet, tnet = nets
    jdec, tdec = JaxRecurrentDecoder(jnet), RecurrentDecoder(tnet)
    assert tdec.max_cache_len is None and not tdec.uses_cache_rungs
    assert tdec.device.type == "cpu"
    jm, tm = jdec.model_args(), tdec.model_args()
    jc, tc = jdec.init_cache(2, 32), tdec.init_cache(2, 32)
    for slot, prompt in ((1, [4, 9, 1, 15, 2]), (0, [3, 3, 7])):
        padded = np.zeros(8, np.int64)
        padded[:len(prompt)] = prompt
        jc, jl = jdec.prefill(jm, jc, slot, jnp.asarray(padded, jnp.int32),
                              len(prompt))
        tc, tl = tdec.prefill(tm, tc, torch.tensor(slot),
                              torch.from_numpy(padded),
                              torch.tensor(len(prompt)))
        _close(tl, np.asarray(jl), f"prefill slot {slot}")
        for k, v in _carries(jc).items():
            for a, b in zip(tc["carries"][k], v):
                _close(a, b, f"carries after prefill {slot}")
    tokens = np.array([5, 11])
    for step in range(4):
        jl, jc = jdec.step(jm, jc, jnp.asarray(tokens, jnp.int32),
                           jnp.zeros(2, jnp.int32))
        tl, tc = tdec.step(tm, tc, torch.from_numpy(tokens),
                           torch.zeros(2, dtype=torch.long))
        _close(tl, np.asarray(jl), f"step {step}")
        tokens = np.asarray(jl).argmax(-1)
    for k, v in _carries(jc).items():
        for a, b in zip(tc["carries"][k], v):
            _close(a, b, "carries after the steps")


def test_decode_equals_the_masked_full_forward(nets):
    """Inside the port: prefill of two slots' prompts (3 and 5 tokens in a
    bucket of 8) and three steps give, at every position, the logits of
    the masked full forward over the two slots' whole sequences (the same
    slots, the same batch), within 1e-6."""
    _, tnet = nets
    dec = RecurrentDecoder(tnet)
    margs = dec.model_args()
    cache = dec.init_cache(2, 32)
    seqs = [[4, 9, 1], [3, 3, 7, 12, 0]]
    got = [[], []]
    for slot, prompt in enumerate(seqs):
        padded = torch.zeros(8, dtype=torch.long)
        padded[:len(prompt)] = torch.tensor(prompt)
        cache, logits = dec.prefill(margs, cache, torch.tensor(slot),
                                    padded, torch.tensor(len(prompt)))
        got[slot].append(logits)
    for _ in range(3):
        tokens = torch.stack([g[-1].argmax() for g in got])
        for s in range(2):
            seqs[s].append(int(tokens[s]))
        logits, cache = dec.step(margs, cache, tokens,
                                 torch.zeros(2, dtype=torch.long))
        for s in range(2):
            got[s].append(logits[s])
    # the full forward: both slots, one hot, each under its own mask
    t_len = max(len(s) for s in seqs)
    x = torch.zeros((2, t_len, V))
    mask = torch.zeros((2, t_len))
    for s, seq in enumerate(seqs):
        x[s, torch.arange(len(seq)), torch.tensor(seq)] = 1
        mask[s, :len(seq)] = 1
    _, preact, _, _ = tnet._forward(tnet._params, tnet._state, x, False,
                                    mask=mask)
    for s, seq in enumerate(seqs):
        plen = len(seq) - 3
        for j, logits in enumerate(got[s]):
            # prefill logits: position plen - 1; step j: plen - 1 + j
            want = preact[s, plen - 1 + j]
            _close(logits, want.numpy(), f"slot {s} position {j}", 1e-6)


def _greedy_margin(tnet, prompt, stream):
    """The smallest top-2 gap of the greedy continuation's logits."""
    tnet.rnnClearPreviousState()
    eye = np.eye(V, dtype=np.float32)
    y = tnet.rnnTimeStep(eye[prompt][None])[0, -1]
    gaps = []
    for tok in stream:
        top = torch.topk(torch.log(y), 2).values
        gaps.append(float(top[0] - top[1]))
        y = tnet.rnnTimeStep(eye[[tok]])[0]
    return min(gaps)


def _rnn_time_step_greedy(tnet, prompt, n):
    tnet.rnnClearPreviousState()
    eye = np.eye(V, dtype=np.float32)
    y = tnet.rnnTimeStep(eye[prompt][None])[0, -1]
    out = []
    for _ in range(n):
        tok = int(y.argmax())
        out.append(tok)
        y = tnet.rnnTimeStep(eye[[tok]])[0]
    return out


@pytest.fixture(scope="module")
def jax_streams(nets):
    jnet, _ = nets
    srv = JaxServer(jnet, **SERVER)
    try:
        handles = [srv.submit(**w) for w in WORKLOAD]
        return [h.result(timeout=120) for h in handles]
    finally:
        srv.shutdown()


def test_server_streams_token_identical_to_the_jax_server(nets,
                                                          jax_streams):
    """GenerationServer over the port's network (wrapped in a
    RecurrentDecoder, one rung) serves the workload (greedy, sampled and
    top-k) token for token as the JAX server does, and its greedy streams
    equal an rnnTimeStep loop of the same network; the greedy fixtures'
    top-2 margins are checked first."""
    _, tnet = nets
    for w, stream in zip(WORKLOAD, jax_streams):
        if w.get("method", "greedy") == "greedy":
            assert _greedy_margin(tnet, w["prompt"], stream) > 1e-4
    srv = GenerationServer(tnet, **SERVER)
    try:
        stats = srv.warmup()
        assert srv.cache_lengths == (48,)
        assert srv.executable_keys() == {
            ("superstep", 48, 1), ("admit", 48, 8), ("admit", 48, 16),
            ("retire",), ("advance_key_n",)}
        assert stats["executables"] == 4
        got = [h.result(timeout=120)
               for h in [srv.submit(**w) for w in WORKLOAD]]
        assert srv._store.stats["live_captures"] == 0
    finally:
        srv.shutdown()
    assert got == jax_streams
    for w, stream in zip(WORKLOAD, got):
        if w.get("method", "greedy") == "greedy":
            assert stream == _rnn_time_step_greedy(tnet, w["prompt"],
                                                   len(stream))


def test_text_generation_lstm_serves_with_the_docstring_settings():
    """The zoo model's own serving settings at a small width (rung 512
    collapses to one, top-k 5): streams of the requested lengths, every
    token in the vocabulary, greedy equal to an rnnTimeStep loop."""
    net = TextGenerationLSTM(numClasses=V, lstmLayerSize=8).init("cpu")
    srv = TextGenerationLSTM(numClasses=V).generationServer(
        net, slots=4, cache_lengths=[64, 512], method="top_k", top_k=5,
        prompt_buckets=[8, 32])
    try:
        srv.warmup()
        assert srv.cache_lengths == (512,)
        sampled = srv.generate([1, 2, 3, 4], max_new_tokens=20)
        greedy = srv.generate([1, 2, 3, 4], max_new_tokens=20,
                              method="greedy")
    finally:
        srv.shutdown()
    assert len(sampled) == 20 and all(0 <= t < V for t in sampled)
    assert greedy == _rnn_time_step_greedy(net, [1, 2, 3, 4], 20)
    with pytest.raises(ValueError, match="draft-verify"):
        GenerationServer(net, draft=2)


def test_two_replica_fleet_streams_equal_one_server(nets, jax_streams,
                                                    tmp_path):
    """The reference's fleet fixture: a FleetRouter over two recurrent
    servers (seed-aligned, one manifest directory) serves the workload as
    one server does, token for token, each request through one replica."""
    _, tnet = nets
    factory = (lambda i: GenerationServer(
        tnet, exec_cache_dir=str(tmp_path), **SERVER))
    with FleetRouter(factory=factory, num_replicas=2) as router:
        reqs = [router.submit(**w) for w in WORKLOAD]
        got = [list(q.stream(timeout=60)) for q in reqs]
        st = router.status()
    assert got == jax_streams
    assert sum(r["routed"] for r in st["replicas"]) == len(WORKLOAD)
    assert st["failovers"] == st["failed"] == 0
    assert all(len(q.routes) == 1 for q in reqs)


def test_length_buckets_answers_equal_output(nets):
    """ParallelInference with bucketLadder([1, 2, 4]) and
    lengthBuckets([8, 16]): requests of lengths 2–15 from 6 threads
    coalesce (their time axes zero-padded to one bucket under a mask) and
    each answer equals `output()` on the unpadded input."""
    _, tnet = nets
    pi = (ParallelInference.Builder(tnet)
          .inferenceMode(InferenceMode.BATCHED).bucketLadder([1, 2, 4])
          .lengthBuckets([8, 16]).build())
    try:
        stats = pi.warmup()
        assert stats["signatures"] == 6
        rng = np.random.default_rng(0)
        eye = np.eye(V, dtype=np.float32)
        xs = [eye[rng.integers(0, V, (int(rng.integers(1, 3)),
                                      int(rng.integers(2, 16))))]
              for _ in range(12)]
        got = [None] * len(xs)

        def call(i):
            got[i] = pi.output(xs[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for x, y in zip(xs, got):
            _close(y, tnet.output(x).numpy(), "lengthBuckets", tol=1e-6)
        st = pi.status()
        assert st["length_buckets"] == [8, 16]
        assert st["model_calls"] < len(xs)
        assert st["aot_fallbacks"] == 0
        assert st["executables"]["live_captures"] == 0
    finally:
        pi.shutdown()

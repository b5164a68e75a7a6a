"""The port's GenerationServer (deeplearning4j_tpu_torch/generation/
server.py) against the JAX GenerationServer over the same bert_tiny
parameters and seed, on the CPU: greedy AND sampled streams are
token-identical (per-request keys derive from (seed, admission order) and
sampling follows JAX's threefry bit for bit), across a cache-rung growth,
slot reuse and supersteps 1 and 4."""
import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.generation import BertDecoder as JaxDecoder
from deeplearning4j_tpu.generation import GenerationServer as JaxServer
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch.generation import (BertDecoder,
                                                 GenerationServer, status)
from deeplearning4j_tpu_torch.generation.decode import RecurrentDecoder
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.resilience.errors import (
    InferenceOverloadedError, ServerDeadError)
from deeplearning4j_tpu_torch.resilience.policy import RetryPolicy

#: slots 2, rungs 16 → 32; requests 1 and 4 need 20 rows (a growth),
#: six requests through two slots reuse every slot
SERVER = dict(slots=2, cache_lengths=[16, 32], prompt_buckets=[8], seed=3)
REQUESTS = [
    dict(prompt=[5, 17, 99], max_new_tokens=6, method="greedy"),
    dict(prompt=[3, 1, 4, 1, 5, 9, 2], max_new_tokens=13,
         method="temperature", temperature=0.8),
    dict(prompt=[42, 7], max_new_tokens=9, method="top_k", top_k=5,
         temperature=0.7),
    dict(prompt=[8, 8, 8, 8], max_new_tokens=5, method="greedy"),
    dict(prompt=[11, 22, 33, 44, 55, 66], max_new_tokens=14,
         method="greedy"),
    dict(prompt=[100, 2, 60], max_new_tokens=7, method="temperature",
         temperature=1.3),
]


@pytest.fixture(scope="module")
def models():
    cfg = jb.bert_tiny()
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    tcfg = tb.bert_tiny()
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jp, tcfg, tp


def _serve(srv, requests=REQUESTS):
    try:
        handles = [srv.submit(**r) for r in requests]
        return [h.result(timeout=120) for h in handles], handles
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def jax_streams(models):
    cfg, jp, _, _ = models
    streams, _ = _serve(JaxServer(JaxDecoder(cfg, jp), superstep=4,
                                  **SERVER))
    return streams


@pytest.mark.parametrize("superstep", [1, 4])
def test_streams_token_identical_to_jax_server(models, jax_streams,
                                               superstep):
    _, _, tcfg, tp = models
    srv = GenerationServer(BertDecoder(tcfg, tp), superstep=superstep,
                           **SERVER)
    streams, handles = _serve(srv)
    assert streams == jax_streams
    assert [len(s) for s in streams] == [r["max_new_tokens"]
                                         for r in REQUESTS]
    assert all(h.finish_reason == "length" for h in handles)
    st = srv.status()
    assert st["rung"] == 32                 # grew from 16
    assert st["admissions"] == st["retirements"] == len(REQUESTS)
    assert st["tokens"] == sum(len(s) for s in streams)
    assert st["state"] == "shutdown"
    # one host fetch per block plus one per admission
    assert st["token_fetches"] == st["steps"] + st["admissions"]


def test_eos_retirement_slot_reuse_and_streaming(models):
    _, _, tcfg, tp = models
    dec = BertDecoder(tcfg, tp)
    base, _ = _serve(GenerationServer(dec, superstep=4, **SERVER),
                     [dict(prompt=[9, 4, 2], max_new_tokens=12)])
    eos = base[0][2]
    cut = base[0][:base[0].index(eos) + 1]
    seen = []
    with GenerationServer(dec, superstep=4, **SERVER) as srv:
        hs = [srv.submit([9, 4, 2], max_new_tokens=12, eos_id=eos,
                         on_token=seen.append) for _ in range(3)]
        streamed = list(hs[0].stream(timeout=60))
        outs = [h.result(timeout=60) for h in hs]
        assert srv.status()["retirements"] == 3
    # greedy and slot-independent: every copy stops at the same EOS
    assert outs == [cut] * 3
    assert streamed == cut
    assert [h.finish_reason for h in hs] == ["eos"] * 3
    assert sorted(seen) == sorted(cut * 3)


def test_server_surface_and_refusals(models):
    _, _, tcfg, tp = models
    dec = BertDecoder(tcfg, tp)
    # the survivability knobs are the JAX server's; a caller's restart
    # policy sets the budget of the server's own private clone
    policy = RetryPolicy(max_attempts=2, initial_backoff=0.001)
    srv = GenerationServer(dec, restart_policy=policy,
                           max_consecutive_failures=2,
                           pressure_relief_steps=16,
                           pressure_relief_secs=None,
                           memory_high_water=None, **SERVER)
    assert srv.restart_policy is not policy
    assert srv.restart_policy.max_attempts == 2
    assert (srv.max_consecutive_failures, srv.pressure_relief_steps,
            srv.pressure_relief_secs, srv.memory_high_water) == (
                2, 16, None, None)
    assert hasattr(srv, "adopt")
    # a recurrent network is served through a RecurrentDecoder, on one
    # rung, and refuses drafting (tests/test_torch_recurrent_serving.py)
    rnn = TextGenerationLSTM(numClasses=11, lstmLayerSize=8).init("cpu")
    rsrv = GenerationServer(rnn, **SERVER)
    assert isinstance(rsrv.decoder, RecurrentDecoder)
    assert rsrv.cache_lengths == (32,) and rsrv.device.type == "cpu"
    with pytest.raises(ValueError, match="draft-verify"):
        GenerationServer(rnn, draft=2, **SERVER)
    with pytest.raises(TypeError, match="adopt"):
        GenerationServer(dec, adopt=True)
    # drafting runs now (tests/test_torch_server_paged.py); its knob
    # combinations that the JAX server refuses are refused
    with pytest.raises(ValueError, match="pick one"):
        GenerationServer(dec, draft=2, superstep=4, **SERVER)
    with pytest.raises(ValueError, match="draft-verify"):
        GenerationServer(BertDecoder(tcfg, tp, kv_dtype="int8"), draft=2,
                         **SERVER)
    srv = GenerationServer(dec, queue_limit=1, enqueue_timeout_ms=1.0,
                           **SERVER)
    with pytest.raises(ValueError, match="exceeds the top prompt bucket"):
        srv.submit(list(range(1, 10)))
    with pytest.raises(ValueError, match="exceeds the top cache rung"):
        srv.submit([1, 2], max_new_tokens=31)
    assert any(s["slots"] == 2 for s in status()["servers"])
    srv.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        srv.submit([1, 2], max_new_tokens=4)


def test_full_queue_sheds_and_dead_loop_fails_requests(models):
    _, _, tcfg, tp = models
    dec = BertDecoder(tcfg, tp)
    srv = GenerationServer(dec, queue_limit=1, enqueue_timeout_ms=1.0,
                           **SERVER)
    srv.warmup = lambda: None       # no decode loop: nothing drains
    queued = srv.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(InferenceOverloadedError):
        srv.submit([1, 2, 3], max_new_tokens=4)
    srv.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        queued.result(timeout=5)
    # a decode loop that can never make progress (every prefill and every
    # step fails) exhausts the restart budget and latches ServerDeadError
    # on every request
    boom = RuntimeError("device fault")

    def broken(*a, **k):
        raise boom

    dec_broken = BertDecoder(tcfg, tp)
    dec_broken.step = dec_broken.prefill = broken
    bad = GenerationServer(dec_broken, restart_policy=RetryPolicy(
        max_attempts=2, initial_backoff=0.001), **SERVER)
    h = bad.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(ServerDeadError):
        h.result(timeout=60)
    with pytest.raises(ServerDeadError):
        bad.submit([1, 2], max_new_tokens=4)
    assert bad.status()["state"] == "dead"
    bad.shutdown()
    assert torch.is_grad_enabled()

"""Paged decode on the card: `flash_decode` over a view gathered from a page
pool is bit-identical to the call on the slot-contiguous cache, and a paged
server's CUDA-graph replays give its eager run's streams and pool bytes.
Every test is marked `cuda` and skips without a CUDA device; the file
imports nothing of JAX, so it runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_paged.py
"""
import importlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.generation import BertDecoder, GenerationServer
from deeplearning4j_tpu_torch.kernels import gather_kv_pages
from deeplearning4j_tpu_torch.models import bert_tiny, init_bert_params

tfa = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.flash_attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: flash_decode and CUDA graphs run "
                    "on a CUDA device (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_flash_decode_bit_identical_to_dense(card, dtype):
    b, h, c, d, ps = 8, 12, 512, 64, 16
    gen = torch.Generator(device=card).manual_seed(0)
    n = c // ps
    pool = torch.randn((b * n + 1, h, ps, d), generator=gen, device=card,
                       dtype=torch.float32).to(dtype)
    vpool = torch.randn_like(pool)
    table = (torch.randperm(b * n, generator=gen, device=card) + 1).reshape(
        b, n)
    q = torch.randn((b, h, 1, d), generator=gen, device=card).to(dtype)
    lengths = torch.tensor([512, 1, 17, 300, 64, 0, 511, 128], device=card)
    mask = torch.arange(c, device=card)[None, :] < lengths[:, None]
    kc, vc = gather_kv_pages(pool, table), gather_kv_pages(vpool, table)
    assert kc.shape == (b, h, c, d) and kc.is_contiguous()
    dense_k = torch.stack([torch.cat([pool[p] for p in row], dim=1)
                           for row in table])
    dense_v = torch.stack([torch.cat([vpool[p] for p in row], dim=1)
                           for row in table])
    assert torch.equal(kc, dense_k) and torch.equal(vc, dense_v)
    before = tfa.flash_decode.launches
    paged = tfa.flash_attention_decode_paged(q, pool, vpool, table, mask)
    dense = tfa.flash_attention_decode(q, dense_k, dense_v, mask)
    torch.cuda.synchronize()
    assert tfa.flash_decode.launches - before == 2
    assert torch.equal(paged, dense)
    assert not paged[5].any()               # the empty row is zero


def test_cuda_paged_server_replays_bit_identical_to_eager(card):
    cfg = bert_tiny(hidden_size=128, num_heads=2, intermediate_size=256)
    params = init_bert_params(cfg, seed=0, device=card)
    reqs = [dict(prompt=list(range(1, 18)), max_new_tokens=10),
            dict(prompt=list(range(1, 18)), max_new_tokens=6,
                 method="temperature", temperature=0.8),
            dict(prompt=[5, 17, 99], max_new_tokens=9, method="top_k",
                 top_k=5),
            dict(prompt=[8] * 14, max_new_tokens=15)]
    runs = []
    for graphs in (True, False):
        srv = GenerationServer(
            BertDecoder(cfg, params, page_size=8, pool_pages=17), slots=2,
            cache_lengths=[16, 32], prompt_buckets=[8, 24], superstep=3,
            cuda_graphs=graphs)
        try:
            srv.warmup()
            hs = [srv.submit(**r) for r in reqs]
            streams = [h.result(timeout=120) for h in hs]
            torch.cuda.synchronize()
            st = srv.status()
            pool = {k: t[:, 1:].clone()          # page 0 is garbage
                    for k, t in srv._caches[16].items()}
        finally:
            srv.shutdown()
        runs.append((streams, st, pool))
    (gs, gst, gpool), (es, est, epool) = runs
    assert gs == es
    for name in gpool:
        assert torch.equal(gpool[name], epool[name]), name
    ex = gst["executables"]
    assert gst["cuda_graphs"] and ex["replays"] > 0
    assert ex["live_captures"] == ex["eager_calls"] == 0
    assert ex["degradations"] == 0
    assert gst["page_pool"]["prefix_hits"] >= 1
    assert gst["page_pool"]["cow_copies"] >= 1
    for st in (gst, est):
        assert st["token_fetches"] == st["steps"] + st["admissions"]
    assert np.all([len(s) == r["max_new_tokens"] for s, r in zip(gs, reqs)])

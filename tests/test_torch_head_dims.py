"""Attention at every head dim, on the CPU, against the JAX package.

The port's flash kernels take any head dim on the card: flash_fwd,
flash_bwd_dq and flash_bwd_dkv have tiles for D = 16, 32, 64 and 128 and
run a wider D zero-padded to the next multiple of 128, 128 columns a block
(`head_dim_plan`); flash_decode is instantiated for D = 8 … 1024 and runs
a D between two in the wider one's geometry, unpadded, and a wider D
through the forward with one query row (`decode_head_dim_plan`). Here,
where the wrappers run the kernels' plain versions:

- both plans over head dims from 1 to 1024, and past it;
- decode at D = 1152 (the forward with one query row) against the JAX
  package's Pallas decode in interpret mode;
- the plain forward, dQ and dK/dV at D = 8, 160 and 256, on the operands
  the card kernels get (padded to the plan, scale 1/√D of the true D),
  against the JAX package's Pallas kernels in interpret mode (B = 1,
  H = 2, T = 32; no mask, a key mask, causal);
- DL4J's single-head attention layers at nOut = 256 (D = 256), forward and
  every gradient against the JAX package's layers, weights carried across;
- BertDecoder at D = 8 (bert_tiny()) and D = 256 (hidden 512, 2 heads),
  through the kernels' plain versions (`attn_impl="kernel"`): prefill and
  three decode steps against the JAX decoder, greedy tokens equal.

Tolerance 1e-5 in f32 (relative to max(1, max |JAX|) for the layers, as in
tests/test_torch_attention.py): the sums run in another order."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as jnn
from deeplearning4j_tpu.generation.decode import BertDecoder as JaxDecoder
from deeplearning4j_tpu.models import bert as jb
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu_torch.generation.decode import BertDecoder
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import params_from_numpy

from test_torch_attention import (B, F, J, LENGTHS, P, T, _close, _ff_head,
                                  _grads_close, _labels, _mask, _np_tree,
                                  _seq)
from test_torch_flash_attention import _j, _lens_mask, _qkv, _t

jfa = importlib.import_module("deeplearning4j_tpu.kernels.flash_attention")
tfa = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)

#: head dim -> (flash_fwd/dQ/dK·dV runs it at, flash_decode's instantiation)
PLANS = {1: (16, 8), 8: (16, 8), 16: (16, 16), 17: (32, 32),
         100: (128, 128), 128: (128, 128), 129: (256, 256),
         160: (256, 256), 256: (256, 256), 300: (384, 512),
         512: (512, 512), 1024: (1024, 1024)}


@pytest.mark.parametrize("d", sorted(PLANS))
def test_every_head_dim_has_a_kernel_plan(d):
    """No head dim from 1 to 1024 is refused: the forward and backward
    kernels run it at the smallest tile that holds it, or at the next
    multiple of 128 (their wide chunk); decode at the smallest power of
    two from 8 that holds it."""
    fwd, dec = PLANS[d]
    assert tfa.head_dim_plan(d) == fwd
    assert fwd >= d and (fwd in (16, 32, 64, 128) or fwd % 128 == 0)
    assert tfa.decode_head_dim_plan(d) == dec
    assert dec >= d and dec & (dec - 1) == 0


def test_head_dims_the_plans_refuse():
    """A head dim below 1. Past 1024 (the widest decode instantiation) the
    decode plan names no instantiation (None: decode runs the forward with
    one query row, at the forward plan's D), and the forward plan takes any
    wider D."""
    for plan in (tfa.head_dim_plan, tfa.decode_head_dim_plan):
        with pytest.raises(ValueError, match="at least 1"):
            plan(0)
    assert tfa.decode_head_dim_plan(1025) is None
    assert tfa.decode_head_dim_plan(4000) is None
    assert tfa.head_dim_plan(1025) == 1152
    assert tfa.head_dim_plan(4000) == 4096


@pytest.mark.parametrize("rank", [3, 4])
def test_decode_past_head_dim_1024_matches_the_jax_kernel(rank):
    """flash_attention_decode(impl="kernel") at D = 1152, past flash_decode's
    widest instantiation: the forward with one query row (on the CPU its
    plain version), against the JAX package's impl="pallas" (its forward
    kernel in interpret mode) and its dense decode, an empty cache row
    coming back zero."""
    rng = np.random.default_rng(12)
    b, h, c, d = 3, 2, 24, 1152
    q = rng.standard_normal((b, h, d) if rank == 3
                            else (b, h, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, c, d)).astype(np.float32)
            for _ in range(2))
    m = _lens_mask([24, 0, 9], c)
    jp = jfa.flash_attention_decode(_j(q), _j(k), _j(v), _j(m),
                                    impl="pallas", block_k=8, interpret=True)
    jd = jfa.flash_attention_decode(_j(q), _j(k), _j(v), _j(m),
                                    impl="dense")
    before = (tfa.flash_fwd.launches, tfa.flash_decode.launches)
    out = tfa.flash_attention_decode(_t(q), _t(k), _t(v), _t(m),
                                     impl="kernel")
    assert (tfa.flash_fwd.launches, tfa.flash_decode.launches) == before
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jd), **TOL)
    assert np.all(out.numpy()[1] == 0)


#: (causal, key lengths) at B = 1, H = 2, T = 32
KERNEL_CASES = {"plain": (False, None), "key mask": (False, [23]),
                "causal": (True, None)}


def _padded_plain(q, k, v, g, mask, causal):
    """The plain versions on the operands the card kernels get: padded to
    `head_dim_plan`, the scale of the true head dim, sliced back."""
    d = q.shape[-1]
    dp = tfa.head_dim_plan(d)
    scale = 1.0 / d ** 0.5
    pq, pk, pv, pg = tfa.pad_heads(dp, q, k, v, g)
    o, lse = tfa._flash_forward_reference(pq, pk, pv, mask, causal, scale)
    if mask is not None:   # self-attention: padded query rows as the wrapper
        o = torch.where(mask.bool()[:, None, :, None], o, 0)
        lse = torch.where(mask.bool()[:, None, :].expand(
            o.shape[:3]).reshape(lse.shape), lse, 1e30)
    delta = tfa._delta(pg, o)
    dq = tfa._dq_reference(pq, pk, pv, pg, lse, delta, mask, causal, scale)
    dk, dv = tfa._dkv_reference(pq, pk, pv, pg, lse, delta, mask, causal,
                                scale)
    assert all((x[..., d:] == 0).all() for x in (o, dq, dk, dv))
    return o[..., :d], lse, dq[..., :d], dk[..., :d], dv[..., :d]


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
@pytest.mark.parametrize("d", [8, 160, 256])
def test_padded_plain_versions_match_the_jax_kernels(d, case):
    """The forward (output and lse) and both backward kernels' plain
    versions, run at the plan's padded head dim, against the JAX package's
    Pallas forward and `jax.grad` of its Pallas backward in interpret
    mode."""
    causal, lens = KERNEL_CASES[case]
    q, k, v = _qkv(d, 1, 2, 32, 32, d)
    g = np.random.default_rng(d + 1).standard_normal(
        q.shape).astype(np.float32)
    m = None if lens is None else _lens_mask(lens, 32)
    jo, jl = jfa._flash_forward(_j(q), _j(k), _j(v), _j(m), _j(m), causal,
                                8, 8, True)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, mask=_j(m),
                                  block_q=8, block_k=8, interpret=True)
        return jnp.sum(out * g)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    o, lse, dq, dk, dv = _padded_plain(_t(q), _t(k), _t(v), _t(g), _t(m),
                                       causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[:, :32], **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    # the port's autograd entry (the wrappers, on the CPU their plain
    # versions) gives the same
    leaves = [_t(a).clone().requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, mask=_t(m))
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL)
    for name, a, b in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, **TOL)


def _one_head_stack(ns):
    """examples/attention_sequence_classifier.py's stack at DL4J's default
    single head and nOut = 256: D = 256 in both attention layers, the
    learned layer cross-attending with Tq = 4."""
    return [ns.att.SelfAttentionLayer(nOut=256, nHeads=1),
            ns.att.LearnedSelfAttentionLayer(nOut=256, nHeads=1,
                                             nQueries=4),
            ns.rec.LastTimeStep(ns.rec.LSTM(nOut=16)), _ff_head(ns)]


def test_single_head_layers_at_nout_256_match_the_jax_package():
    """SelfAttentionLayer(nOut=256) and LearnedSelfAttentionLayer(nOut=256,
    nQueries=4) at one head: forward unmasked and under ragged masks, and
    every parameter's gradient of the masked loss."""
    def conf(ns):
        b = (ns.nn.NeuralNetConfiguration.Builder().seed(7)
             .updater(ns.nn.Adam(1e-3)).weightInit("xavier").list())
        for layer in _one_head_stack(ns):
            b.layer(layer)
        return b.setInputType(ns.nn.InputType.recurrent(F, T)).build()

    jnet = jnn.MultiLayerNetwork(conf(J)).init()
    tnet = tnn.multilayer_params_from_numpy(
        tnn.MultiLayerNetwork(conf(P)), _np_tree(jnet._params),
        _np_tree(jnet._state), device="cpu")
    assert tnet._params["0"]["Wq"].shape == (F, 256)
    x, m, y = _seq(5), _mask(LENGTHS), _labels("ff", 6)
    _close(tnet.output(x), np.asarray(jnet.output(x).numpy()), "one head")
    _close(tnet.output(x, fmask=m),
           np.asarray(jnet.output(x, fmask=m).numpy()), "one head masked")
    _grads_close(tnet.computeGradients(x, y, m, None),
                 jnet.computeGradients(x, y, m, None), "one head")


@pytest.mark.parametrize("overrides", [{}, dict(hidden_size=512,
                                                num_heads=2)],
                         ids=["D=8", "D=256"])
def test_decoder_through_the_kernel_path_matches_jax(overrides):
    """BertDecoder with `attn_impl="kernel"` (prefill through flash
    attention, the steps through flash_decode: their plain versions here)
    against the JAX decoder: logits of the prefill and of three greedy
    steps within 1e-5, the caches too, and the same greedy tokens."""
    cfg = jb.bert_tiny(**overrides)
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(2))
    tcfg = tb.bert_tiny(**overrides)
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    assert tcfg.head_dim == (8 if not overrides else 256)
    jd, td = JaxDecoder(cfg, jp), BertDecoder(tcfg, tp, attn_impl="kernel")
    prompt = np.random.default_rng(4).integers(1, 128, 9).astype(np.int32)
    plen, slots = len(prompt), 2
    padded = np.pad(prompt, (0, 16 - plen))
    jc, tc = jd.init_cache(slots, 32), td.init_cache(slots, 32)
    jc, jl = jd.prefill(jd.model_args(), jc, jnp.int32(1),
                        jnp.asarray(padded), jnp.int32(plen))
    tc, tl = td.prefill(td.model_args(), tc, 1,
                        torch.from_numpy(padded.astype(np.int64)), plen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = int(np.argmax(np.asarray(jl)))
    assert int(tl.argmax()) == tok
    for t in range(3):
        toks = np.zeros(slots, np.int64)
        pos = np.zeros(slots, np.int64)
        toks[1], pos[1] = tok, plen + t
        jl, jc = jd.step(jd.model_args(), jc, jnp.asarray(toks),
                         jnp.asarray(pos))
        tl, tc = td.step(td.model_args(), tc, torch.from_numpy(toks),
                         torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **TOL)
        tok = int(np.argmax(np.asarray(jl)[1]))
        assert int(tl[1].argmax()) == tok, t

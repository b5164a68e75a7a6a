"""The port's int8 codec (deeplearning4j_tpu_torch/quantize/) and its
quantized, paged and multi-query-paged decode attention against the JAX
package's, on the CPU. The int8 bytes and the scales must be equal exactly;
attention outputs agree to 1e-5, and a row whose mask is empty comes back
zero in both."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.kernels import flash_attention_decode as j_decode
from deeplearning4j_tpu.kernels import \
    flash_attention_decode_mq_paged as j_mq_paged
from deeplearning4j_tpu.kernels import \
    flash_attention_decode_paged as j_paged
from deeplearning4j_tpu.quantize import core as jcore
from deeplearning4j_tpu.quantize import kvcache as jkv
from deeplearning4j_tpu_torch.kernels import (flash_attention_decode,
                                              flash_attention_decode_mq_paged,
                                              flash_attention_decode_paged)
from deeplearning4j_tpu_torch.quantize import (INT8_MAX, cache_page_bytes,
                                               dequantize, dequantize_rows,
                                               per_channel_scales,
                                               per_tensor_scale, quantize,
                                               quantize_rows)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rows(seed, shape):
    """K/V-like rows: normal values at mixed magnitudes, one all-zero row,
    one row of a single outlier, and values that land exactly on a .5
    step of their row's scale (round half to even decides them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.choice([1e-3, 1.0, 30.0], shape[:-1])[..., None].astype(
        np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1] = 0.0
    flat[1, 3] = -7.25
    flat[2] = np.arange(shape[-1], dtype=np.float32) - shape[-1] / 2
    flat[2, 0] = 127.0                          # scale exactly 1: ties
    flat[2, 1:4] = (0.5, 1.5, -2.5)
    return x


@pytest.mark.parametrize("shape", [(3, 4, 16), (2, 12, 33, 64), (5, 7)])
def test_quantize_rows_bytes_and_scales_equal_jax(shape):
    x = _rows(1, shape)
    jq, js = jkv.quantize_rows(jnp.asarray(x))
    tq, ts = quantize_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    # 0 ulp: the f32 bit patterns are equal
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert (ts.numpy().reshape(-1)[0]) == 1.0       # an all-zero row
    np.testing.assert_array_equal(
        dequantize_rows(tq, ts).numpy(),
        np.asarray(jkv.dequantize_rows(jq, js)))


def test_elementwise_codec_equals_jax():
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((6, 5)) * 3).astype(np.float32)
    w[:, 2] = 0.0
    assert INT8_MAX == jcore.INT8_MAX
    for axis in (-1, 0):
        js = jcore.per_channel_scales(jnp.asarray(w), axis)
        ts = per_channel_scales(torch.from_numpy(w), axis)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jq = jcore.quantize(jnp.asarray(w), js, axis)
        tq = quantize(torch.from_numpy(w), ts, axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(
            dequantize(tq, ts, axis).numpy(),
            np.asarray(jcore.dequantize(jq, js, axis)))
    np.testing.assert_array_equal(
        per_tensor_scale(torch.from_numpy(w)).numpy(),
        np.asarray(jcore.per_tensor_scale(jnp.asarray(w))))
    assert per_tensor_scale(torch.zeros(3)).item() == 1.0


@pytest.mark.parametrize("args", [(12, 12, 16, 64, "fp", 4),
                                  (12, 12, 16, 64, "int8"),
                                  (2, 4, 8, 8, "int8"), (2, 4, 8, 8, "fp", 2)])
def test_cache_page_bytes_equals_jax(args):
    assert cache_page_bytes(*args) == jkv.cache_page_bytes(*args)


def _decode_inputs(seed, b=3, h=4, c=24, d=16, int8=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h, c, d)).astype(np.float32)
    v = rng.standard_normal((b, h, c, d)).astype(np.float32)
    lengths = [c, 5, 0][:b]                     # the last row: empty mask
    mask = np.arange(c)[None, :] < np.asarray(lengths)[:, None]
    if not int8:
        return q, k, v, mask, None, None
    kq, ks = (np.asarray(t) for t in jkv.quantize_rows(jnp.asarray(k)))
    vq, vs = (np.asarray(t) for t in jkv.quantize_rows(jnp.asarray(v)))
    return q, kq, vq, mask, ks, vs


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def test_quantized_decode_matches_jax_and_zeroes_empty_rows():
    q, k, v, mask, ks, vs = _decode_inputs(3, int8=True)
    want = np.asarray(j_decode(*(jnp.asarray(a) for a in (q, k, v, mask)),
                               k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs)))
    tq, tk, tv, tm, tks, tvs = _t(q, k, v, mask, ks, vs)
    got = flash_attention_decode(tq, tk, tv, tm, k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[2].any() and not want[2].any()
    with pytest.raises(ValueError, match="int8-cache"):
        flash_attention_decode(tq, tk, tv, tm, impl="kernel", k_scale=tks,
                               v_scale=tvs)
    with pytest.raises(ValueError, match="together"):
        flash_attention_decode(tq, tk, tv, tm, k_scale=tks)


def _paged(k, v, ks, vs, ps, seed):
    """Scatter (B, H, C, D) caches into a shuffled pool of ps-row pages
    (page 0 the null page, left as noise); returns the pools and table."""
    rng = np.random.default_rng(seed)
    b, h, c, d = k.shape
    n = c // ps
    perm = rng.permutation(np.arange(1, b * n + 1)).reshape(b, n)
    pools = []
    for t in (k, v, ks, vs):
        if t is None:
            pools.append(None)
            continue
        pool = rng.standard_normal((b * n + 1, h, ps) + t.shape[3:]).astype(
            t.dtype)
        for s in range(b):
            for j in range(n):
                pool[perm[s, j]] = t[s, :, j * ps:(j + 1) * ps]
        pools.append(pool)
    return pools, perm.astype(np.int32)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_matches_jax_and_the_contiguous_decode(int8):
    q, k, v, mask, ks, vs = _decode_inputs(4, int8=int8)
    (kp, vp, ksp, vsp), tab = _paged(k, v, ks, vs, 8, 5)
    jargs = {} if not int8 else dict(k_scale_pool=jnp.asarray(ksp),
                                     v_scale_pool=jnp.asarray(vsp))
    want = np.asarray(j_paged(*(jnp.asarray(a) for a in
                                (q, kp, vp, tab, mask)), **jargs))
    tq, tkp, tvp, ttab, tm, tks, tvs = _t(q, kp, vp, tab, mask, ksp, vsp)
    got = flash_attention_decode_paged(tq, tkp, tvp, ttab, tm,
                                       k_scale_pool=tks, v_scale_pool=tvs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[2].any()
    # bit for bit the slot-contiguous decode of the same rows
    c1, c2, c3, c4, c5, c6 = _t(q, k, v, mask, ks, vs)
    dense = flash_attention_decode(c1, c2, c3, c4, k_scale=c5, v_scale=c6)
    assert torch.equal(got, dense)


def test_multi_query_paged_decode_matches_jax():
    rng = np.random.default_rng(6)
    b, h, c, d, nq = 3, 4, 24, 16, 3
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    _, k, v, _, _, _ = _decode_inputs(7, b, h, c, d)
    pos = np.asarray([10, 20, 0])
    qmask = np.arange(c)[None, None, :] <= (pos[:, None]
                                            + np.arange(nq)[None, :])[..., None]
    qmask[2] = False                            # a slot with no valid row
    (kp, vp, _, _), tab = _paged(k, v, None, None, 8, 8)
    want = np.asarray(j_mq_paged(*(jnp.asarray(a) for a in
                                   (q, kp, vp, tab, qmask))))
    got = flash_attention_decode_mq_paged(*_t(q, kp, vp, tab, qmask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[2].any() and not want[2].any()
    with pytest.raises(ValueError, match="kernel"):
        flash_attention_decode_mq_paged(*_t(q, kp, vp, tab, qmask),
                                        impl="kernel")

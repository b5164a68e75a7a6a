"""The port's sampling (deeplearning4j_tpu_torch/generation/sampling.py)
against the JAX package: threefry key splits bit for bit, and the same
tokens from the same keys."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.generation import sampling as js
from deeplearning4j_tpu_torch.generation import sampling as ts


def _keys(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2),
                                                dtype=np.uint32)


def _tk(keys):
    return torch.from_numpy(keys.astype(np.int64))


def test_threefry_partitionable_is_the_reference_mode():
    # the port follows jax's partitionable threefry layout (the default of
    # the installed jax); a flip of that default would change JAX's bits
    assert jax.config.jax_threefry_partitionable


def test_split_keys_bit_identical_to_jax():
    keys = _keys(4096)
    keys[:4] = [[0, 0], [0, 1], [2 ** 32 - 1, 2 ** 32 - 1], [1, 0]]
    jn, js_ = js.split_keys(jnp.asarray(keys))
    tn, ts_ = ts.split_keys(_tk(keys))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    # a chain of splits, as a slot consumes them step after step
    jk, tk = jnp.asarray(keys[:64]), _tk(keys[:64])
    for _ in range(20):
        jk, _ = js.split_keys(jk)
        tk, _ = ts.split_keys(tk)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_gumbel_noise_matches_jax():
    keys = _keys(16, seed=1)
    jg = jax.vmap(lambda k: jax.random.gumbel(k, (300,)))(jnp.asarray(keys))
    tg = ts._gumbel(_tk(keys), 300)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)


def _logits(s, v, seed):
    """Each row a permutation of a 0.25 grid: no two candidates tie
    within float rounding, so an ulp of difference in the noise cannot
    flip a token."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.permutation(v) for _ in range(s)])
    return (rows * 0.25 - 8.0).astype(np.float32)


@pytest.mark.parametrize("mode", ["greedy", "temperature", "top_k"])
def test_sample_step_tokens_and_keys_match_jax(mode):
    s, v = 64, 40
    logits = _logits(s, v, 2)
    keys = _keys(s, seed=3)
    meth = np.full(s, ts.method_id(mode), np.int32)
    temp = np.full(s, 0.8 if mode != "greedy" else 1.0, np.float32)
    topk = np.full(s, 5 if mode == "top_k" else 0, np.int32)
    jt, jk = js.sample_step(jnp.asarray(logits), jnp.asarray(keys),
                            jnp.asarray(meth), jnp.asarray(temp),
                            jnp.asarray(topk))
    tt, tk = ts.sample_step(torch.from_numpy(logits), _tk(keys),
                            torch.from_numpy(meth), torch.from_numpy(temp),
                            torch.from_numpy(topk))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if mode == "greedy":
        np.testing.assert_array_equal(tt.numpy(), logits.argmax(-1))
    if mode == "top_k":
        kth = np.sort(logits, -1)[:, v - 5]
        assert np.all(logits[np.arange(s), tt.numpy()] >= kth)


def test_sample_step_mixed_batch_and_knob_edges():
    s, v = 6, 40
    logits = _logits(s, v, 4)
    keys = _keys(s, seed=5)
    meth = np.array([0, 1, 1, 1, 1, 0], np.int32)
    temp = np.array([1.0, 0.0, -1.0, 2.0, 0.5, 0.8], np.float32)
    topk = np.array([0, 0, 1, v, v + 3, 3], np.int32)
    jt, _ = js.sample_step(jnp.asarray(logits), jnp.asarray(keys),
                           jnp.asarray(meth), jnp.asarray(temp),
                           jnp.asarray(topk))
    tt, _ = ts.sample_step(torch.from_numpy(logits), _tk(keys),
                           torch.from_numpy(meth), torch.from_numpy(temp),
                           torch.from_numpy(topk))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt[2] == logits[2].argmax()      # top-1 is greedy


def test_method_id():
    assert ts.method_id("greedy") == ts.GREEDY
    for name in ("sample", "temperature", "TOP_K", "topk"):
        assert ts.method_id(name) == ts.SAMPLE
    with pytest.raises(ValueError, match="unknown sampling method"):
        ts.method_id("beam")

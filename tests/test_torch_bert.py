"""The port's BERT (deeplearning4j_tpu_torch/models) against the JAX
package at bert_tiny on the CPU, with the same parameters carried across
as numpy. f32, JAX matmul precision "highest" (tests/conftest.py);
tolerance 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import (init_bert_params,
                                                     param_shapes,
                                                     params_from_numpy,
                                                     params_to_numpy)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    cfg = jb.bert_tiny()
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = tb.bert_tiny()
    return cfg, jp, tree, tcfg, params_from_numpy(tcfg, tree, device="cpu")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (3, 20))
    types = rng.integers(0, 2, (3, 20))
    # ragged padding with one fully padded example
    mask = (np.arange(20)[None] < np.array([20, 13, 0])[:, None]).astype(
        np.int32)
    return ids, types, mask


def test_converter_round_trips_every_leaf(models):
    _, _, tree, tcfg, tp = models
    back = params_to_numpy(tp)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    back_leaves, back_def = jax.tree_util.tree_flatten(back)
    assert back_def == treedef
    assert len(leaves) == 5 + 12 * tcfg.num_layers + 2 + 2 + 5
    for a, b in zip(leaves, back_leaves):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_converter_checks_names_and_shapes(models):
    _, _, tree, tcfg, _ = models
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["pooler"]["W"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match=r"params\.pooler\.W"):
        params_from_numpy(tcfg, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["layers"][1]["ffn"]["up_b"]
    with pytest.raises(ValueError, match=r"params\.layers\[1\]\.ffn"):
        params_from_numpy(tcfg, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["layers"] = bad["layers"][:1]
    with pytest.raises(ValueError, match="list of 2 layers"):
        params_from_numpy(tcfg, bad, device="cpu")


def test_seeded_init_matches_the_layout(models):
    _, _, tree, tcfg, _ = models
    a = params_to_numpy(init_bert_params(tcfg, seed=7, device="cpu"))
    b = params_to_numpy(init_bert_params(tcfg, seed=7, device="cpu"))
    c = params_to_numpy(init_bert_params(tcfg, seed=8, device="cpu"))
    shapes = jax.tree_util.tree_map(lambda x: x.shape, tree)
    assert jax.tree_util.tree_map(lambda x: x.shape, a) == shapes
    assert jax.tree_util.tree_all(
        jax.tree_util.tree_map(np.array_equal, a, b))
    assert not np.array_equal(a["embeddings"]["word"],
                              c["embeddings"]["word"])
    assert np.all(a["layers"][0]["ln1_scale"] == 1)
    assert np.all(a["layers"][0]["qkv_b"] == 0)
    assert 0.015 < a["embeddings"]["word"].std() < 0.025
    assert param_shapes(tcfg)["layers"][0]["qkv_W"] == (32, 96)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_bert_encode_matches_jax(models, batch, impl, causal):
    cfg, jp, _, tcfg, tp = models
    ids, types, mask = batch
    m = None if causal else mask
    jh = jb.bert_encode(cfg, jp, jnp.asarray(ids), jnp.asarray(types),
                        None if m is None else jnp.asarray(m),
                        attn_impl=impl, causal=causal)
    th = tb.bert_encode(tcfg, tp, torch.from_numpy(ids),
                        torch.from_numpy(types),
                        None if m is None else torch.from_numpy(m),
                        attn_impl=impl, causal=causal)
    # dense attention leaves the fully padded example NaN in both
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), equal_nan=True,
                               **TOL)


def test_bert_classify_and_mlm_match_jax(models, batch):
    cfg, jp, _, tcfg, tp = models
    ids, types, mask = batch
    jl = jb.bert_classify(cfg, jp, jnp.asarray(ids), jnp.asarray(types),
                          jnp.asarray(mask), attn_impl="flash")
    tl = tb.bert_classify(tcfg, tp, torch.from_numpy(ids),
                          torch.from_numpy(types), torch.from_numpy(mask),
                          attn_impl="flash")
    assert tl.dtype == torch.float32 and tl.shape == (3, 3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jh = jb.bert_encode(cfg, jp, jnp.asarray(ids[:2]))
    th = tb.bert_encode(tcfg, tp, torch.from_numpy(ids[:2]))
    jm = jb.bert_mlm_logits(cfg, jp, jh)
    tm = tb.bert_mlm_logits(tcfg, tp, th)
    assert tm.shape == (2, 20, 128)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)


def test_bert_auto_is_dense_on_cpu_and_flash_agrees(models, batch):
    _, _, _, tcfg, tp = models
    ids, _, _ = batch
    x = torch.from_numpy(ids)
    auto = tb.bert_encode(tcfg, tp, x)
    dense = tb.bert_encode(tcfg, tp, x, attn_impl="dense")
    flash = tb.bert_encode(tcfg, tp, x, attn_impl="flash")
    assert torch.equal(auto, dense)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), **TOL)


def test_bert_rejects_what_waits_for_later_slices(models, batch):
    _, _, _, tcfg, tp = models
    x = torch.from_numpy(batch[0])
    with pytest.raises(NotImplementedError, match="blockwise"):
        tb.bert_encode(tcfg, tp, x, attn_impl="blockwise")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tb.bert_encode(tcfg, tp, x, attn_impl="nope")
    with pytest.raises(NotImplementedError, match="MoE"):
        init_bert_params(tb.bert_tiny(moe_layers=(1,)), device="cpu")

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
    """What once waited for the parallel slice now runs: blockwise
    attention (an unmasked batch; a masked one raises as in the JAX
    package) and an MoE layer, each against the JAX package at 1e-5; an
    unknown attn_impl still raises."""
    cfg, jp, _, tcfg, tp = models
    ids, types, mask = batch
    x = torch.from_numpy(ids)
    got = tb.bert_encode(tcfg, tp, x, attn_impl="blockwise")
    want = jb.bert_encode(cfg, jp, jnp.asarray(ids), attn_impl="blockwise")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="padding-mask"):
        tb.bert_encode(tcfg, tp, x, attn_mask=torch.from_numpy(mask),
                       attn_impl="blockwise")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tb.bert_encode(tcfg, tp, x, attn_impl="nope")
    mcfg = jb.bert_tiny(moe_layers=(1,), num_experts=4)
    mp = jb.init_bert_params(mcfg, jax.random.PRNGKey(2))
    tmp = params_from_numpy(tb.bert_tiny(moe_layers=(1,), num_experts=4),
                            jax.tree_util.tree_map(np.asarray, mp),
                            device="cpu")
    assert set(tmp["layers"][1]) >= {"moe"} and "ffn" not in tmp["layers"][1]
    got = tb.bert_classify(tb.bert_tiny(moe_layers=(1,), num_experts=4), tmp,
                           x, torch.from_numpy(types))
    want = jb.bert_classify(mcfg, mp, jnp.asarray(ids), jnp.asarray(types))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    drawn = init_bert_params(tb.bert_tiny(moe_layers=(1,)), device="cpu")
    assert drawn["layers"][1]["moe"]["up_W"].shape == (8, 32, 64)


def test_bert_callable_attn_impl_and_mask_guard(models, batch):
    """A callable attn_impl gets the mask by the convention it declares
    (a 4th positional slot or an explicit mask keyword) and equals the
    JAX package's; a mask-blind callable on a padded batch raises."""
    cfg, jp, _, tcfg, tp = models
    ids, _, mask = batch
    m = mask.copy()
    m[2, :5] = 1    # no fully padded example: dense gives NaN rows there
    x, tm = torch.from_numpy(ids), torch.from_numpy(m)

    def t_impl(q, k, v, attn_mask):
        return tb.dense_attention(q, k, v,
                                  mask=attn_mask[:, None, None, :] > 0)

    def j_impl(q, k, v, attn_mask):
        return jb.dense_attention(q, k, v,
                                  mask=attn_mask[:, None, None, :] > 0)

    got = tb.bert_encode(tcfg, tp, x, attn_mask=tm, attn_impl=t_impl)
    want = jb.bert_encode(cfg, jp, jnp.asarray(ids),
                          attn_mask=jnp.asarray(m), attn_impl=j_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kw = tb.bert_encode(tcfg, tp, x, attn_mask=tm,
                        attn_impl=lambda q, k, v, kv_mask=None: t_impl(
                            q, k, v, kv_mask))
    np.testing.assert_allclose(kw.numpy(), got.numpy(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="mask"):
        tb.bert_encode(tcfg, tp, x, attn_mask=tm,
                       attn_impl=lambda q, k, v: tb.dense_attention(q, k, v))
    with pytest.raises(ValueError, match="causal"):
        tb.bert_encode(tcfg, tp, x, attn_impl=t_impl, causal=True)


def test_sharding_rules_cover_params(models):
    """The JAX package's rules as the port's spec tree: the same structure
    as the parameters, column/row-parallel over tp, experts over ep."""
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    mcfg = tb.bert_tiny(moe_layers=(1,))
    params = init_bert_params(mcfg, device="cpu")
    rules = tb.sharding_rules(mcfg, DeviceMesh(dp=1, tp=1))
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda _: 0, params)) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, rules,
                               is_leaf=lambda r: hasattr(r, "spec"))))
    assert tuple(rules["layers"][0]["qkv_W"].spec) == (None, "tp")
    assert tuple(rules["layers"][0]["ffn"]["down_W"].spec) == ("tp", None)
    assert tuple(rules["layers"][1]["moe"]["up_W"].spec) == ("tp", None,
                                                             None)
    assert tuple(tb.sharding_rules(mcfg, DeviceMesh(dp=1), ep="ep")[
        "layers"][1]["moe"]["down_b"].spec) == ("ep", None)

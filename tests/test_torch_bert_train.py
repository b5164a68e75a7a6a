"""BERT fine-tuning in the port (deeplearning4j_tpu_torch/models) against
the JAX package at bert_tiny on the CPU, with the same parameters carried
across by `params_from_numpy`.

Dropout is off in every comparison with JAX (`train=True` with no rng in
JAX and no generator in the port): the two packages draw dropout masks
from different generators. The JAX flash path runs its Pallas kernels in
interpret mode. Tolerances: the loss 1e-5; gradients atol 1e-6 /
rtol 1e-5 (f32 sums over the batch and sequence run in another order;
the largest deviation measured is 3e-8); Adam parameters 1e-5 after three
steps of lr 1e-3."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import (init_bert_params,
                                                     param_leaves,
                                                     params_from_numpy)

GRAD_TOL = dict(atol=1e-6, rtol=1e-5)

#: per attention impl: padded lengths of the 3 examples. Flash takes a
#: fully padded example; dense needs every example non-empty (a row with
#: every key masked is NaN in both packages)
LENGTHS = {"flash": [20, 13, 0], "dense": [20, 13, 5]}


@pytest.fixture(scope="module")
def models():
    cfg = jb.bert_tiny()
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return cfg, jp, tree, tb.bert_tiny()


def _batch(impl, b=3, t=20, seed=0):
    rng = np.random.default_rng(seed)
    lens = LENGTHS[impl]
    return {"input_ids": rng.integers(0, 128, (b, t)),
            "token_type_ids": rng.integers(0, 2, (b, t)),
            "attention_mask": (np.arange(t)[None] < np.array(lens)[:, None]
                               ).astype(np.int32),
            "labels": rng.integers(0, 3, (b,))}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _trainable(tcfg, tree):
    params = params_from_numpy(tcfg, tree, device="cpu")
    for x in param_leaves(params):
        x.requires_grad_(True)
    return params


def _port_loss_and_grads(tcfg, params, batch, **kw):
    for x in param_leaves(params):
        x.grad = None
    loss = tb.classification_loss(tcfg, params, batch, **kw)
    loss.backward()
    # leaves the loss does not reach (the MLM head) get zeros, as in JAX
    return loss.detach(), [torch.zeros_like(x) if x.grad is None
                           else x.grad.clone() for x in param_leaves(params)]


def test_param_leaves_follow_the_jax_tree_order(models):
    _, _, tree, tcfg = models
    params = params_from_numpy(tcfg, tree, device="cpu")
    leaves = jax.tree_util.tree_leaves(tree)
    ours = param_leaves(params)
    assert len(ours) == len(leaves)
    for a, b in zip(ours, leaves):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_classification_loss_and_gradients_match_jax(models, impl):
    cfg, jp, tree, tcfg = models
    batch = _batch(impl)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jb.classification_loss(cfg, p, _jax(batch), train=True,
                                         rng=None, attn_impl=impl))(jp)
    params = _trainable(tcfg, tree)
    loss, grads = _port_loss_and_grads(tcfg, params, _torch(batch),
                                       train=True, attn_impl=impl)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    paths = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    assert len(paths) == len(grads)
    for (path, want), got in zip(paths, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)


def test_three_adam_steps_match_optax(models):
    cfg, jp, tree, tcfg = models
    batch = _batch("flash", seed=1)
    tx = optax.adam(1e-3)

    @jax.jit
    def step(p, o):
        g = jax.grad(lambda pp: jb.classification_loss(
            cfg, pp, _jax(batch), train=True, rng=None,
            attn_impl="flash"))(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o

    p, o = jp, tx.init(jp)
    for _ in range(3):
        p, o = step(p, o)

    params = _trainable(tcfg, tree)
    opt = torch.optim.Adam(param_leaves(params), lr=1e-3,
                           betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        opt.zero_grad()
        tb.classification_loss(tcfg, params, _torch(batch), train=True,
                               attn_impl="flash").backward()
        opt.step()
    paths = jax.tree_util.tree_flatten_with_path(p)[0]
    for (path, want), got in zip(paths, param_leaves(params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("seed", [None, 3])
def test_remat_gives_the_same_gradients(models, seed):
    """`cfg.remat` recomputes each layer in the backward; with dropout on
    (a generator) the recomputed masks must be the forward's."""
    _, _, tree, tcfg = models
    batch = _torch(_batch("flash", seed=2))
    out = []
    for remat in (False, True):
        cfg = tb.bert_tiny(remat=remat)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        params = _trainable(cfg, tree)
        out.append(_port_loss_and_grads(cfg, params, batch, train=True,
                                        generator=gen, attn_impl="flash"))
        if gen is not None:
            # the generator moved on past every layer's draws
            out[-1] += (gen.get_state(),)
    (l0, g0, *s0), (l1, g1, *s1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_finetune_loss_decreases():
    """The port's twin of tests/test_bert.py::test_finetune_loss_decreases:
    30 Adam steps with dropout on bring the loss below 0.7 of the first."""
    cfg = tb.bert_tiny()
    params = init_bert_params(cfg, seed=1, device="cpu")
    for x in param_leaves(params):
        x.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {"input_ids": torch.from_numpy(rng.integers(0, 128, (8, 16))),
             "token_type_ids": torch.zeros((8, 16), dtype=torch.long),
             "attention_mask": torch.ones((8, 16)),
             "labels": torch.from_numpy(rng.integers(0, 3, (8,)))}
    opt = torch.optim.Adam(param_leaves(params), lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(30):
        opt.zero_grad()
        loss = tb.classification_loss(cfg, params, batch, train=True,
                                      generator=gen, attn_impl="flash")
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7


def test_dropout_is_reproducible_from_one_generator_seed(models):
    _, _, tree, tcfg = models
    params = params_from_numpy(tcfg, tree, device="cpu")
    batch = _torch(_batch("flash", seed=4))

    def loss(seed, train=True):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return tb.classification_loss(tcfg, params, batch, train=train,
                                      generator=gen, attn_impl="flash")

    assert torch.equal(loss(5), loss(5))
    assert not torch.equal(loss(5), loss(6))
    assert not torch.equal(loss(5), loss(None))
    # dropout needs train, a rate above 0 and a generator, as in JAX
    assert torch.equal(loss(5, train=False), loss(None))
    x = torch.ones(4000)
    y = tb._dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert 0.85 < float(kept.float().mean()) < 0.95
    assert torch.allclose(y[kept], torch.tensor(1 / 0.9))
    assert tb._dropout(x, 0.0, True, torch.Generator()) is x


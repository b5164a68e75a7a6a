"""The port's parallel/ on two-axis meshes of four ranks against the JAX
package on the CPU: the causal flash ring at sp=4 (diagonal, past and
future blocks all occur), ShardedTrainer over dp × tp = 2 × 2 with
column- and row-parallel weights stored as shards (and its checkpoint
resume under ElasticTrainer), and the long-context
recipe of examples/long_context_bert.py (ring attention + remat + ZeRO-1
over a dp × sp = 2 × 2 mesh) on bert_tiny for 3 steps. One module-scoped
fixture spawns the four gloo ranks (tests/torch_parallel_ranks.py); the
JAX side runs on four of the conftest's virtual devices.

Tolerances: the ring's output 2e-5 and gradients 2e-4 (the JAX package's
own); the dp × tp losses 1e-5 relative and the parameters 1e-5 absolute
after 20 Adam steps; the recipe's losses 1e-5 relative and parameters
2e-5 absolute after 3 Adam(1e-4) steps (f32 sums in another order).
"""
import numpy as np
import pytest

import torch_parallel_ranks as R

CASES = ["ring4_causal", "sharded_dp_tp", "sharded_dp_tp_resume", "recipe"]
T_SP = 2


def _recipe_inputs():
    import jax
    from deeplearning4j_tpu.models.bert import bert_tiny, init_bert_params
    T, B = 64 * T_SP, 2 * 2
    cfg = bert_tiny(max_position_embeddings=T, remat=True)
    params = jax.tree_util.tree_map(
        np.asarray, init_bert_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (B, T))
    labels = rng.integers(0, cfg.num_labels, (B,))
    return cfg, params, ids, labels


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, params, ids, labels = _recipe_inputs()
    inputs = {"recipe_params": params, "recipe_batch": (ids, labels)}
    return R.spawn(4, CASES, tmp_path_factory.mktemp("par4"), inputs)


def _ok(ranks, case):
    for r, res in enumerate(ranks[case]):
        assert "error" not in res, f"rank {r}:\n{res.get('error')}"
    return [res["ok"] for res in ranks[case]]


def test_ring_attention_flash_causal_at_four_ranks(ranks):
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel.ring_attention import dense_attention
    res = _ok(ranks, "ring4_causal")
    q, k, v = (jnp.asarray(a) for a in R.qkv(3, (1, 2, 64, 16)))
    want = np.asarray(dense_attention(q, k, v, causal=True))
    gd = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(
        dense_attention(q, k, v, causal=True))), (0, 1, 2))(q, k, v)
    for r in res:
        np.testing.assert_allclose(r["out"], want, atol=2e-5, rtol=2e-5)
        for a, b in zip(r["grads"], gd):
            np.testing.assert_allclose(a, np.asarray(b), atol=2e-4,
                                       rtol=2e-4)


def test_sharded_trainer_dp_tp_matches_jax(ranks, devices8):
    """dp × tp: each rank stores its tp shard of W1 (columns) and W2
    (rows); the loss trajectory and the reassembled weights equal the JAX
    ShardedTrainer's on a 2 × 2 mesh, and the loss falls."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from deeplearning4j_tpu.nn import Adam
    from deeplearning4j_tpu.parallel import DeviceMesh, ShardedTrainer
    res = _ok(ranks, "sharded_dp_tp")
    mesh = DeviceMesh(devices8[:4], dp=2, tp=2).mesh
    params, x, y = R.sharded_inputs()
    specs = {"W1": NamedSharding(mesh, P(None, "tp")),
             "W2": NamedSharding(mesh, P("tp", None))}

    def loss_fn(p, batch, rng_):
        xb, yb = batch
        logp = jax.nn.log_softmax(jax.nn.relu(xb @ p["W1"]) @ p["W2"], -1)
        return -jnp.mean(jnp.sum(yb * logp, -1))

    tr = ShardedTrainer(loss_fn, Adam(0.05), mesh, specs)
    p, s = tr.init(params)
    batch = tr.shard_batch((jnp.asarray(x), jnp.asarray(y)))
    losses = []
    for _ in range(20):
        p, s, loss = tr.fit_batch(p, s, batch, jax.random.PRNGKey(0))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7
    W1, W2 = np.asarray(p["W1"]), np.asarray(p["W2"])
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        t = r["coords"]["tp"]
        assert r["W1_shape"] == (8, 16) and r["W2_shape"] == (16, 2)
        np.testing.assert_allclose(r["W1"], W1[:, 16 * t:16 * (t + 1)],
                                   atol=1e-5)
        np.testing.assert_allclose(r["W2"], W2[16 * t:16 * (t + 1)],
                                   atol=1e-5)


def test_sharded_trainer_dp_tp_resume_equals_uninterrupted(ranks):
    """ElasticTrainer over the dp × tp = 2 × 2 ShardedTrainer: process 0
    saves the whole state (tp shards and their Adam moments gathered) and
    every rank cuts its own block back out on resume, so the run stopped
    after step 5 ends bit for bit where the uninterrupted run ends, on
    every rank."""
    for r in _ok(ranks, "sharded_dp_tp_resume"):
        assert r["start"] == 4 and r["W1_shape"] == (8, 16)
        assert r["leaves"] == len(r["equal"]) >= 7 and all(r["equal"])


def test_long_context_recipe_matches_jax_example(ranks, devices8):
    """examples/long_context_bert.py at dp 2 × sp 2 on bert_tiny: the
    port's flash ring (plain kernel versions on the CPU) + remat + ZeRO-1
    Adam through ShardedTrainer against the example's JAX step on the same
    mesh shape, 3 steps: losses and parameters."""
    import jax
    import optax
    from jax.sharding import Mesh, PartitionSpec as P
    from deeplearning4j_tpu.models.bert import (classification_loss,
                                                sharding_rules)
    from deeplearning4j_tpu.parallel.mesh import shard_map
    from deeplearning4j_tpu.parallel.ring_attention import \
        make_ring_attention
    from deeplearning4j_tpu.parallel.zero import shard_optimizer_state
    res = _ok(ranks, "recipe")
    cfg, params, ids, labels = _recipe_inputs()
    mesh = Mesh(np.array(devices8[:4]).reshape(2, T_SP), ("dp", "sp"))
    rules = sharding_rules(cfg, mesh, dp="dp", tp=None)
    params = jax.tree_util.tree_map(jax.device_put, params, rules)
    tx = optax.adam(1e-4)
    opt_state = shard_optimizer_state(tx.init(params), mesh, axis="dp")
    spec = P(None, None, "sp", None)
    ring = shard_map(make_ring_attention(mesh, "sp"), mesh=mesh,
                     in_specs=(spec, spec, spec), out_specs=spec,
                     check_vma=False)
    batch = {"input_ids": ids, "labels": labels}

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(lambda p: classification_loss(
            cfg, p, batch, train=False, attn_impl=ring))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            params))
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        got = jax.tree_util.tree_leaves(r["params"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=2e-5)

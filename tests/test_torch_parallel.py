"""The port's parallel/ at two ranks against the JAX package on the CPU.

One module-scoped fixture spawns two gloo ranks (torch.multiprocessing
with a FileStore under tmp_path; tests/torch_parallel_ranks.py, which
imports no JAX) and runs every contract's rank code once; each test then
holds its contract's results against the JAX package, which runs here on
the conftest's virtual devices (a mesh of the same shape) or on one
device where the reference's own contract is "dp equals single device".
Starting parameters are the JAX networks', carried across as numpy.

Tolerances, as the JAX package's tests/test_parallel.py states them:
outputs 2e-4 relative and 2e-5 absolute; flash-ring gradients 2e-4; masked
flash-ring gradients 5e-3 relative and 5e-4 absolute; trained parameters
2e-4 relative and 2e-5 absolute (f32 sums in another order). Within the
port: stepsPerDispatch against the sequential loop bit for bit, ZeRO-1
against replicated state 2e-4/2e-5.
"""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R

OUT = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
MASKED_GRAD = dict(rtol=5e-3, atol=5e-4)
CASES = ["ring", "ulysses", "pipeline", "wrapper", "wrapper_fused",
         "wrapper_accum", "zero", "espt", "averaging", "sharded_accum",
         "sharded_guarded"]


def _jnp_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_mlp(make, *a, **kw):
    import deeplearning4j_tpu.nn as jnn
    net = jnn.MultiLayerNetwork(make(jnn, *a, **kw)).init()
    return net


def _jax_graph(conf=None):
    import deeplearning4j_tpu.nn as jnn
    from deeplearning4j_tpu.nn.graph import ComputationGraph
    return ComputationGraph(conf or R.graph_conf(jnn)).init()


def _jax_resnetish():
    import deeplearning4j_tpu.nn as jnn
    from deeplearning4j_tpu.nn.conf.graph_vertices import ElementWiseVertex
    return _jax_graph(R.resnetish_conf(jnn, ElementWiseVertex))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import deeplearning4j_tpu.nn as jnn
    inputs = {}
    for key, net in (("mlp1", _jax_mlp(R.mlp_conf, 1)),
                     ("mlp3", _jax_mlp(R.mlp_conf, 3)),
                     ("mlp5", _jax_mlp(R.mlp_conf, 5)),
                     ("graph", _jax_graph()),
                     ("resnetish", _jax_resnetish()),
                     ("accum", _jax_mlp(R.accum_conf)),
                     ("conv_bn", _jax_mlp(R.conv_bn_conf, 12)),
                     ("adam7", _jax_mlp(R.mlp_conf, 7,
                                        updater=jnn.Adam(0.01))),
                     ("espt", _jax_mlp(lambda nn: R.espt_conf(nn)))):
        inputs[key] = (_jnp_tree(net._params), _jnp_tree(net._state))
    return inputs, R.spawn(2, CASES, tmp_path_factory.mktemp("par2"),
                           inputs)


def _ok(ranks, case):
    results = ranks[1][case]
    for r, res in enumerate(results):
        assert "error" not in res, f"rank {r}:\n{res.get('error')}"
    return [res["ok"] for res in results]


def _mesh(devices8, n, **axes):
    from deeplearning4j_tpu.parallel import DeviceMesh
    return DeviceMesh(devices8[:n], **axes).mesh


def _same_on_ranks(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(np.asarray(r[key]),
                                      np.asarray(results[0][key]))


# -- the mesh -------------------------------------------------------------------
def test_device_mesh_shapes_and_world_error():
    """Without a process group the world is one rank: a mesh that asks for
    more raises a ValueError naming torchrun; shapes and -1 as in the
    reference."""
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    m = DeviceMesh(dp=1, tp=1, sp=1)
    assert m.size == 1 and m.shape == {"dp": 1, "tp": 1, "sp": 1}
    assert DeviceMesh(dp=-1, tp=1).shape["dp"] == 1
    with pytest.raises(ValueError, match="torchrun"):
        DeviceMesh(dp=2, tp=2, sp=2)


def test_initialize_distributed_without_a_coordinator_is_a_world_of_one(
        monkeypatch):
    from deeplearning4j_tpu_torch.parallel import initialize_distributed
    for k in ("DL4J_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False


# -- ring attention -------------------------------------------------------------
def test_ring_attention_matches_jax(ranks, devices8):
    """The plain ring at sp=2 against the JAX package's ring."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import ring_attention
    mesh = _mesh(devices8, 2, sp=2)
    res = _ok(ranks, "ring")
    _same_on_ranks(res, "plain")
    q, k, v = (jnp.asarray(a) for a in R.qkv(3, (2, 4, 64, 8)))
    np.testing.assert_allclose(res[0]["plain"],
                               np.asarray(ring_attention(q, k, v, mesh)),
                               **OUT)


def test_ring_attention_causal_matches_jax(ranks, devices8):
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import ring_attention
    mesh = _mesh(devices8, 2, sp=2)
    res = _ok(ranks, "ring")
    q, k, v = (jnp.asarray(a) for a in R.qkv(4, (1, 2, 32, 4)))
    want = np.asarray(ring_attention(q, k, v, mesh, causal=True))
    np.testing.assert_allclose(res[0]["plain_causal"], want, **OUT)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_flash_path_forward_and_gradients(ranks, causal):
    """The flash ring (B1 per block, B2a/B2b under the global lse; their
    plain versions on the CPU) against JAX dense attention: forward and
    the gradients of sum(sin(out))."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel.ring_attention import dense_attention
    res = _ok(ranks, "ring")
    tag = "flash_causal" if causal else "flash"
    q, k, v = (jnp.asarray(a) for a in R.qkv(0, (1, 2, 32, 16)))
    np.testing.assert_allclose(
        res[0][tag], np.asarray(dense_attention(q, k, v, causal=causal)),
        atol=2e-5, rtol=2e-5)
    gd = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(
        dense_attention(q, k, v, causal=causal))), (0, 1, 2))(q, k, v)
    for a, b in zip(res[0][tag + "_grads"], gd):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD)


def test_ring_attention_masked_matches_jax(ranks, devices8):
    """The key mask rotates with its block: the plain ring, masked and
    masked causal, against the JAX package's ring on the valid rows."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import ring_attention
    mesh = _mesh(devices8, 2, sp=2)
    res = _ok(ranks, "ring")
    q, k, v = (jnp.asarray(a) for a in R.qkv(18, (2, 4, 64, 8)))
    m = jnp.asarray(R.lengths_mask([40, 64], 64))
    want = np.asarray(ring_attention(q, k, v, mesh, kv_mask=m))
    for i, L in enumerate([40, 64]):
        np.testing.assert_allclose(res[0]["plain_masked"][i, :, :L],
                                   want[i, :, :L], **OUT)
    q, k, v = (jnp.asarray(a) for a in R.qkv(19, (1, 2, 32, 4)))
    m = jnp.asarray(R.lengths_mask([24], 32))
    want = np.asarray(ring_attention(q, k, v, mesh, causal=True, kv_mask=m))
    np.testing.assert_allclose(res[0]["plain_masked_causal"][:, :, :24],
                               want[:, :, :24], **OUT)


def test_ring_attention_masked_flash_path(ranks):
    """The masked flash ring (fully masked tail blocks on a rank) against
    JAX dense attention, forward on the valid rows and gradients through
    the valid region."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel.ring_attention import dense_attention
    res = _ok(ranks, "ring")
    q, k, v = (jnp.asarray(a) for a in R.qkv(20, (2, 4, 64, 8)))
    m = jnp.asarray(R.lengths_mask([40, 64], 64))
    want = np.asarray(dense_attention(q, k, v,
                                      mask=m[:, None, None, :] > 0))
    got = res[0]["flash_masked"]
    assert np.isfinite(got).all()
    for i, L in enumerate([40, 64]):
        np.testing.assert_allclose(got[i, :, :L], want[i, :, :L], **OUT)

    def loss(q_, k_, v_):
        out = dense_attention(q_, k_, v_, mask=m[:, None, None, :] > 0)
        return jnp.sum(jnp.square(out * m[:, None, :, None]))

    gd = jax.grad(loss, (0, 1, 2))(q, k, v)
    for a, b in zip(res[0]["flash_masked_grads"], gd):
        np.testing.assert_allclose(a, np.asarray(b), **MASKED_GRAD)


def test_ring_attention_masked_flash_causal_left_padding(ranks):
    """Causal + LEFT padding: valid rows that causally see no valid key
    leak no gradient; held to the JAX -1e30 dense oracle."""
    import jax
    import jax.numpy as jnp
    res = _ok(ranks, "ring")
    q, k, v = (jnp.asarray(a) for a in R.qkv(22, (1, 2, 32, 4)))
    T = 32
    m = (np.arange(T)[None, :] >= 12).astype(np.float32)
    cm = np.tril(np.ones((T, T), bool))[None, None] & (m[:, None, None, :]
                                                        > 0)

    def dense(q_, k_, v_):
        logits = jnp.einsum("bhqd,bhkd->bhqk", q_, k_) / np.sqrt(4)
        logits = jnp.where(jnp.asarray(cm), logits, -1e30)
        return jax.nn.softmax(logits, axis=-1) @ v_

    np.testing.assert_allclose(res[0]["left_pad"][:, :, 12:],
                               np.asarray(dense(q, k, v))[:, :, 12:], **OUT)
    vm = jnp.asarray(m)[:, None, :, None]
    gd = jax.grad(lambda a, b, c: jnp.sum(jnp.square(dense(a, b, c) * vm)),
                  (0, 1, 2))(q, k, v)
    for a, b in zip(res[0]["left_pad_grads"], gd):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), **MASKED_GRAD)


def test_ring_attention_masked_flash_zero_length_and_bool_mask(ranks):
    """A zero-length example gets finite, exactly zero gradients (the -inf
    merged lse maps back to the kernels' +1e30 sentinel); a bool mask
    differentiates too."""
    res = _ok(ranks, "ring")
    for g in res[0]["zero_len_grads"]:
        assert np.isfinite(g).all()
        assert np.abs(g[0]).max() == 0
        assert np.abs(g[1]).max() > 0
    assert np.isfinite(res[0]["bool_mask_dq"][1]).all()


# -- Ulysses --------------------------------------------------------------------
def test_ulysses_matches_jax(ranks, devices8):
    """All-to-all attention at sp=2 (plain, causal, masked) against the JAX
    package's at the same mesh."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel.ulysses import ulysses_attention_sharded
    mesh = _mesh(devices8, 2, sp=2)
    res = _ok(ranks, "ulysses")
    q, k, v = (jnp.asarray(a) for a in R.qkv(11, (2, 4, 64, 8)))
    np.testing.assert_allclose(
        res[0]["plain"], np.asarray(ulysses_attention_sharded(mesh, q, k, v)),
        **OUT)
    q, k, v = (jnp.asarray(a) for a in R.qkv(12, (1, 4, 32, 4)))
    np.testing.assert_allclose(
        res[0]["causal"],
        np.asarray(ulysses_attention_sharded(mesh, q, k, v, causal=True)),
        **OUT)
    q, k, v = (jnp.asarray(a) for a in R.qkv(14, (2, 4, 64, 8)))
    m = jnp.asarray(R.lengths_mask([40, 64], 64))
    want = np.asarray(ulysses_attention_sharded(mesh, q, k, v, mask=m))
    for i, L in enumerate([40, 64]):
        np.testing.assert_allclose(res[0]["masked"][i, :, :L],
                                   want[i, :, :L], **OUT)


def test_ulysses_head_check_and_custom_fn_guard(ranks):
    res = _ok(ranks, "ulysses")
    for r in res:
        assert "divisible" in r["head_check"]
        assert "kv_mask" in r["guard"]


def test_ulysses_with_flash_attention_matches_jax_flash(ranks):
    """Ulysses with the flash kernels as attn_fn (B1, B2a, B2b on the local
    heads) against the JAX package's single-device flash attention, forward
    and gradients on a masked batch."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.kernels.flash_attention import flash_attention
    res = _ok(ranks, "ulysses")
    q, k, v = (jnp.asarray(a) for a in R.qkv(15, (2, 4, 64, 16)))
    m = jnp.asarray(R.lengths_mask([40, 64], 64))
    vm = m[:, None, :, None]

    def f(q_, k_, v_):
        return flash_attention(q_, k_, v_, kv_mask=m, interpret=True)

    want = np.asarray(f(q, k, v))
    for i, L in enumerate([40, 64]):
        np.testing.assert_allclose(res[0]["flash"][i, :, :L],
                                   want[i, :, :L], **OUT)
    gd = jax.grad(lambda a, b, c: jnp.sum(jnp.square(f(a, b, c) * vm)),
                  (0, 1, 2))(q, k, v)
    for a, b in zip(res[0]["flash_grads"], gd):
        np.testing.assert_allclose(a, np.asarray(b), **MASKED_GRAD)


# -- blockwise (one process) ----------------------------------------------------
def test_blockwise_attention_matches_jax():
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import blockwise_attention as jblock
    from deeplearning4j_tpu_torch.parallel import blockwise_attention
    q, k, v = R.qkv(5, (2, 2, 50, 4))   # T not a multiple of the block
    m = R.lengths_mask([37, 50], 50)
    for causal, mask in ((True, None), (False, m)):
        got = blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  block_size=16, causal=causal,
                                  kv_mask=None if mask is None
                                  else torch.from_numpy(mask))
        want = jblock(*(jnp.asarray(a) for a in (q, k, v)), block_size=16,
                      causal=causal,
                      kv_mask=None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)


# -- the pipeline ---------------------------------------------------------------
def test_pipeline_forward_and_gradients_match_jax(ranks, devices8):
    """GPipe over pp=2 with 4 microbatches against the JAX package's
    pipeline on the same mesh: the output and the stacked parameters'
    gradients of sum(y²)."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import (make_pipeline_fn,
                                             stack_stage_params)
    res = _ok(ranks, "pipeline")
    mesh = _mesh(devices8, 2, pp=2)
    stages, x = R.pipeline_inputs()
    stacked = stack_stage_params(stages)
    pipe = make_pipeline_fn(lambda p, h: jnp.tanh(h @ p["W"] + p["b"]),
                            mesh, n_microbatches=4)
    want = np.asarray(pipe(stacked, jnp.asarray(x)))
    g = jax.grad(lambda sp: jnp.sum(pipe(sp, jnp.asarray(x)) ** 2))(stacked)
    for r in res:
        np.testing.assert_allclose(r["y"], want, **OUT)
        np.testing.assert_allclose(r["dW"], np.asarray(g["W"]), **OUT)
        np.testing.assert_allclose(r["db"], np.asarray(g["b"]), **OUT)


# -- ParallelWrapper --------------------------------------------------------------
def _jax_fit(net, x, y, batch, epochs):
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator
    it = ArrayDataSetIterator(x, y, batch_size=batch)
    for _ in range(epochs):
        it.reset()
        for ds in it:
            net.fit(ds)
    return net


def _close_tree(got, jparams, **tol):
    for n, d in _jnp_tree(jparams).items():
        for k, v in d.items():
            np.testing.assert_allclose(got[f"{n}/{k}"], v, **tol)


def test_parallel_wrapper_matches_single_device(ranks):
    """dp at two ranks equals single-device training: the port's wrapper
    against the JAX network trained on one device."""
    res = _ok(ranks, "wrapper")
    x, y = R.mlp_data(64)
    single = _jax_fit(_jax_mlp(R.mlp_conf, 1), x, y, 32, 3)
    for r in res:
        _close_tree(r["matches_single"], single._params, **OUT)


def test_parallel_wrapper_ragged_batch_matches_single_device(ranks):
    """A ragged final batch: the padded rows carry zero weight, so the
    global loss is the mean over the real rows."""
    res = _ok(ranks, "wrapper")
    x, y = R.mlp_data(60)
    single = _jax_fit(_jax_mlp(R.mlp_conf, 3), x, y, 32, 2)
    _close_tree(res[0]["ragged"], single._params, **OUT)


def test_parallel_wrapper_steps_per_dispatch_bit_identical(ranks):
    res = _ok(ranks, "wrapper")
    for r in res:
        for key, v in r["seq"].items():
            np.testing.assert_array_equal(v, r["spd"][key])
        assert r["spd_iterations"][0] == r["spd_iterations"][1]
    x, y = R.mlp_data(80, seed=9)
    single = _jax_fit(_jax_mlp(R.mlp_conf, 5), x, y, 32, 3)
    _close_tree(res[0]["seq"], single._params, **OUT)


def test_parallel_wrapper_scanned_graph_model(ranks):
    """A wrapped ComputationGraph, stepsPerDispatch 2 bit for bit with the
    sequential loop, and against the JAX graph on one device."""
    res = _ok(ranks, "wrapper")
    for key, v in res[0]["graph"].items():
        np.testing.assert_array_equal(v, res[0]["graph_spd"][key])
    x, y = R.mlp_data(64, seed=10)
    _close_tree(res[0]["graph"], _jax_fit(_jax_graph(), x, y, 32,
                                          2)._params, **OUT)


def test_parallel_wrapper_batchnorm_uses_global_batch_statistics(ranks):
    """A conv + BatchNorm net at two ranks of 8 rows equals the JAX net
    trained on the 16-row batches on one device: parameters, BN running
    statistics and score (the BN sums are all-reduced over dp)."""
    res = _ok(ranks, "wrapper")
    x, y = R.conv_data(32)
    single = _jax_fit(_jax_mlp(R.conv_bn_conf, 12), x, y, 16, 2)
    for r in res:
        _close_tree(r["conv_bn"], single._params, **OUT)
        _close_tree(r["conv_bn_state"], single._state, **OUT)
        np.testing.assert_allclose(r["conv_bn_score"], float(single.score()),
                                   **OUT)


def test_parallel_wrapper_leaves_no_dp_context_after_fit(ranks):
    """After a wrapped fit that ends on a ragged batch, a rank's own
    net.fit steps alone (no all-reduce, no BN sums over dp, no stale share
    of the rows): bit for bit a fresh copy's plain fit on the same rows."""
    res = _ok(ranks, "wrapper")
    for r in res:
        (p, s, score), (pp, ps, pscore) = r["refit"], r["refit_plain"]
        for got, want in ((p, pp), (s, ps)):
            for key, v in want.items():
                np.testing.assert_array_equal(got[key], v)
        assert score == pscore
    assert not np.array_equal(res[0]["refit"][0]["0/W"],
                              res[1]["refit"][0]["0/W"])


def test_parallel_wrapper_fused_pairs_use_global_batch_statistics(ranks):
    """The conv1x1+BN pairs the fusion takes (B5/B7/B8's plain versions
    here) at two ranks of 8 rows: their batch sums and BN's backward sums
    are all-reduced over dp, so parameters, BN state and score equal the
    JAX graph (unfused: the same function) trained on the 16 rows."""
    res = _ok(ranks, "wrapper_fused")
    x, y = R.resnetish_data()
    single = _jax_fit(_jax_resnetish(), x, y, 16, 2)
    for r in res:
        assert r["pairs"] == 2
        _close_tree(r["params"], single._params, **OUT)
        _close_tree(r["state"], single._state, **OUT)
        np.testing.assert_allclose(r["score"], float(single.score()), **OUT)


def test_parallel_wrapper_gradient_accumulation_matches_single_device(
        ranks):
    """The conf's gradientAccumulation(2) under the wrapper: each pair of
    batches is one dp update of the pair's mean gradient, equal to the
    JAX network accumulating on one device."""
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator
    res = _ok(ranks, "wrapper_accum")
    x, y = R.mlp_data(64, seed=4)
    single = _jax_mlp(R.accum_conf)
    single.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2)
    assert single._iteration == 4
    for r in res:
        assert r["iterations"] == 4      # 2 epochs × 2 updates
        _close_tree(r["params"], single._params, **OUT)


def test_zero1_sharded_optimizer_matches_replicated(ranks):
    """ZeRO-1 over dp=2: the same parameters as the replicated Adam state
    (and as the JAX single-device run), each rank holding a smaller
    state; outside the wrapper's fit a rank refuses to step its blocks
    alone."""
    res = _ok(ranks, "zero")
    x, y = R.mlp_data(64, seed=9)
    import deeplearning4j_tpu.nn as jnn
    single = _jax_fit(_jax_mlp(R.mlp_conf, 7, updater=jnn.Adam(0.01)), x, y,
                      32, 2)
    for r in res:
        assert r["is_zero"]
        for key, v in r["plain"].items():
            np.testing.assert_allclose(r["zero"][key], v, **OUT)
        _close_tree(r["zero"], single._params, **OUT)
        replicated, sharded = r["bytes"]
        assert sharded < replicated
        assert "shardOptimizerState" in r["alone"]


def test_early_stopping_parallel_trainer_matches_jax(ranks):
    """EarlyStoppingParallelTrainer at two ranks: five dp epochs under the
    inherited scoring loop; scores and parameters against the JAX
    EarlyStoppingTrainer on one device (dp equals single device)."""
    from deeplearning4j_tpu.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu.optimize.early_stopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition)
    res = _ok(ranks, "espt")
    x, y = R.espt_data()
    net = _jax_mlp(lambda nn: R.espt_conf(nn))
    cfg = (EarlyStoppingConfiguration.Builder()
           .epochTerminationConditions(MaxEpochsTerminationCondition(5))
           .scoreCalculator(DataSetLossCalculator(
               ArrayDataSetIterator(x, y, batch_size=32), average=True))
           .modelSaver(InMemoryModelSaver()).build())
    want = EarlyStoppingTrainer(cfg, net,
                                ArrayDataSetIterator(x, y, 32)).fit()
    for r in res:
        assert r["totalEpochs"] == want.totalEpochs == 5
        np.testing.assert_allclose(r["bestModelScore"], want.bestModelScore,
                                   **OUT)
        for e, s in want.scoreVsEpoch.items():
            np.testing.assert_allclose(r["scoreVsEpoch"][e], s, **OUT)
        _close_tree(r["params"], net._params, **OUT)


def test_parameter_averaging_trainer_matches_jax(ranks, devices8):
    """Local steps between averages, consensus after: the averaged weights
    and the loss trajectory against the JAX trainer on dp=2."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn import Sgd
    from deeplearning4j_tpu.parallel import ParameterAveragingTrainer
    res = _ok(ranks, "averaging")
    x, y, true_w = R.averaging_inputs()
    tr = ParameterAveragingTrainer(
        lambda p, b, r: jnp.mean((b[0] @ p["w"] - b[1]) ** 2), Sgd(0.1),
        _mesh(devices8, 2, dp=2), averaging_frequency=2)
    p, s = tr.init({"w": np.zeros((4, 1), np.float32)})
    losses = []
    for i in range(40):
        p, s, loss = tr.fit_batch(p, s, (jnp.asarray(x), jnp.asarray(y)),
                                  jax.random.PRNGKey(0), i)
        losses.append(float(loss))
    for r in res:
        np.testing.assert_allclose(r["w"], np.asarray(tr.average(p)["w"]),
                                   **OUT)
        np.testing.assert_allclose(r["losses"], losses, **OUT)
        np.testing.assert_allclose(r["w"], true_w, atol=0.1)


def test_sharded_trainer_accumulation_matches_sequential_reference(ranks):
    """ShardedTrainer(accumulation=G) at dp=2: one update from G
    microbatches equals the JAX sequential-sum reference (mean of the G
    gradients, one Sgd step)."""
    import jax
    import jax.numpy as jnp
    res = _ok(ranks, "sharded_accum")
    xs, ys, p0 = R.accum_inputs()

    def loss_fn(p, x, y):
        logp = jax.nn.log_softmax(x @ p["W"] + p["b"], -1)
        return -jnp.mean(jnp.sum(y * logp, -1))

    grads = [jax.grad(loss_fn)(p0, xs[i], ys[i]) for i in range(len(xs))]
    losses = [float(loss_fn(p0, xs[i], ys[i])) for i in range(len(xs))]
    for r in res:
        for k in p0:
            g = sum(np.asarray(gr[k]) for gr in grads) / len(grads)
            np.testing.assert_allclose(r["params"][k], p0[k] - 0.1 * g,
                                       atol=1e-6)
        np.testing.assert_allclose(r["loss"], np.mean(losses), rtol=1e-6)


def test_sharded_trainer_guarded_step(ranks):
    """Under a TrainingGuardian the sharded step is the unguarded one on a
    healthy batch (bit for bit) and refuses a batch that makes the loss
    NaN on one rank: the dp mean is NaN on every rank, so every rank keeps
    its parameters."""
    for r in _ok(ranks, "sharded_guarded"):
        assert r["healthy_equal"] and r["nan_kept"]
        assert r["skipped"] == 1


# -- threshold encoding (one process) ------------------------------------------
def test_threshold_encoding_matches_jax():
    """The residual rule step by step against the JAX package's optax
    transform, then the encoded updater's 60 steps."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn import Sgd as JSgd
    from deeplearning4j_tpu.parallel import (encoded_updater as jenc,
                                             threshold_encoding as jthr)
    from deeplearning4j_tpu_torch.nn import Sgd
    from deeplearning4j_tpu_torch.nn.updaters import apply_updates
    from deeplearning4j_tpu_torch.parallel import (encoded_updater,
                                                   threshold_encoding)
    g = np.asarray([0.6, 0.3, -0.7, 0.1], np.float32)
    tx, jtx = threshold_encoding(initial_threshold=0.5), jthr(
        initial_threshold=0.5)
    st = tx.init([torch.zeros(4)])
    jst = jtx.init({"w": jnp.zeros(4)})
    for _ in range(3):
        sent, st = tx.update([torch.from_numpy(g)], st, None)
        jsent, jst = jtx.update({"w": jnp.asarray(g)}, jst)
        np.testing.assert_allclose(sent[0].numpy(), np.asarray(jsent["w"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(st["residual"][0].numpy(),
                                   np.asarray(jst["residual"]["w"]),
                                   rtol=1e-5, atol=1e-7)
        assert float(st["threshold"]) == pytest.approx(
            float(jst["threshold"]))
        assert int(st["nnz"]) == int(jst["nnz"])
    etx, jetx = encoded_updater(Sgd(0.5), initial_threshold=0.05), jenc(
        JSgd(0.5), initial_threshold=0.05)
    w = torch.tensor([1.0, -1.0])
    jw = jnp.asarray([1.0, -1.0])
    st, jst = etx.init([w]), jetx.init({"w": jw})
    for _ in range(60):
        upd, st = etx.update([0.2 * w], st, [w])
        w = w + upd[0]
        jupd, jst = jetx.update({"w": 0.2 * jw}, jst)
        jw = jw + jupd["w"]
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5)
    assert float(w.abs().max()) < 0.5
    del apply_updates


def test_sparse_wire_codec_matches_jax():
    """The sparse wire format's encode/decode as plain tensor math against
    the JAX package's: payloads, residuals and the decoded mean; a corrupt
    count poisons the row; check_payload names the violation."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import compression as J
    from deeplearning4j_tpu_torch.parallel import compression as T
    from deeplearning4j_tpu_torch.resilience.errors import WireFormatError
    rng = np.random.default_rng(3)
    flat = (rng.standard_normal(64) * 0.01).astype(np.float32)
    cap = T.wire_capacity(64, 0.25)
    assert cap == J.wire_capacity(64, 0.25)
    st = {"residual": torch.zeros(64), "threshold": torch.tensor(0.01),
          "nnz": torch.tensor(0, dtype=torch.int32)}
    jst = {"residual": jnp.zeros(64), "threshold": jnp.float32(0.01),
           "nnz": jnp.int32(0)}
    pay, st2 = T.sparse_encode(torch.from_numpy(flat), st, cap)
    jpay, jst2 = J.sparse_encode(jnp.asarray(flat), jst, cap)
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    np.testing.assert_allclose(st2["residual"].numpy(),
                               np.asarray(jst2["residual"]), atol=1e-8)
    rows = torch.stack([pay, pay])
    np.testing.assert_allclose(
        T.sparse_decode(rows, 64, torch.float32).numpy(),
        np.asarray(J.sparse_decode(jnp.stack([jpay, jpay]), 64,
                                   jnp.float32)), atol=1e-8)
    bad = pay.clone()
    bad[0] += 1
    assert torch.isnan(T.sparse_decode(bad[None], 64, torch.float32)).all()
    assert T.check_payload(pay, 64, cap)[0] == int(pay[0])
    with pytest.raises(WireFormatError, match="count"):
        T.check_payload(bad, 64, cap)

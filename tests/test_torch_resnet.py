"""ResNet-50 of the port's zoo against the JAX package's, with the fusion on,
on the CPU: `ResNet50(numClasses=4, inputShape=(32, 32, 3))`, batch 2, the
JAX weights carried across (BN parameters and running statistics drawn
away from their init, so the fold is not the identity). The JAX side is its
jitted forward, whose 36 marked pairs run the Pallas epilogue kernel in
interpret mode; the port's run the kernel's plain version.

At random init the activations grow to several hundred by res5 and the
softmax saturates, so the output alone proves little: the features are
compared at four nodes across the depth. Tolerance 1e-4 × max(1, max
|JAX|) (f32 sums in another order, through 53 layers)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.models.zoo import ResNet50
from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                         graph_params_from_numpy,
                                         graph_params_to_numpy)

NODES = ("res2_0_a_bn", "res3_0_relu", "res5_2_relu", "avgpool")
SHAPE = dict(numClasses=4, inputShape=(32, 32, 3))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


@pytest.fixture(scope="module")
def nets():
    mp = pytest.MonkeyPatch()
    mp.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    try:
        jnet = JResNet50(**SHAPE).init()
        rng = np.random.default_rng(0)
        params = jax.tree_util.tree_map(np.asarray, jnet._params)
        state = jax.tree_util.tree_map(np.asarray, jnet._state)
        for name, st in state.items():
            n = st["mean"].shape[0]
            st["mean"] = (rng.standard_normal(n) * 0.2).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
            params[name]["gamma"] = rng.uniform(0.5, 1.2, n).astype(
                np.float32)
            params[name]["beta"] = (rng.standard_normal(n) * 0.1).astype(
                np.float32)
        jnet._params = jax.tree_util.tree_map(jnp.asarray, params)
        jnet._state = jax.tree_util.tree_map(jnp.asarray, state)
        tnet = graph_params_from_numpy(ComputationGraph(ResNet50(**SHAPE)
                                                        .conf()),
                                       params, state, device="cpu")
    finally:
        mp.undo()
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    fwd = jax.jit(lambda p, s, xx: jnet._forward(p, s, {"input": xx}, False,
                                                 None)[0])
    acts = fwd(jnet._params, jnet._state, jnp.asarray(x))
    want = {n: np.asarray(acts[n]) for n in NODES + ("fc",)}
    return jnet, tnet, params, x, want


def test_the_same_36_pairs_are_marked(nets):
    jnet, tnet, _, _, _ = nets
    assert len(tnet._fused_pairs) == 36
    assert tnet._fused_pairs == jnet._fused_pairs
    assert tnet.numParams() == jnet.numParams()


def test_output_matches_the_jax_jitted_forward(nets):
    _, tnet, _, x, want = nets
    got = tnet.output(x)
    assert got.shape == (2, 4) and torch.isfinite(got).all()
    _close(got.numpy(), want["fc"], "fc")


@pytest.mark.parametrize("node", NODES)
def test_features_match_the_jax_jitted_forward(nets, node):
    _, tnet, _, x, want = nets
    acts = tnet.feedForward(x)
    _close(acts[node].numpy(), want[node], node)


def test_weights_round_trip_and_fresh_init_differs(nets):
    _, tnet, params, _, _ = nets
    back, _ = graph_params_to_numpy(tnet)
    for name in params:
        for k in params[name]:
            np.testing.assert_array_equal(back[name][k], params[name][k])
    fresh = ResNet50(**SHAPE).init("cpu")
    assert fresh.numParams() == tnet.numParams()
    assert not torch.equal(fresh.params(), tnet.params())


def test_init_pretrained_keeps_its_no_egress_error(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_PRETRAINED_DIR", raising=False)
    with pytest.raises(RuntimeError, match="no network egress"):
        ResNet50(**SHAPE).initPretrained()
    assert not ResNet50(**SHAPE).pretrainedAvailable()


def test_one_training_step_matches_jax_value_and_grad(nets):
    """The fused ResNet-50 at batch 8: the training loss (mcxent plus the
    zoo's L2), the new BN statistics and every leaf's gradient against
    `jax.value_and_grad` of the JAX net's `_loss` (its 36 pairs through
    the interpret-mode Pallas training kernels)."""
    jnet, tnet, _, _, _ = nets
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    vg = jax.jit(jax.value_and_grad(
        lambda p: jnet._loss(p, jnet._state, {"input": jnp.asarray(x)},
                             [jnp.asarray(y)], None, None, None),
        has_aux=True))
    (jloss, jstate), jgrads = vg(jnet._params)
    loss, grads, state = tnet._value_and_grad(
        {"input": torch.from_numpy(x)}, [torch.from_numpy(y)])
    _close(loss.numpy(), np.asarray(jloss), "loss")
    for name in jstate:
        for k in jstate[name]:
            _close(state[name][k].numpy(), np.asarray(jstate[name][k]),
                   f"state {name}/{k}")
    assert set(grads) == set(jgrads)
    for k in ("W", "b"):       # the head: no relu or BN between it and the loss
        want = np.asarray(jgrads["fc"][k])
        err = float(np.abs(grads["fc"][k].numpy() - want).max())
        assert err <= 1e-3 * float(np.abs(want).max()), ("fc", k, err)
    # Every other leaf's gradient passes through res5, whose BNs see 8 rows
    # at this size: a relu input within f32 noise of 0 there (one at
    # 1.3e-5 of a largest 9.5 in res5_2_add on a like fixture) takes a
    # different mask in either package, and the flipped element's gradient
    # reaches every leaf below it. So no two f32 implementations agree
    # element by element (the port's f32 is as far from its own f64), and
    # each leaf is held in L2: on this fixture the port and JAX differ by
    # 3.4 % (median) and 4.7 % (worst leaf); the bound is 10 %.
    for name in jgrads:
        for k in jgrads[name]:
            want = np.asarray(jgrads[name][k], np.float64)
            got = grads[name][k].numpy().astype(np.float64)
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 0.1, (name, k, rel)

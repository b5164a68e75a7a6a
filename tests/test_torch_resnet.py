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

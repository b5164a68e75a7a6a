"""Finite-difference gradient checks per layer type in the port (the
contracts of the JAX package's tests/test_gradients.py: ≡
deeplearning4j-core GradientCheckTests / GradientCheckUtil), the
training BatchNorm's closed-form backward against autograd of the
mean/var formulation, and each network's `computeGradients` against the
JAX package's on the same parameters (carried across by nn/convert.py)
to 1e-5."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import (BatchNormalization, DenseLayer,
                                         InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration, NoOp,
                                         OutputLayer,
                                         multilayer_params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.recurrent import LSTM, RnnOutputLayer

EPS = 1e-3
TOL = 2e-2  # relative tolerance on central differences (fp32)


def _leaves(tree):
    return [(n, k, tree[n][k]) for n in sorted(tree) for k in sorted(tree[n])]


def _check_gradients(net, x, y, n_probes=24, seed=0):
    """Analytic computeGradients against central finite differences at
    randomly probed parameter coordinates."""
    grads = net.computeGradients(x, y)
    flat = _leaves(net._params)
    rng = np.random.default_rng(seed)
    ds = DataSet(x, y)
    checked = 0
    for n, k, p in flat:
        g = grads[n][k]
        for _ in range(max(1, n_probes // len(flat))):
            idx = tuple(int(rng.integers(0, s)) for s in p.shape)
            orig = float(p[idx])
            with torch.no_grad():
                p[idx] = orig + EPS
                s_plus = net.score(ds)
                p[idx] = orig - EPS
                s_minus = net.score(ds)
                p[idx] = orig
            numeric = (s_plus - s_minus) / (2 * EPS)
            analytic = float(g[idx])
            if abs(numeric - analytic) < 2e-4:
                checked += 1
                continue
            denom = max(abs(numeric), abs(analytic), 1e-4)
            assert abs(numeric - analytic) / denom < TOL, (
                f"{n}/{k} {idx}: numeric {numeric} vs analytic {analytic}")
            checked += 1
    assert checked > 0


def _confs(pkg):
    """(name -> (configuration, x, y)) in the given package's classes."""
    if pkg == "jax":
        from deeplearning4j_tpu import nn as m
        from deeplearning4j_tpu.nn.conf.recurrent import LSTM as L
        from deeplearning4j_tpu.nn.conf.recurrent import RnnOutputLayer as R
    else:
        from deeplearning4j_tpu_torch import nn as m
        L, R = LSTM, RnnOutputLayer
    B = m.NeuralNetConfiguration.Builder
    rng = np.random.default_rng(1)
    out = {}
    out["dense_mcxent"] = (
        B().seed(0).updater(m.NoOp()).activation("tanh").list()
        .layer(m.DenseLayer.Builder().nOut(6).build())
        .layer(m.OutputLayer.Builder("mcxent").nOut(3)
               .activation("softmax").build())
        .setInputType(m.InputType.feedForward(4)).build(),
        rng.standard_normal((5, 4)).astype(np.float32),
        np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)])
    out["dense_l1l2"] = (
        B().seed(0).updater(m.NoOp()).activation("sigmoid").l1(0.01)
        .l2(0.02).list()
        .layer(m.DenseLayer.Builder().nOut(5).build())
        .layer(m.OutputLayer.Builder("mse").nOut(2)
               .activation("identity").build())
        .setInputType(m.InputType.feedForward(3)).build(),
        rng.standard_normal((4, 3)).astype(np.float32),
        rng.standard_normal((4, 2)).astype(np.float32))
    out["cnn"] = (
        B().seed(0).updater(m.NoOp()).activation("tanh").list()
        .layer(m.ConvolutionLayer.Builder(3, 3).nOut(4)
               .convolutionMode("same").build())
        .layer(m.SubsamplingLayer.Builder("max").kernelSize(2, 2)
               .stride(2, 2).build())
        .layer(m.OutputLayer.Builder("mcxent").nOut(2)
               .activation("softmax").build())
        .setInputType(m.InputType.convolutional(8, 8, 2)).build(),
        rng.standard_normal((3, 8, 8, 2)).astype(np.float32),
        np.eye(2, dtype=np.float32)[rng.integers(0, 2, 3)])
    y = np.zeros((2, 4, 2), np.float32)
    y[..., 0] = 1
    out["lstm"] = (
        B().seed(0).updater(m.NoOp()).list()
        .layer(L.Builder().nOut(5).build())
        .layer(R.Builder("mcxent").nOut(2).activation("softmax").build())
        .setInputType(m.InputType.recurrent(3)).build(),
        rng.standard_normal((2, 4, 3)).astype(np.float32), y)
    return out


@pytest.mark.parametrize("name,probes", [("dense_mcxent", 24),
                                         ("dense_l1l2", 24), ("cnn", 12),
                                         ("lstm", 12)])
def test_finite_difference_gradients(name, probes):
    conf, x, y = _confs("torch")[name]
    _check_gradients(MultiLayerNetwork(conf).init(device="cpu"), x, y,
                     n_probes=probes)


@pytest.mark.parametrize("name", ["dense_mcxent", "dense_l1l2", "cnn",
                                  "lstm"])
def test_compute_gradients_match_the_jax_package(name):
    import jax

    from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
    jconf, x, y = _confs("jax")[name]
    tconf, _, _ = _confs("torch")[name]
    jnet = JMLN(jconf).init()
    params = jax.tree_util.tree_map(np.asarray, jnet._params)
    state = jax.tree_util.tree_map(np.asarray, jnet._state)
    tnet = multilayer_params_from_numpy(MultiLayerNetwork(tconf), params,
                                        state, device="cpu")
    jg = jax.tree_util.tree_map(np.asarray, jnet.computeGradients(x, y))
    tg = tnet.computeGradients(x, y)
    from deeplearning4j_tpu_torch.nn.convert import jax_tree
    want = jax_tree(tnet, {n: {k: v.numpy() for k, v in d.items()}
                           for n, d in tg.items()})
    for (pj, a), (pt, b) in zip(
            sorted(jax.tree_util.tree_flatten_with_path(jg)[0],
                   key=lambda t: str(t[0])),
            sorted(jax.tree_util.tree_flatten_with_path(want)[0],
                   key=lambda t: str(t[0]))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                   err_msg=str(pj))


def test_batchnorm_gradients():
    """BN in train mode: batch statistics, checked against the same
    train forward (score uses the running statistics)."""
    conf = (NeuralNetConfiguration.Builder()
            .seed(0).updater(NoOp()).activation("tanh")
            .list()
            .layer(DenseLayer.Builder().nOut(5).build())
            .layer(BatchNormalization.Builder().build())
            .layer(OutputLayer.Builder("mse").nOut(2)
                   .activation("identity").build())
            .setInputType(InputType.feedForward(3))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((6, 3)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((6, 2)).astype(np.float32))

    def loss_of():
        with torch.no_grad():
            loss, _ = net._loss(net._params, net._state, {"input": x}, [y])
        return float(loss)

    _, grads, _ = net._value_and_grad({"input": x}, [y])
    probe = np.random.default_rng(0)
    for n, k, p in _leaves(net._params):
        idx = tuple(int(probe.integers(0, s)) for s in p.shape)
        orig = float(p[idx])
        with torch.no_grad():
            p[idx] = orig + EPS
        s_plus = loss_of()
        with torch.no_grad():
            p[idx] = orig - EPS
        s_minus = loss_of()
        with torch.no_grad():
            p[idx] = orig
        numeric = (s_plus - s_minus) / (2 * EPS)
        g = float(grads[n][k][idx])
        if abs(numeric - g) < 2e-4:
            continue
        assert abs(numeric - g) / max(abs(numeric), abs(g), 1e-4) < TOL


class TestFusedBatchNorm:
    """The training BatchNorm's closed-form backward must match autograd
    of the mean/var formulation; its running statistics and inference
    pass follow the reference's."""

    @staticmethod
    def _ref(x, g, b, eps=1e-5):
        axes = tuple(range(x.ndim - 1))
        mu = x.mean(dim=axes)
        var = x.var(dim=axes, correction=0)
        return (x - mu) * torch.rsqrt(var + eps) * g + b

    def test_forward_and_grads_match_autodiff(self):
        from deeplearning4j_tpu_torch.nn.conf.layers import _BNTrain
        gen = torch.Generator().manual_seed(3)
        x = torch.randn((8, 6, 6, 4), generator=gen) * 3 + 2
        g = torch.arange(1, 5, dtype=torch.float32) * 0.3
        b = torch.arange(4, dtype=torch.float32) * 0.2
        args = [t.clone().requires_grad_() for t in (x, g, b)]
        y = _BNTrain.apply(*args, 1e-5)[0]
        torch.testing.assert_close(y, self._ref(x, g, b), atol=2e-6,
                                   rtol=2e-6)
        gf = torch.autograd.grad(torch.tanh(y).sum(), args)
        ref_args = [t.clone().requires_grad_() for t in (x, g, b)]
        gr = torch.autograd.grad(torch.tanh(self._ref(*ref_args)).sum(),
                                 ref_args)
        for a, c in zip(gf, gr):
            torch.testing.assert_close(a, c, atol=5e-5, rtol=5e-5)

    def test_running_stats_and_inference_path(self):
        layer = BatchNormalization()
        layer.apply_defaults({})
        params, state, _ = layer.initialize(torch.Generator(),
                                            InputType.feedForward(4))
        x = torch.as_tensor(np.random.default_rng(0)
                            .standard_normal((32, 4)).astype(np.float32)
                            * 2 + 1)
        _, st = layer.apply(params, state, x, train=True)
        mu, var = x.numpy().mean(0), x.numpy().var(0)
        np.testing.assert_allclose(st["mean"].numpy(), 0.1 * mu, atol=1e-5)
        np.testing.assert_allclose(st["var"].numpy(), 0.9 + 0.1 * var,
                                   atol=1e-4)
        y, _ = layer.apply(params, st, x, train=False)
        r = 1.0 / np.sqrt(st["var"].numpy() + 1e-5)
        np.testing.assert_allclose(y.numpy(),
                                   (x.numpy() - st["mean"].numpy()) * r,
                                   atol=1e-4, rtol=1e-4)

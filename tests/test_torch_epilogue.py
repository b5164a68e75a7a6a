"""The port's epilogue GEMM (deeplearning4j_tpu_torch/kernels/pointwise_conv.py)
and the eval branch of its conv1x1+BN fusion (nn/fused.py) against the JAX
package on the CPU, where the port runs the kernel's plain version and JAX
runs its Pallas kernel in interpret mode. Inputs come from a numpy seed.

Tolerances: f32 1e-5 × max(1, max |JAX|) (sums in another order); int8
rtol 1e-5, atol 1e-4 (the int32 sums are exact, the f32 epilogue is not);
gradients 1e-5 × max(1, max |JAX|)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels import pointwise_conv as jpc
from deeplearning4j_tpu.nn import fused as jfused
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu_torch.kernels import pointwise_conv as tpc
from deeplearning4j_tpu_torch.nn import fused as tfused
from deeplearning4j_tpu_torch.nn.conf import layers as tl


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * 0.3).astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            (rng.standard_normal(n) * 0.1).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m,k,n", [(70, 12, 9), (300, 64, 32)])
def test_matmul_epilogue_matches_jax_kernel(m, k, n, with_res, act):
    """The ragged case of tests/test_quantize.py and a res-like one."""
    x, w, s, b, res = _operands(m, k, n, seed=m + k + n)
    r = res if with_res else None
    want = jpc.matmul_epilogue(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), jnp.asarray(b),
        residual=None if r is None else jnp.asarray(r), act=act,
        interpret=True)
    got = tpc.matmul_epilogue(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
        torch.from_numpy(b),
        residual=None if r is None else torch.from_numpy(r), act=act)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("with_res,act", [(False, "identity"),
                                          (True, "relu")])
def test_int8_matmul_epilogue_matches_jax_kernel(with_res, act):
    rng = np.random.default_rng(4)
    m, k, n = 70, 12, 9
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, n) * 1e-3).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32) if with_res \
        else None
    want = jpc.int8_matmul_epilogue(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(s), jnp.asarray(b),
        residual=None if res is None else jnp.asarray(res), act=act,
        interpret=True)
    got = tpc.int8_matmul_epilogue(
        torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(s),
        torch.from_numpy(b),
        residual=None if res is None else torch.from_numpy(res), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    # the accumulation itself is exact
    ones, zeros = torch.ones(n), torch.zeros(n)
    acc = tpc.int8_matmul_epilogue(torch.from_numpy(xq), torch.from_numpy(wq),
                                   ones, zeros)
    np.testing.assert_array_equal(
        acc.numpy(), xq.astype(np.int32) @ wq.astype(np.int32))


def test_epilogue_checks_match_the_jax_package():
    x = torch.zeros((4, 3))
    w = torch.zeros((3, 2))
    v = torch.zeros(2)
    with pytest.raises(ValueError, match="identity\\|relu"):
        tpc.matmul_epilogue(x, w, v, v, act="gelu")
    with pytest.raises(ValueError, match="identity\\|relu"):
        jpc.matmul_epilogue(jnp.zeros((4, 3)), jnp.zeros((3, 2)),
                            jnp.zeros(2), jnp.zeros(2), act="gelu",
                            interpret=True)
    with pytest.raises(TypeError, match="int8"):
        tpc.int8_matmul_epilogue(x, w, v, v)
    assert tpc.matmul_epilogue(x, w, v, v, out_dtype=torch.bfloat16).dtype \
        == torch.bfloat16


def _pair(stride, act, pkg):
    conv = pkg.ConvolutionLayer(kernelSize=(1, 1), stride=(stride, stride),
                                nIn=6, nOut=10, hasBias=False,
                                convolutionMode="same",
                                activation="identity")
    bn = pkg.BatchNormalization(nOut=10, activation=act)
    conv.apply_defaults({})
    bn.apply_defaults({})
    return conv, bn


def _fused_inputs():
    rng = np.random.default_rng(5)
    return dict(
        x=rng.standard_normal((2, 5, 5, 6)).astype(np.float32),
        W=(rng.standard_normal((1, 1, 6, 10)) * 0.4).astype(np.float32),
        gamma=rng.uniform(0.5, 1.5, 10).astype(np.float32),
        beta=(rng.standard_normal(10) * 0.1).astype(np.float32),
        mean=(rng.standard_normal(10) * 0.05).astype(np.float32),
        var=rng.uniform(0.5, 1.5, 10).astype(np.float32))


@pytest.mark.parametrize("stride,act", [(1, "relu"), (2, "identity")])
def test_fused_apply_eval_matches_jax_kernel_branch(stride, act):
    """Under jax.jit the JAX fused_apply takes its kernel branch (the
    folded BN and the relu in the epilogue of the Pallas GEMM); the port
    takes its epilogue kernel's plain version. z, the reported conv
    output and the state must agree."""
    d = _fused_inputs()
    jconv, jbn = _pair(stride, act, jl)
    tconv, tbn = _pair(stride, act, tl)
    sb = {"mean": jnp.asarray(d["mean"]), "var": jnp.asarray(d["var"])}

    @jax.jit
    def jrun(x, w, gamma, beta):
        z, _, y = jfused.fused_apply(jconv, jbn, {"W": w},
                                     {"gamma": gamma, "beta": beta}, sb, x,
                                     train=False)
        return z, y

    jz, jy = jrun(*(jnp.asarray(d[k]) for k in ("x", "W", "gamma", "beta")))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tz, ts, ty = tfused.fused_apply(
        tconv, tbn, {"W": t["W"]}, {"gamma": t["gamma"], "beta": t["beta"]},
        {"mean": t["mean"], "var": t["var"]}, t["x"], train=False,
        report_conv=True)
    _close(tz.numpy(), jz)
    _close(ty.numpy(), jy)
    assert ts["mean"] is t["mean"]
    # the conv output is computed only when asked for
    assert tfused.fused_apply(tconv, tbn, {"W": t["W"]},
                              {"gamma": t["gamma"], "beta": t["beta"]},
                              {"mean": t["mean"], "var": t["var"]}, t["x"],
                              train=False)[2] is None
    # train mode: batch statistics through fused_conv1x1_bn in both
    # packages (the JAX side's Pallas training kernels in interpret mode)
    jz, js, _ = jfused.fused_apply(
        jconv, jbn, {"W": jnp.asarray(d["W"])},
        {"gamma": jnp.asarray(d["gamma"]), "beta": jnp.asarray(d["beta"])},
        sb, jnp.asarray(d["x"]), train=True, interpret=True)
    tz, ts, _ = tfused.fused_apply(
        tconv, tbn, {"W": t["W"]}, {"gamma": t["gamma"], "beta": t["beta"]},
        {"mean": t["mean"], "var": t["var"]}, t["x"], train=True)
    _close(tz.numpy(), jz)
    for k in ("mean", "var"):
        _close(ts[k].numpy(), js[k])


@pytest.mark.parametrize("stride,act", [(1, "relu"), (2, "identity")])
def test_fused_apply_gradients_match_jax(stride, act):
    """Gradients through the port's autograd.Function against jax.grad
    through the JAX custom VJP, for x, W, γ and β (the pattern of
    tests/test_quantize.py::test_fused_conv_bn_eval_epilogue)."""
    d = _fused_inputs()
    jconv, jbn = _pair(stride, act, jl)
    tconv, tbn = _pair(stride, act, tl)
    sb = {"mean": jnp.asarray(d["mean"]), "var": jnp.asarray(d["var"])}

    def jsum(x, w, gamma, beta):
        z, _, _ = jfused.fused_apply(jconv, jbn, {"W": w},
                                     {"gamma": gamma, "beta": beta}, sb, x,
                                     train=False)
        return jnp.sum(z * jnp.cos(z))

    jg = jax.jit(jax.grad(jsum, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(d[k]) for k in ("x", "W", "gamma", "beta")))
    leaves = [torch.from_numpy(d[k]).requires_grad_()
              for k in ("x", "W", "gamma", "beta")]
    x, w, gamma, beta = leaves
    z, _, _ = tfused.fused_apply(
        tconv, tbn, {"W": w}, {"gamma": gamma, "beta": beta},
        {"mean": torch.from_numpy(d["mean"]),
         "var": torch.from_numpy(d["var"])}, x, train=False)
    (z * torch.cos(z)).sum().backward()
    for leaf, want in zip(leaves, jg):
        _close(leaf.grad.numpy(), want)
    # and against autograd through the unfused composition of the port
    x2, w2, g2, b2 = (torch.from_numpy(d[k]).requires_grad_()
                      for k in ("x", "W", "gamma", "beta"))
    yc, _ = tconv.apply({"W": w2}, {}, x2)
    zz, _ = tbn.apply({"gamma": g2, "beta": b2},
                      {"mean": torch.from_numpy(d["mean"]),
                       "var": torch.from_numpy(d["var"])}, yc)
    (zz * torch.cos(zz)).sum().backward()
    for leaf, ref in zip(leaves, (x2, w2, g2, b2)):
        _close(leaf.grad.numpy(), ref.grad.numpy())


def test_eval_epilogue_gradcheck_f64():
    """The closed-form backward against finite differences, in f64."""
    rng = np.random.default_rng(6)
    xf = torch.tensor(rng.standard_normal((7, 4)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((4, 3)), requires_grad=True)
    a = torch.tensor(rng.uniform(0.5, 1.5, 3), requires_grad=True)
    b = torch.tensor(rng.standard_normal(3), requires_grad=True)
    for act in ("identity", "relu"):
        assert torch.autograd.gradcheck(
            lambda *t: tfused._EvalEpilogue.apply(*t, act), (xf, w, a, b))

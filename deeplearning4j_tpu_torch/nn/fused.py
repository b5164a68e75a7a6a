"""Conv1x1 + BatchNorm fusion pass for ComputationGraph: the port of
`deeplearning4j_tpu/nn/fused.py`.

A 1×1 convolution that feeds only a BatchNormalization is executed with
the BN: at inference the BN's running statistics fold into a per-channel
affine (scale = γ·rsqrt(var+ε), shift = β − γ·μ·rsqrt(var+ε)), which
`kernels.pointwise_conv.matmul_epilogue` applies, with the BN's relu, in
the epilogue of the conv's GEMM — one hand-written kernel on the card, no
standalone BN pass. The rewrite is execution-only: node names, parameter
and state trees are unchanged; `find_conv1x1_bn_fusions` only names the
pairs, and `ComputationGraph` routes each marked pair through
`fused_apply`.

OFF by default, opt in with DL4J_TPU_FUSE_CONV_BN=1, read when a graph is
initialised (the same switch as the JAX package). On the card a marked
pair always launches the kernel; a build or launch failure raises.

Differences from the JAX module, by design:
- The JAX eager path ran one GEMM plus a BN pass, because nothing there
  removes the reporting-only conv output; its traced path ran the kernel
  and let XLA drop that output. Here every inference forward runs the
  kernel, and the conv output is computed only when the caller asks for
  it (`report_conv`, which `feedForward` sets).
- The train-mode fusion (`fused_conv1x1_bn`: batch statistics in the GEMM,
  BN's backward inside the conv-gradient GEMMs) comes with the training
  slice, ROADMAP B5, B7 and B8; `train=True` raises until then.
"""
from __future__ import annotations

import os

import torch

from deeplearning4j_tpu_torch.kernels.pointwise_conv import matmul_epilogue


class _EvalEpilogue(torch.autograd.Function):
    """act((xf @ w)·a + b) through `matmul_epilogue`, with the closed-form
    backward of the JAX `_eval_epilogue` custom VJP: the kernel has no
    derivative of its own, but eval-mode forwards still get
    differentiated (input saliency, adversarial probes). The backward
    recomputes the pre-affine product instead of storing it; gradients to
    γ and β flow through the fold arithmetic outside this function."""

    @staticmethod
    def forward(ctx, xf, w, a, b, act):
        z = matmul_epilogue(xf, w, a, b, act=act)
        ctx.save_for_backward(xf, w, a, z)
        ctx.act = act
        return z

    @staticmethod
    def backward(ctx, dz):
        xf, w, a, z = ctx.saved_tensors
        wide = torch.float64 if xf.dtype == torch.float64 else torch.float32
        dzf = dz.to(wide)
        if ctx.act == "relu":
            dzf = torch.where(z > 0, dzf, torch.zeros_like(dzf))
        dy = dzf * a.to(wide)                          # z = y·a + b
        wf, xw = w.to(wide), xf.to(wide)
        dx = (dy @ wf.T).to(xf.dtype)
        y = xw @ wf                                    # recompute, not stored
        dw = (xw.T @ dy).to(w.dtype)
        da = (dzf * y).sum(dim=0).to(a.dtype)
        db = dzf.sum(dim=0).to(a.dtype)
        return dx, dw, da, db, None


def fusion_enabled():
    env = os.environ.get("DL4J_TPU_FUSE_CONV_BN")
    if env is None:
        return False
    return env.strip().lower() in ("1", "true", "on", "yes")


def _eligible_conv(layer):
    from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
    if type(layer) is not ConvolutionLayer:
        return False
    # explicit nonzero padding would change the output shape of a 1x1
    # conv; the GEMM path only covers pad-free geometry ("same" for k=1
    # is also pad-free)
    pad_free = (str(layer.convolutionMode).lower() == "same"
                or tuple(layer.padding) == (0, 0))
    return (tuple(layer.kernelSize) == (1, 1)
            and tuple(layer.dilation) == (1, 1)
            and layer.stride[0] == layer.stride[1]
            and pad_free
            and not layer.hasBias
            and str(layer.activation).lower() in ("identity", "linear")
            and getattr(layer, "spaceToDepth", 1) == 1
            and not getattr(layer, "frozen", False)
            and not getattr(layer, "frozen_params", False)
            and getattr(layer, "weightNoise", None) is None
            and (layer.dropOut is None or layer.dropOut >= 1.0))


def _eligible_bn(layer):
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    return (type(layer) is BatchNormalization
            and str(layer.activation).lower() in ("identity", "linear",
                                                  "relu")
            and not layer.lockGammaBeta
            and not getattr(layer, "frozen", False)
            and (layer.dropOut is None or layer.dropOut >= 1.0))


def find_conv1x1_bn_fusions(conf):
    """Find eligible (conv1x1 -> batchnorm) node pairs in a built
    ComputationGraphConfiguration.

    Returns {bn_node_name: conv_node_name}. Pure query — the caller
    (ComputationGraph.init) keeps the mapping on the *network instance*,
    never on the shared conf, so two nets built from one conf can run
    fused and unfused independently."""
    nodes = conf.nodes
    consumers = conf.consumers()
    pairs = {}
    for name in conf.topo_order:
        conv = nodes[name]
        if conv.kind != "layer" or not _eligible_conv(conv.ref):
            continue
        outs = consumers.get(name, [])
        if len(outs) != 1 or name in conf.output_names:
            continue
        bn_name = outs[0]
        bn = nodes[bn_name]
        if (bn.kind != "layer" or not _eligible_bn(bn.ref)
                or bn.preprocessor is not None
                or bn_name in conf.output_names
                or len(bn.inputs) != 1):
            continue
        pairs[bn_name] = name
    return pairs


def fused_apply(conv_layer, bn_layer, p_conv, p_bn, s_bn, x, train,
                report_conv=False):
    """Execute act(batchnorm(conv1x1(x))) fused, in inference mode.
    x: (B, H, W, C) NHWC.

    Returns (z, bn_state, y_conv) with the semantics of running
    conv_layer.apply then bn_layer.apply; y_conv is the conv's own output
    when `report_conv` (feedForward reports the conv node's activation),
    else None — nothing computes it otherwise."""
    if train:
        raise NotImplementedError(
            "train-mode conv1x1+BN fusion (fused_conv1x1_bn: the kernels of "
            "kernel-table rows 5, 7 and 8) comes with the training slice, "
            "ROADMAP B5/B7/B8; run this graph with the fusion off "
            "(DL4J_TPU_FUSE_CONV_BN=0) to train")
    s = conv_layer.stride[0]
    if s > 1:
        # a 1x1 conv with stride s touches exactly the (::s, ::s) pixels;
        # the strided view is made contiguous once, for the GEMM
        x = x[:, ::s, ::s, :]
    x = x.contiguous()
    b, h, w_, cin = x.shape
    w = p_conv["W"].to(x.dtype).reshape(cin, -1)
    n = w.shape[1]
    xf = x.reshape(b * h * w_, cin)
    mean, var = s_bn["mean"], s_bn["var"]
    gamma, beta = bn_layer.gamma_beta(p_bn, mean)
    inv = torch.rsqrt(var + bn_layer.eps)
    act = str(bn_layer.activation).lower()
    act = "identity" if act in ("identity", "linear") else act
    z = _EvalEpilogue.apply(xf, w, gamma * inv, beta - gamma * mean * inv,
                            act)
    y = (xf @ w).reshape(b, h, w_, n) if report_conv else None
    return z.reshape(b, h, w_, n), s_bn, y

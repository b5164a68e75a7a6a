"""PrecisionPolicy — the layer-conf DSL's quantization knob: a copy of
`deeplearning4j_tpu/quantize/policy.py`, which has no jax in it, with its
imports re-pointed at the port.

One object describes BOTH halves of the int8 story:

- **training** (QAT): layers carrying a policy fake-quantize their
  weights (per-output-channel scales) and input activations (per-tensor
  scale) inside the normal fp forward — gradients flow through the
  straight-through estimator, so the trained weights land on (near) the
  int8 lattice and the post-training int8 rewrite loses almost nothing.
- **inference**: `quantize.infer.quantize_network` consults the same
  policy to decide which layers get the REAL int8 path (int8 weights,
  int8×int8 contraction, fused dequant+bias+activation epilogue).

Wired through the conf DSL like every other inherited hyperparameter:

    NeuralNetConfiguration.Builder()
        .precisionPolicy(PrecisionPolicy.int8())
        ...                       # every layer inherits the policy
    DenseLayer.Builder().precisionPolicy(None)   # per-layer opt-out

Output layers are excluded by default (`quantize_heads=False`) — the
classifier head's logits are the one place int8 resolution visibly moves
top-1 decisions.
"""
from __future__ import annotations

__all__ = ["PrecisionPolicy"]


class PrecisionPolicy:
    """Symmetric int8 precision policy.

    weights / activations: fake-quant the respective tensors during QAT
    (the real int8 inference path always quantizes both).
    quantize_heads: include output/loss-head layers.
    min_channels: skip layers narrower than this (tiny layers gain
    nothing and lose the most resolution)."""

    kind = "int8"

    def __init__(self, weights=True, activations=True,
                 quantize_heads=False, min_channels=1, enabled=True):
        self.weights = bool(weights)
        self.activations = bool(activations)
        self.quantize_heads = bool(quantize_heads)
        self.min_channels = int(min_channels)
        self.enabled = bool(enabled)

    @staticmethod
    def int8(**kw):
        return PrecisionPolicy(**kw)

    @staticmethod
    def off():
        """The per-layer OPT-OUT sentinel: a disabled policy that
        shadows an inherited one. `.precisionPolicy(None)` on a layer
        builder resolves to this (a literal None would read as "unset"
        and inherit the global policy right back)."""
        return PrecisionPolicy(enabled=False)

    # -- eligibility -------------------------------------------------------
    def _head(self, layer):
        return hasattr(layer, "compute_loss")

    def applies_to(self, layer):
        """QAT eligibility: any dense/conv layer with a weight matrix —
        fake-quant only SIMULATES int8, so every kernel size qualifies."""
        from deeplearning4j_tpu_torch.nn.conf.layers import (
            ConvolutionLayer, DenseLayer)
        if not self.enabled:
            return False
        if self._head(layer) and not self.quantize_heads:
            return False
        if not isinstance(layer, (DenseLayer, ConvolutionLayer)):
            return False
        n = getattr(layer, "nOut", None)
        if n is not None and int(n) < self.min_channels:
            return False
        return True

    def int8_servable(self, layer):
        """REAL int8 path eligibility: dense layers and pad-free
        1×1 convolutions — the shapes that are a single GEMM with a
        per-channel dequant epilogue. Everything else stays fp and is
        counted on dl4j.quant.dequant_fallbacks by the rewriter."""
        from deeplearning4j_tpu_torch.nn.conf.layers import (
            ConvolutionLayer, DenseLayer)
        if not self.applies_to(layer):
            return False
        if type(layer) is DenseLayer or (
                self.quantize_heads and isinstance(layer, DenseLayer)
                and self._head(layer)):
            return True
        if type(layer) is ConvolutionLayer:
            pad_free = (str(layer.convolutionMode).lower() == "same"
                        or tuple(layer.padding) == (0, 0))
            return (tuple(layer.kernelSize) == (1, 1)
                    and tuple(layer.dilation) == (1, 1)
                    and pad_free
                    and layer.stride[0] == layer.stride[1]
                    and getattr(layer, "spaceToDepth", 1) == 1)
        return False

    def __repr__(self):
        if not self.enabled:
            return "PrecisionPolicy(off)"
        return (f"PrecisionPolicy(int8, weights={self.weights}, "
                f"activations={self.activations}, "
                f"quantize_heads={self.quantize_heads})")

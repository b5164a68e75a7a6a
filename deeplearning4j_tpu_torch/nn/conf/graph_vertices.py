"""Graph vertices: the port of
`deeplearning4j_tpu/nn/conf/graph_vertices.py` (≡ deeplearning4j-nn ::
conf.graph.*): MergeVertex, ElementWiseVertex, SubsetVertex, StackVertex,
UnstackVertex, ScaleVertex, ShiftVertex, L2NormalizeVertex,
PreprocessorVertex, ReshapeVertex, SpaceToDepthVertex, L2Vertex and the
recurrent vertices LastTimeStepVertex, DuplicateToTimeSeriesVertex and
ReverseTimeSeriesVertex. Plain functions over one or more parent
activations and the feature mask (B, T) of the first parent that has one;
a vertex's `feed_forward_mask` is the mask its consumers see.
`AttentionVertex`, which has parameters, lives in `attention.py`;
FrozenVertex wraps any vertex and detaches its parameters (transfer
learning).
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (ConvolutionalType,
                                                     InputType,
                                                     RecurrentType)


class GraphVertex:
    def output_type(self, *input_types):
        raise NotImplementedError

    def apply(self, *xs, mask=None):
        raise NotImplementedError

    def feed_forward_mask(self, *parent_masks):
        """The mask downstream of this vertex (≡ feedForwardMaskArray): the
        first parent mask that is not None, unless the vertex drops or
        re-keys the time axis."""
        return next((m for m in parent_masks if m is not None), None)


class MergeVertex(GraphVertex):
    """Concat along the feature (last) axis."""

    def output_type(self, *ts):
        t0 = ts[0]
        if isinstance(t0, ConvolutionalType):
            return InputType.convolutional(t0.height, t0.width,
                                           sum(t.channels for t in ts))
        if isinstance(t0, RecurrentType):
            return InputType.recurrent(sum(t.size for t in ts),
                                       t0.timeSeriesLength)
        return InputType.feedForward(sum(t.size for t in ts))

    def apply(self, *xs, mask=None):
        return torch.cat(xs, dim=-1)


class ElementWiseVertex(GraphVertex):
    Add, Subtract, Product, Average, Max, Min = (
        "add", "subtract", "product", "average", "max", "min")

    def __init__(self, op="add"):
        self.op = str(op).lower()

    def output_type(self, *ts):
        return ts[0]

    def apply(self, *xs, mask=None):
        if self.op == "add":
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        if self.op == "subtract":
            if len(xs) != 2:
                raise ValueError("ElementWiseVertex subtract takes two "
                                 f"inputs, got {len(xs)}")
            return xs[0] - xs[1]
        if self.op == "product":
            out = xs[0]
            for x in xs[1:]:
                out = out * x
            return out
        if self.op == "average":
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out / len(xs)
        if self.op == "max":
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        if self.op == "min":
            out = xs[0]
            for x in xs[1:]:
                out = torch.minimum(out, x)
            return out
        raise ValueError(f"Unknown ElementWiseVertex op {self.op}")


class SubsetVertex(GraphVertex):
    """Features frm..to of the last axis, both ends inclusive."""

    def __init__(self, frm, to):
        self.frm, self.to = int(frm), int(to)

    def output_type(self, *ts):
        n = self.to - self.frm + 1
        t = ts[0]
        if isinstance(t, RecurrentType):
            return InputType.recurrent(n, t.timeSeriesLength)
        return InputType.feedForward(n)

    def apply(self, *xs, mask=None):
        return xs[0][..., self.frm:self.to + 1]


class StackVertex(GraphVertex):
    """The parents' examples stacked along the batch axis."""

    def output_type(self, *ts):
        return ts[0]

    def apply(self, *xs, mask=None):
        return torch.cat(xs, dim=0)


class UnstackVertex(GraphVertex):
    """Block `frm` of `stackSize` equal blocks of the batch axis."""

    def __init__(self, frm, stackSize):
        self.frm, self.stackSize = int(frm), int(stackSize)

    def output_type(self, *ts):
        return ts[0]

    def apply(self, *xs, mask=None):
        x = xs[0]
        step = x.shape[0] // self.stackSize
        return x[self.frm * step:(self.frm + 1) * step]


class ScaleVertex(GraphVertex):
    def __init__(self, scaleFactor):
        self.scale = float(scaleFactor)

    def output_type(self, *ts):
        return ts[0]

    def apply(self, *xs, mask=None):
        return xs[0] * self.scale


class ShiftVertex(GraphVertex):
    def __init__(self, shiftFactor):
        self.shift = float(shiftFactor)

    def output_type(self, *ts):
        return ts[0]

    def apply(self, *xs, mask=None):
        return xs[0] + self.shift


class L2NormalizeVertex(GraphVertex):
    """x / sqrt(Σx² + eps) over the last axis (eps inside the root)."""

    def __init__(self, eps=1e-8):
        self.eps = float(eps)

    def output_type(self, *ts):
        return ts[0]

    def apply(self, *xs, mask=None):
        x = xs[0]
        return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True) + self.eps)


class PreprocessorVertex(GraphVertex):
    """An InputPreProcessor as a vertex."""

    def __init__(self, preprocessor):
        self.pp = preprocessor

    def output_type(self, *ts):
        return self.pp.getOutputType(ts[0])

    def apply(self, *xs, mask=None):
        return self.pp.preProcess(xs[0])


class ReshapeVertex(GraphVertex):
    """The parent reshaped to `shape` (batch axis included, -1 allowed):
    a 2-D shape gives a feed-forward type, a 4-D one a convolutional
    (H, W, C) type."""

    def __init__(self, *shape):
        self.shape = tuple(int(s) for s in
                           (shape[0] if len(shape) == 1 and
                            isinstance(shape[0], (tuple, list)) else shape))

    def output_type(self, *ts):
        if len(self.shape) == 2:
            return InputType.feedForward(self.shape[-1])
        if len(self.shape) == 4:
            return InputType.convolutional(*self.shape[1:])
        return ts[0]

    def apply(self, *xs, mask=None):
        return xs[0].reshape(self.shape)


class SpaceToDepthVertex(GraphVertex):
    """≡ conf.layers.SpaceToDepthLayer as a vertex (YOLOv2's 'reorg'
    passthrough): (B, H, W, C) → (B, H/b, W/b, C·b²), each b×b block's
    pixels in (row, column) order, then the channels."""

    def __init__(self, blockSize=2):
        self.blockSize = int(blockSize)

    def output_type(self, *ts):
        t = ts[0]
        b = self.blockSize
        return InputType.convolutional(t.height // b, t.width // b,
                                       t.channels * b * b)

    def apply(self, *xs, mask=None):
        x = xs[0]
        n, h, w, c = x.shape
        b = self.blockSize
        x = x.reshape(n, h // b, b, w // b, b, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b,
                                                   c * b * b)


class L2Vertex(GraphVertex):
    """≡ conf.graph.L2Vertex: the Euclidean distance between two parents,
    (B, ...) × (B, ...) → (B, 1), summed in f32 (the siamese head)."""

    def __init__(self, eps=1e-8):
        self.eps = float(eps)

    def output_type(self, *ts):
        return InputType.feedForward(1)

    def feed_forward_mask(self, *parent_masks):
        return None  # one distance an example, no time axis

    def apply(self, *xs, mask=None):
        a, b = xs[0], xs[1]
        d = (a - b).reshape(a.shape[0], -1)
        wide = torch.float64 if d.dtype == torch.float64 else torch.float32
        sq = (d.to(wide) ** 2).sum(dim=1, keepdim=True)
        return torch.sqrt(sq + self.eps).to(a.dtype)


class LastTimeStepVertex(GraphVertex):
    """≡ rnn.LastTimeStepVertex — (B, T, F) → (B, F): each example's last
    valid step under the mask."""

    def __init__(self, maskArrayInputName=None):
        self.maskName = maskArrayInputName

    def feed_forward_mask(self, *parent_masks):
        return None  # one (feed-forward) step

    def output_type(self, *ts):
        return InputType.feedForward(ts[0].size)

    def apply(self, *xs, mask=None):
        x = xs[0]
        if mask is None:
            return x[:, -1, :]
        idx = ((mask > 0).sum(dim=1) - 1).clamp_min(0)
        return x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


class DuplicateToTimeSeriesVertex(GraphVertex):
    """≡ rnn.DuplicateToTimeSeriesVertex — a (B, F) activation repeated
    over the time axis of the second parent (B, T, F'): (B, T, F)."""

    def __init__(self, referenceInputName=None):
        self.referenceInputName = referenceInputName

    def output_type(self, *ts):
        ff, seq = ts[0], ts[1]
        return InputType.recurrent(ff.size,
                                   getattr(seq, "timeSeriesLength", None))

    def feed_forward_mask(self, *parent_masks):
        # the time axis is the second (reference) parent's
        return parent_masks[1] if len(parent_masks) > 1 else None

    def apply(self, *xs, mask=None):
        ff, seq = xs[0], xs[1]
        return ff[:, None, :].expand(ff.shape[0], seq.shape[1], ff.shape[1])


class ReverseTimeSeriesVertex(GraphVertex):
    """≡ rnn.ReverseTimeSeriesVertex — the time axis reversed; under a mask
    each example reverses within its own length L (out[t] = x[L-1-t] for
    t < L, zeros after)."""

    def __init__(self, maskArrayInputName=None):
        self.maskName = maskArrayInputName

    def output_type(self, *ts):
        return ts[0]

    def apply(self, *xs, mask=None):
        x = xs[0]
        t = x.shape[1]
        if mask is None:
            return torch.flip(x, dims=(1,))
        lengths = (mask > 0).sum(dim=1)                          # (B,)
        pos = torch.arange(t, device=x.device)[None, :]          # (1, T)
        src = (lengths[:, None] - 1 - pos).clamp(0, t - 1)       # (B, T)
        y = x.gather(1, src[:, :, None].expand(-1, -1, x.shape[-1]))
        return torch.where((pos < lengths[:, None])[:, :, None], y, 0)


class FrozenVertex(GraphVertex):
    """≡ conf.graph.FrozenVertex — wraps any vertex and blocks gradient
    flow into its parameters (they are detached in the forward), while
    activations still differentiate through to the layers upstream."""

    def __init__(self, vertex=None):
        if vertex is None:
            raise ValueError("FrozenVertex requires a wrapped vertex")
        self.inner = vertex

    def output_type(self, *ts):
        return self.inner.output_type(*ts)

    # the parameterized-vertex protocol, only when the inner vertex has it
    def __getattr__(self, name):
        if name == "initialize" and hasattr(self.inner, "initialize"):
            return self.inner.initialize
        raise AttributeError(name)

    def apply(self, *xs, params=None, mask=None):
        if hasattr(self.inner, "initialize"):
            frozen = {k: v.detach() for k, v in (params or {}).items()}
            return self.inner.apply(*xs, params=frozen, mask=mask)
        return self.inner.apply(*xs, mask=mask)

    def feed_forward_mask(self, *parent_masks):
        return self.inner.feed_forward_mask(*parent_masks)

"""Graph vertices: the port of `GraphVertex`, `MergeVertex` and
`ElementWiseVertex` of `deeplearning4j_tpu/nn/conf/graph_vertices.py`
(≡ deeplearning4j-nn :: conf.graph.*). Plain functions over one or more
parent activations. The other vertices come with ROADMAP A12.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (ConvolutionalType,
                                                     InputType,
                                                     RecurrentType)


class GraphVertex:
    def output_type(self, *input_types):
        raise NotImplementedError

    def apply(self, *xs):
        raise NotImplementedError


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

    def apply(self, *xs):
        return torch.cat(xs, dim=-1)


class ElementWiseVertex(GraphVertex):
    Add, Subtract, Product, Average, Max, Min = (
        "add", "subtract", "product", "average", "max", "min")

    def __init__(self, op="add"):
        self.op = str(op).lower()

    def output_type(self, *ts):
        return ts[0]

    def apply(self, *xs):
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

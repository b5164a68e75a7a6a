"""Pipeline parallelism over the `pp` mesh axis (GPipe microbatching): the
port of `deeplearning4j_tpu/parallel/pipeline.py`.

The layer stack is split into S = |pp| equal stages; stage s's parameters
are the s-th slice of a stacked tree (leading stage dim over pp). The
microbatches stream through the GPipe schedule: S + M − 1 ticks, and each
tick every stage runs its chunk of layers on what it holds and hands the
result one stage on (`mesh.ppermute`). The last stage's outputs are
broadcast with a psum. Gradients flow back through the reverse hops
(ppermute's adjoint), so `loss.backward()` through the pipeline is the
backward schedule.

Usage: stage_fn(stage_params, x) -> y applies ONE stage's chunk of
layers; all stages share one stage_fn and parameter structure.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.mesh import P, shard_map

__all__ = ["stack_stage_params", "make_pipeline_fn", "make_pipelined_loss"]


def _tree_map(fn, *trees):
    return _mesh._tree_map(fn, *trees)


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    dim."""
    return _tree_map(lambda *xs: torch.stack(
        [torch.as_tensor(x) for x in xs]), *per_stage_params)


def make_pipeline_fn(stage_fn, mesh, n_microbatches, axis_name="pp"):
    """f(stacked_stage_params, x) -> y running the GPipe schedule.

    x: (B, ...) the global batch, split into n_microbatches along dim 0;
    stacked_stage_params: leading dim = the number of stages, one per
    rank of `axis_name`."""

    def pipeline(stage_params, x):
        params = _tree_map(lambda a: a[0], stage_params)
        n_stages = _mesh.psum(1, axis_name)
        stage = _mesh.axis_index(axis_name)
        mb = x.reshape((n_microbatches, -1) + tuple(x.shape[1:]))
        n_ticks = n_microbatches + n_stages - 1
        state = torch.zeros_like(mb[0])
        outputs = [torch.zeros_like(mb[0]) for _ in range(n_microbatches)]
        for t in range(n_ticks):
            # stage 0 ingests microbatch t (while t < M); the others take
            # what the previous stage handed on. Stage 0 adds the hop it
            # received times 0, so every rank's hop stays on the autograd
            # graph and every rank runs each hop's backward (a collective)
            if stage == 0:
                inp = mb[min(t, n_microbatches - 1)]
                if t > 0 and state.requires_grad:
                    inp = inp + 0.0 * state
            else:
                inp = state
            out = stage_fn(params, inp)
            # the last stage emits microbatch t - (S - 1) once valid
            if stage == n_stages - 1 and t >= n_stages - 1:
                outputs[t - (n_stages - 1)] = out
            state = _mesh.ppermute(out, axis_name)
        outputs = torch.stack(outputs)
        # only the last stage holds real outputs: broadcast them. The other
        # stages add zeros that stay on the autograd graph, so every rank
        # runs the psum's backward (a collective) with the others
        if stage != n_stages - 1:
            outputs = outputs + 0.0 * out.sum()
        outputs = _mesh.psum(outputs, axis_name)
        return outputs.reshape((-1,) + tuple(x.shape[1:]))

    def wrapped(stacked_params, x):
        in_specs = (_tree_map(lambda _: P(axis_name), stacked_params), P())
        return shard_map(pipeline, mesh=mesh, in_specs=in_specs,
                         out_specs=P(), check_vma=False)(stacked_params, x)

    return wrapped


def make_pipelined_loss(stage_fn, loss_head, mesh, n_microbatches,
                        axis_name="pp"):
    """loss(stacked_params, head_params, x, y) with the pipeline inside,
    differentiable end to end (gradients flow back through the reverse
    hops)."""
    pipe = make_pipeline_fn(stage_fn, mesh, n_microbatches, axis_name)

    def loss(stacked_params, head_params, x, y):
        return loss_head(head_params, pipe(stacked_params, x), y)

    return loss

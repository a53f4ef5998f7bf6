"""GPipe-style pipeline parallelism over ranks (port of
`repro.train.pipeline`).

A `stage` mesh axis splits the layer stack: rank s of the axis applies
stage s's layers, and a microbatched forward streams through the stages
with hand-offs from stage s to s + 1 (the bubble is (S−1)/(M+S−1)).  The
schedule is the reference's: T = M + S − 1 ticks; at tick t stage 0
injects microbatch min(t, M − 1), every stage applies its layers to what
it holds, the last stage keeps its output as microbatch t − (S − 1) once
that is ≥ 0, and every stage hands its output on.  At the end the last
stage's outputs are summed over the axis, masked, so every stage returns
them.  It is differentiable end to end, as the reference's is under
`jax.grad`: the hand-off and the final sum are `torch.autograd.Function`s
built on `all_reduce`, whose backward passes carry the gradients back
along the same links (the hand-off's backward goes from stage s + 1 to
s; the final sum's backward takes the mean of the ranks' cotangents,
which is each rank's own when, as here, every rank computes the same
loss from the replicated output).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..checkpoint.checkpointer import tree_flatten
from ..sharding import ranks
from ..sharding.axes import STAGE_AXIS


def _shift(y: torch.Tensor, sid: int, n: int, group,
           step: int) -> torch.Tensor:
    """What stage `sid` receives when every stage sends its `y` to stage
    sid + step (zeros where no stage sends): a [n, …] buffer, each
    sender's `y` in its receiver's row, summed over the group."""
    buf = torch.zeros((n,) + y.shape, dtype=y.dtype, device=y.device)
    if 0 <= sid + step < n:
        buf[sid + step] = y
    return ranks.all_sum_(buf, group)[sid]


class _HandOff(torch.autograd.Function):
    """Stage s's output to stage s + 1 (the reference's `ppermute`); the
    gradient flows back from s + 1 to s."""

    @staticmethod
    def forward(ctx, y, sid, n, group):
        ctx.sid, ctx.n, ctx.group = sid, n, group
        return _shift(y, sid, n, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.sid, ctx.n, ctx.group, -1), \
            None, None, None


class _Replicate(torch.autograd.Function):
    """Sum over the stages (the reference's final `psum`), whose result
    every stage holds; the backward takes the mean of the stages'
    cotangents."""

    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        return ranks.all_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        g = ranks.all_sum_(g.clone(), ctx.group)
        return g / torch.full((), ctx.n, dtype=g.dtype, device=g.device), \
            None, None


def pipeline(fn_stage: Callable, mesh, stage_axis: str = STAGE_AXIS,
             n_microbatches: int = 4):
    """Build a pipelined apply: y = pipe(stage_params, x).

    fn_stage(params_stage, x_mb) → y_mb applies ONE stage's layers to one
    microbatch (x_mb and y_mb of one shape and type).  `stage_params`:
    a tree whose leaves are stacked [n_stages, …] (this rank takes its
    stage's entry) or DTensors sharded over the stage axis on dimension 0
    (this rank's [1, …] block); x: [B, …], the same on every stage, B
    divisible by `n_microbatches`.  Every rank of the stage axis calls
    it."""
    group = mesh.get_group(stage_axis)
    n_stages = mesh.size(list(mesh.mesh_dim_names).index(stage_axis))
    sid = mesh.get_local_rank(stage_axis)
    M = n_microbatches

    def own(a):
        return a.to_local()[0] if ranks.sharding_of(a) is not None else \
            a[sid]

    def apply(stage_params, x):
        leaves, treedef = tree_flatten(stage_params)
        params = treedef.unflatten([own(a) for a in leaves])
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             "microbatches")
        mb = x.reshape((M, B // M) + x.shape[1:])
        # the stages branch on tensors, never in Python, so that every
        # rank builds the same graph and its backward runs the same
        # collectives in the same order
        first = torch.tensor(sid == 0, device=x.device)
        last = torch.tensor(sid == n_stages - 1, device=x.device)
        buf = torch.zeros_like(mb[0])
        outs = [torch.zeros_like(mb[0]) for _ in range(M)]
        for t in range(M + n_stages - 1):
            x_in = torch.where(first, mb[min(t, M - 1)].to(buf.dtype), buf)
            y = fn_stage(params, x_in)
            out_idx = t - (n_stages - 1)
            if out_idx >= 0:
                outs[out_idx] = torch.where(last, y, outs[out_idx])
            buf = _HandOff.apply(y, sid, n_stages, group)
        outs = torch.where(last, torch.stack(outs), 0.0)
        return _Replicate.apply(outs, n_stages, group).reshape(x.shape)

    return apply


def split_stages(stacked_params, n_stages: int):
    """Reshape layer-stacked parameters [L, …] into
    [n_stages, L / n_stages, …] for the pipeline's stages."""
    leaves, treedef = tree_flatten(stacked_params)
    return treedef.unflatten([
        a.reshape((n_stages, a.shape[0] // n_stages) + tuple(a.shape[1:]))
        for a in leaves])

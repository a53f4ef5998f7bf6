"""Error-feedback int8 gradient compression (port of
`repro.optim.compression`).

`ef_compress_grads` is a pure tree transform (quantize → dequantize with
the residual carried): g' = Q(g + r), r ← (g + r) − g'.  It composes with
any optimizer; a `make_train_step(compressor=...)` callable applies it
between the gradients and `adamw.update`.  `torch.round` rounds half to
even, as `jnp.round` does.  `compressed_psum` is the reference's int8
all-reduce over a mesh axis, over a process group of ranks
(`sharding.ranks`): a shared scale from the maximum of every rank's
largest magnitude, then an integer sum, so the result is the same bits
on every rank.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..checkpoint.checkpointer import tree_flatten
from ..sharding import ranks
from .adamw import f32


def _quantize(x, bits: int = 8):
    x = x.to(torch.float32)
    amax = torch.max(torch.abs(x)) + 1e-12
    qmax = 2.0 ** (bits - 1) - 1
    scale = amax / f32(qmax, amax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale


def ef_init(params) -> Any:
    """Residual (error-feedback) state, one float32 zero tensor per
    parameter."""
    leaves, treedef = tree_flatten(params)
    return treedef.unflatten([torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device) for p in leaves])


def ef_compress_grads(grads, residual) -> Tuple[Any, Any]:
    """Returns (compressed-domain grads, new residual)."""
    def one(g, r):
        x = g.to(torch.float32) + r
        q, scale = _quantize(x)
        deq = _dequantize(q, scale)
        return deq, x - deq
    flat_g, treedef = tree_flatten(grads)
    flat_r, _ = tree_flatten(residual)
    outs = [one(g, r) for g, r in zip(flat_g, flat_r)]
    return (treedef.unflatten([o[0] for o in outs]),
            treedef.unflatten([o[1] for o in outs]))


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 quantize → sum over the ranks of `group` → dequantize: every
    rank quantizes against the shared scale (the largest |x| of any rank,
    + 1e-12, / 127), the int32 codes are summed, and the sum times the
    scale is returned, float32, on every rank.  The reference's
    operations in its order (`jax.lax.pmax`, `psum` inside `shard_map`)."""
    x = x.to(torch.float32)
    qmax = 127.0
    amax = ranks.all_max_(torch.max(torch.abs(x)).reshape(1), group)[0]
    amax = amax + 1e-12
    scale = amax / f32(qmax, amax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    return ranks.all_sum_(q, group).to(torch.float32) * scale

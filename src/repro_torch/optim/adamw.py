"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
`repro.optim.adamw`).

The optimizer moments mirror the parameter tree and are float32 whatever
the parameters' type; the update is applied in the parameter's type
through float32, with no separate float32 master copy.  `AdamWState`
keeps the reference's name and field order, so a checkpoint of
`(params, AdamWState)` written by either package restores in the other.

`update` works in place, under `torch.no_grad()`: it writes the new
parameters and moments into the given tensors (what the reference's
`jax.jit(..., donate_argnums=(0, 1))` lets XLA do) and returns them, so
a step holds one copy of the state plus one leaf's float32 temporaries.
A caller that needs the old values keeps a copy.  The leaves are walked
in `jax.tree.flatten`'s order (dict keys sorted).  The schedule, the
bias corrections and the clip factor are float32 tensors on the
parameters' device, as the reference's `astype(jnp.float32)` makes them;
every division by a constant divides by a float32 tensor (`f32`), since
CUDA turns a division by a Python number into a product with its
reciprocal, which rounds differently.

ZeRO-1: `init(params, shardings)` gives moments that are DTensors, each
holding only this rank's block (`sharding.axes.NamedSharding`, e.g.
`tree_shardings_matched` under `opt_rules`).  `update` then runs each
such leaf's arithmetic on that block of the parameter and the gradient,
with the clip factor and `grad_norm` of the whole gradients, and gathers
the updated blocks back into every rank's parameter
(`ranks.gather_full`, bitwise).  The update is elementwise, so each
block is bitwise the one-process update of the same elements.

Under tensor parallelism or FSDP the parameters are DTensors of each
rank's block (`Model.init(..., shardings=)`) and the gradients plain
tensors of the same blocks.  A moment's block then lies inside its
parameter's (its spec shards each dimension over the parameter's axes
and then more, major first): `update` works on that part of the local
block and gathers over the moment's further axes only.  `global_norm`
sums the squares of every element once over the mesh: each leaf's local
sum, all-reduced over the axes that shard it (`_sharded_sum_squares`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..checkpoint.checkpointer import tree_flatten
from ..sharding import axes as ax
from ..sharding import ranks


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: dict
    nu: dict


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a float32 scalar tensor on `like`'s device."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def init(params, shardings=None) -> AdamWState:
    """Zero moments, full, or with `shardings` (a tree of `NamedSharding`
    matching `params`) DTensors of this rank's blocks (ZeRO-1)."""
    leaves, treedef = tree_flatten(params)
    if shardings is not None:
        shardings, _ = tree_flatten(shardings)

    def zero(i, p):
        if shardings is None:
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        sl = shardings[i].block(p.shape)
        shape = ((0,) if sl is None else
                 tuple(len(range(*s.indices(n))) for s, n in zip(sl, p.shape)))
        local = torch.zeros(shape, dtype=torch.float32, device=p.device)
        return shardings[i].distribute(local, p.shape)

    def zeros():
        return treedef.unflatten([zero(i, p) for i, p in enumerate(leaves)])
    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return AdamWState(step, zeros(), zeros())


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an integer tensor), float32."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / f32(max(cfg.warmup_steps, 1), step), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
                       0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree, shardings=None) -> torch.Tensor:
    """The 2-norm of every element of `tree`; with `shardings` (a list of
    `NamedSharding` or None, one per leaf) the leaves are those blocks and
    each element counts once over the mesh."""
    leaves, _ = tree_flatten(tree)
    squares = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
    if shardings is None:
        return torch.sqrt(torch.sum(torch.stack(squares)))
    return torch.sqrt(_sharded_sum_squares(squares, shardings))


def _sharded_sum_squares(squares, shardings) -> torch.Tensor:
    """Σ of the leaves' local sums of squares, those of leaves sharded
    over the same mesh axes summed first and all-reduced over them, in
    the order of the axes sets (every rank the same)."""
    by_axes = {}
    mesh = None
    for sq, s in zip(squares, shardings):
        names = () if s is None else tuple(
            a for e in s.spec for a in ax._names(e))
        if s is not None:
            mesh = s.mesh
        by_axes.setdefault(tuple(sorted(names)), []).append(sq)
    total = None
    for names in sorted(by_axes):
        part = torch.sum(torch.stack(by_axes[names]))
        if names:
            group, n = ranks.axis_group(mesh, names)
            if n > 1:
                part = ranks.all_sum_(part.clone(), group)
        total = part if total is None else total + part
    return total


def _within(moment: ax.NamedSharding, param) -> ax.NamedSharding:
    """The moment's sharding relative to the parameter's local block:
    per dimension the moment's axes after the parameter's, which must
    come first (axes of size 1 aside)."""
    p_spec = () if param is None else tuple(param.spec)
    sizes = ax.axis_sizes(moment.mesh)

    def wide(entry):
        return tuple(a for a in ax._names(entry) if sizes[a] > 1)
    out = []
    for d, entry in enumerate(moment.spec):
        m_names = wide(entry)
        p_names = wide(p_spec[d]) if d < len(p_spec) else ()
        if m_names[:len(p_names)] != p_names:
            raise ValueError(f"the moment's spec {moment.spec} does not "
                             f"refine the parameter's {p_spec}")
        rest = m_names[len(p_names):]
        out.append(rest if len(rest) > 1 else (rest[0] if rest else None))
    for d in range(len(moment.spec), len(p_spec)):
        if wide(p_spec[d]):
            raise ValueError(f"the moment's spec {moment.spec} does not "
                             f"refine the parameter's {p_spec}")
    return ax.NamedSharding(moment.mesh, ax.P(*out))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step, in place (see the module docstring).  Returns
    (params, AdamWState(step + 1, mu, nu), {"grad_norm", "lr"})."""
    flat_p, _ = tree_flatten(params)
    p_shardings = [ranks.sharding_of(p) for p in flat_p]
    gnorm = global_norm(grads, p_shardings if any(
        s is not None for s in p_shardings) else None)
    scale = torch.clamp_max(f32(cfg.clip_norm, gnorm) /
                            torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state.mu)
    flat_v, _ = tree_flatten(state.nu)
    for g, m, v, p, s_p in zip(flat_g, flat_m, flat_v, flat_p, p_shardings):
        if s_p is not None:
            p = p.to_local()
        sharding = ranks.sharding_of(m)
        if sharding is not None:
            sharding = _within(sharding, s_p)
            sl = sharding.block(p.shape)
            g, m, v, p_full, p = g[sl], m.to_local(), v.to_local(), p, p[sl]
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        p32 = p.to(torch.float32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + \
            cfg.weight_decay * p32
        if sharding is None:
            p.copy_(p32 - lr * delta)
        else:
            p_full.copy_(ranks.gather_full((p32 - lr * delta).to(p.dtype),
                                           sharding, p_full.shape))
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}

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
such leaf's arithmetic on that block of the parameter and the gradient
(which are full, and equal on every rank), with the clip factor and
`grad_norm` of the full gradients, and gathers the updated blocks back
into every rank's parameter (`ranks.gather_full`, bitwise).  The update
is elementwise, so each block is bitwise the one-process update of the
same elements.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..checkpoint.checkpointer import tree_flatten
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
        local = torch.zeros(p[sl].shape if sl is not None else (0,),
                            dtype=torch.float32, device=p.device)
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


def global_norm(tree) -> torch.Tensor:
    leaves, _ = tree_flatten(tree)
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32))) for g in leaves])))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step, in place (see the module docstring).  Returns
    (params, AdamWState(step + 1, mu, nu), {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(f32(cfg.clip_norm, gnorm) /
                            torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    flat_p, _ = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state.mu)
    flat_v, _ = tree_flatten(state.nu)
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        sharding = ranks.sharding_of(m)
        if sharding is not None:
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

"""Mixture-of-Experts FFN with top-k routing (port of `repro.models.moe`).

Router: softmax over the experts, top-k, renormalised, with the
Switch-style load-balancing loss beside it.  Under `use_flash_kernel` the
gates and ids come from the fused gating op (`kernels.moe_gating`, the
router's kernel in the reference; its plain version on the CPU or under
`Model(interpret=True)`); flag off, from the plain version directly.
Both give `lax.top_k`'s ids (descending, ties to the lowest index).

Dispatch: the reference's capacity-bucketed one-hot einsums over
sequence-aligned groups of `group_size` tokens, line for line; the
slot arithmetic (the cumulative count of each expert's choices, − 1, the
`keep` mask) runs in `x.dtype`, as in the reference.  In bfloat16 the
count is not integer arithmetic: past 256 its partial sums round, so two
choices can share a slot.  Which partial sums round depends on how the
cumulative sum is taken.  Where no count that decides a kept slot can
pass the type's exact range (`expert_counts`; the served widths, where C
is 160 or 1) every order gives the same slots and one `torch.cumsum`
does; elsewhere `scan_sum` takes it the way XLA runs the reference's
`jnp.cumsum` on the CPU, so the slots are the reference's (ROADMAP.md,
"Reference semantics the port keeps").  The load-balance loss's means
are over the whole batch under a mesh that splits it
(`ranks.batch_mean`).

Expert parallelism, under a tensor-parallel axis (`sharding.tp`): the
router's weight is ("embed", "expert"), so its block gives this rank's
experts' logits, which are all-gathered before the softmax and top-k:
every rank ranks all E experts and computes the same gates, ids and
slots as one device.  Each rank then dispatches to, runs and combines
only its range of experts (their `mlp` dimension whole: `spec_for`
uses "model" once); the combine's partial sums go back to the
residual's block through the caller's reduce-scatter.  The load-balance
loss sums its per-expert terms by range and all-reduces them, so that
each rank's gradient is its experts' part (the `sharding.tp`
convention).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.moe_gating.ops import fused_gating
from ..kernels.moe_gating.ref import reference_gating
from ..sharding import tp as tpl
from ..sharding.ranks import batch_mean
from .layers import silu
from .params import ParamDef, Spec


def moe_spec(cfg: ArchConfig, d_ff: int | None = None) -> Spec:
    d, f, E = cfg.d_model, d_ff or cfg.d_ff, cfg.n_experts
    spec = {"router": ParamDef((d, E), ("embed", "expert"))}
    if cfg.act == "swiglu":
        spec.update({
            "wi0": ParamDef((E, d, f), ("expert", "embed", "mlp")),
            "wi1": ParamDef((E, d, f), ("expert", "embed", "mlp")),
            "wo": ParamDef((E, f, d), ("expert", "mlp", "embed")),
        })
    else:
        spec.update({
            "wi": ParamDef((E, d, f), ("expert", "embed", "mlp")),
            "wo": ParamDef((E, f, d), ("expert", "mlp", "embed")),
        })
    return spec


SCAN_BASE = 16


def scan_sum(v, dim: int):
    """Inclusive cumulative sum of `v` along `dim`, each partial sum
    rounded in v's type, in the order XLA's CPU backend computes
    `jnp.cumsum` (its reduce-window scan rewritten into nested scans of
    16): the axis is padded to a multiple of 16 and cut into blocks; each
    block is summed left to right; the blocks' totals are scanned the same
    way (recursively), and each block's elements get the total of the
    blocks before it added.  Exact wherever the partial sums are (counts up
    to 256 in bfloat16, 2^24 in float32)."""
    v = v.movedim(dim, -1)
    L = v.shape[-1]
    if L <= SCAN_BASE:
        outs = [v[..., 0]]
        for i in range(1, L):
            outs.append(outs[-1] + v[..., i])
        out = torch.stack(outs, dim=-1)
    else:
        blocks = F.pad(v, (0, (-L) % SCAN_BASE)).reshape(
            *v.shape[:-1], -1, SCAN_BASE)
        inner = scan_sum(blocks, -1)
        before = F.pad(scan_sum(inner[..., -1], -1), (1, 0))[..., :-1]
        out = (inner + before[..., None]).flatten(-2)[..., :L]
    return out.movedim(-1, dim)


def expert_counts(onehot, C: int):
    """Inclusive count of each expert's choices along dim 1 of `onehot`
    [G, n·k, E], in its type.  Integers up to M = 2/eps of the type are
    exact, so a count up to M comes out exact in any summation order and
    a larger one comes out at least M (rounding is monotone).  A slot is
    kept when count − 1 < C; so where n·k <= M or C < M every kept slot is
    the same whatever the order, and one `torch.cumsum` gives the
    reference's slots (taken along the innermost axis: CUDA's scan along
    an outer axis runs one thread per column).  Only past that (bfloat16
    with C >= 256) does the order matter, and `scan_sum` follows XLA's."""
    exact = 2.0 / torch.finfo(onehot.dtype).eps
    if onehot.shape[1] <= exact or C < exact:
        return torch.cumsum(onehot.transpose(1, 2).contiguous(),
                            dim=-1).transpose(1, 2)
    return scan_sum(onehot, dim=1)


def router_topk(cfg: ArchConfig, p, x, need_aux: bool = True,
                interpret: bool = False):
    """x [N, d] flattened tokens → (gate [N, k] in x's type, expert ids
    [N, k] int32, aux loss [] float32, or None unless `need_aux`)."""
    tp = tpl.context()
    E = cfg.n_experts
    logits = (x @ p["router"].to(x.dtype)).float()                # [N, E]
    if tp is not None and logits.shape[-1] != E:    # the rules' block
        logits = tp.gather(logits)
    if cfg.use_flash_kernel:
        gate, idx = fused_gating(logits, cfg.top_k, interpret=interpret)
    else:
        gate, idx = reference_gating(logits, cfg.top_k)
    aux = None
    if need_aux:
        # Switch-style load-balance loss: E · Σ_e f_e · P_e
        # over the whole batch when a mesh splits it, as GSPMD takes the
        # reference's means (`ranks.batch_mean`)
        me = batch_mean(torch.mean(torch.softmax(logits, dim=-1), dim=0))
        ce = batch_mean(torch.mean(F.one_hot(idx.long(), E).float().sum(1),
                                   dim=0))
        if tp is None:
            aux = E * torch.sum(me * ce)
        else:
            lo, hi = tp.range(E)
            aux = tp.all_reduce(E * torch.sum(me[lo:hi] * ce[lo:hi]))
    return gate.to(x.dtype), idx, aux


def moe_apply(cfg: ArchConfig, p, x, group_size: int = 512,
              need_aux: bool = True, interpret: bool = False):
    """x [B, S, d] → (y [B, S, d], aux loss or None).  Groups of
    ng = min(group_size, S) tokens of one batch row; S is padded to a
    multiple of ng and padded tokens get gate 0, so they are never
    dispatched.  Under a tensor-parallel axis x is the full rows and y
    this rank's experts' partial sum."""
    B, S0, d = x.shape
    ng = max(1, min(group_size, S0))
    pad = (-S0) % ng
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    S = S0 + pad
    N = B * S
    G = N // ng
    xg = x.reshape(G, ng, d)

    gate, idx, aux = router_topk(cfg, p, xg.reshape(N, d), need_aux,
                                 interpret)
    E, k = cfg.n_experts, cfg.top_k
    if pad:
        live = torch.arange(S, device=x.device) < S0
        gate = gate * live[None, :, None].expand(B, S, k).reshape(N, k)
    C = max(1, int(cfg.capacity_factor * ng * k / E))
    # `jnp` compares against the Python int C in x's type
    C_x = float(torch.tensor(float(C), dtype=x.dtype))
    gate = gate.reshape(G, ng, k)
    idx = idx.reshape(G, ng, k)

    onehot = F.one_hot(idx.long(), E).to(x.dtype)                 # [G,n,k,E]
    # slot of each (token, choice) within its expert's group-local buffer
    pos = expert_counts(onehot.reshape(G, ng * k, E), C) - 1.0
    pos = (pos.reshape(G, ng, k, E) * onehot).sum(-1)              # [G,n,k]
    keep = (pos < C_x) & (gate > 0)
    pos = torch.where(keep, pos, 0).long()

    pos_oh = F.one_hot(pos, C).to(x.dtype) * keep[..., None].to(x.dtype)
    tp = tpl.context()
    if tp is not None and tp.splits("expert"):     # this rank's experts
        lo, hi = tp.range(E)
        onehot = onehot[..., lo:hi]
        p = {k: w if k == "router" else tp.local(w, 0, E)
             for k, w in p.items()}
    dispatch = torch.einsum("gnke,gnkc->gnec", onehot, pos_oh)     # [G,n,E,C]
    expert_in = torch.einsum("gnd,gnec->gecd", xg, dispatch)       # [G,E,C,d]

    if cfg.act == "swiglu":
        h = silu(torch.einsum("gecd,edf->gecf", expert_in, p["wi0"])) * \
            torch.einsum("gecd,edf->gecf", expert_in, p["wi1"])
    elif cfg.act == "sq_relu":
        h = torch.square(F.relu(
            torch.einsum("gecd,edf->gecf", expert_in, p["wi"])))
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", expert_in, p["wi"]),
                   approximate="tanh")              # jax.nn.gelu's default
    expert_out = torch.einsum("gecf,efd->gecd", h, p["wo"])        # [G,E,C,d]

    combine = dispatch * torch.einsum("gnk,gnke->gne", gate, onehot)[..., None]
    y = torch.einsum("gecd,gnec->gnd", expert_out, combine)
    return y.reshape(B, S, d)[:, :S0], aux

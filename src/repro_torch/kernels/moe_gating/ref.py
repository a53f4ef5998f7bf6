"""Plain PyTorch version of the fused MoE router gating kernel.

`reference_gating` computes what `kernel.gating_topk` returns, in the
kernel's order (the TPU kernel's `_gating_kernel`): the row max,
exp(l − m), the sum over the experts in the kernel's order
(`lane_butterfly_sum`), probs = p / sum; then k passes of
`torch.argmax`, which returns the first maximum and ranks NaN above
every number (the first NaN first), each masking its winner with −1e30;
the running total of the k gates, and gate / max(total, 1e-9).  Its ids are `lax.top_k`'s:
descending, ties to the lowest index.  It does not use `torch.topk`,
whose order among equal values is not specified.  The CPU path of
`ops.fused_gating` and its `interpret=True`, the router with
`use_flash_kernel=False`, and the tests use it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
LANES = 32                       # a warp: the kernel's lanes per row


def lane_butterfly_sum(p):
    """Σ over the last axis of p [N, E] in the kernel's order: E padded
    with zeros to a multiple of 32 and laid out as lane l holding columns
    l, l + 32, ...; each lane sums its columns in index order, then the
    lanes are halved, a[:, :16] + a[:, 16:], down to one."""
    N, E = p.shape
    cols = -(-E // LANES)
    a = torch.cat([p, p.new_zeros((N, cols * LANES - E))], dim=-1) \
        .reshape(N, cols, LANES)
    s = a[:, 0]
    for c in range(1, cols):
        s = s + a[:, c]
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s = s[:, :half] + s[:, half:]
    return s[:, 0]


def reference_gating(logits, top_k: int):
    """logits [N, E] → (gate [N, k] float32 renormalised, idx [N, k]
    int32)."""
    x = logits.float()
    N, E = x.shape
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    remaining = p / lane_butterfly_sum(p)[:, None]
    cols = torch.arange(E, device=x.device)
    gates, idxs = [], []
    total = torch.zeros(N, dtype=torch.float32, device=x.device)
    for _ in range(top_k):
        i = torch.argmax(remaining, dim=-1)
        g = remaining.gather(1, i[:, None])[:, 0]
        gates.append(g)
        idxs.append(i)
        total = total + g
        remaining = torch.where(cols == i[:, None], NEG_INF, remaining)
    gate = torch.stack(gates, dim=-1) / torch.clamp_min(total, 1e-9)[:, None]
    return gate, torch.stack(idxs, dim=-1).to(torch.int32)

"""Plain PyTorch version of the placement-score kernel.

Mirrors `kernel.placement_score` operation for operation (and through it
the reference's `core.placement.row_feasible` power condition and
`row_scores` variance term): the CPU path of `ops.score_rows`, and the
oracle the CUDA kernel is held to on the card.
"""
from __future__ import annotations

import torch

BIG = 1e30
SLACK = 1e-4


def reference_score(row_feeds, row_nfeeds, row_cap, row_load, lineup_ha,
                    lineup_tot, lineup_cap, p_dep, ha_frac, is_ha, is_block):
    """Batched power feasibility and variance score.

    row_feeds [N, R, 4] int32 (-1 padded), row_nfeeds [N, R] int32,
    row_cap/row_load [N, R, 4] float32 (the power column is read),
    lineup_ha/lineup_tot/lineup_cap [N, X] float32, p_dep/ha_frac [N]
    float32, is_ha/is_block [N] bool.  Returns (feas [N, R] bool,
    score [N, R] float32); infeasible rows score `BIG`.

    The four feed terms are summed as ((t0 + t1) + t2) + t3, the order
    the CUDA kernel uses."""
    N, R, F = row_feeds.shape
    valid = row_feeds >= 0
    safe = torch.where(valid, row_feeds, 0).long().reshape(N, R * F)

    def gather(a):
        return a.gather(1, safe).reshape(N, R, F)

    cap, ha, tot = gather(lineup_cap), gather(lineup_ha), gather(lineup_tot)
    nf = row_nfeeds.float()
    p = p_dep[:, None]
    share = p / torch.clamp(nf, min=1.0)               # balanced share P/k
    delta = p / torch.clamp(nf - 1.0, min=1.0)         # failover (Eq. 1)
    tot_ok = tot + share[..., None] <= cap + SLACK
    ha_ok = (ha + delta[..., None] <= ha_frac[:, None, None] * cap + SLACK) \
        & tot_ok
    block_ok = tot + p[..., None] <= cap + SLACK       # quantization (Eq. 2)
    ha_tier = is_ha[:, None, None]
    dist_ok = torch.where(ha_tier, ha_ok, tot_ok)
    per_feed = torch.where(is_block[:, None, None], block_ok, dist_ok)
    power_ok = (per_feed | ~valid).all(dim=-1)
    fits = row_load[..., 0] + p <= row_cap[..., 0] + SLACK
    feas = power_ok & fits

    capm = torch.clamp(cap, min=1.0)
    s = share[..., None] / capm
    lhat = torch.where(ha_tier, ha, tot) / capm
    t = torch.where(valid, 2.0 * lhat * s + s * s, torch.zeros_like(s))
    var = ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]
    return feas, torch.where(feas, var, torch.full_like(var, BIG))

"""Streaming quantile estimators for the lifecycle's monthly statistics.

The counterpart of `repro.core.quantiles`.  The lifecycle's p50/p90
mature-hall stranding is either an exact reduction over the whole
``[N, M, H]`` stranding history (`fleet._masked_percentiles`) or, with
``exact_quantiles=False``, a fixed-bin histogram estimate of each
month's ``[N, H]`` cross-section, so no history is kept:

* `hist_masked_quantiles`: histogram quantiles over a masked
  cross-section, batched over leading axes.  Stranding fractions live in
  ``[0, 1]``; a static ``n_bins``-bucket histogram plus rank
  interpolation estimates any quantile within one bin width
  ``(hi - lo) / n_bins`` (each interpolated order statistic stays in its
  true bucket; see `_rank_value`).
* `p2_stream_quantiles`: the Jain & Chlamtac P² estimator over a masked
  stream, five markers per quantile with parabolic updates; streams of
  fewer than five valid observations take the exact small-sample
  quantile.  It carries no hard error bound.

Both follow ``np.percentile``'s 'linear' rank convention (``pos = q/100 ·
(n - 1)``); an all-masked input yields NaN, as `_masked_percentiles`
does.  Every float32 operation is the reference's, in its order.  The
reference's P² updates run inside a compiled `lax.scan`, where XLA
fuses ``a·b + c`` into one rounding; `_fma` does the same here, so the
port's P² is bitwise the reference's function as called.  (Under an
outer `jax.jit` the reference also fuses the small-sample interpolation,
which then differs by at most one float32 rounding.)
"""
from __future__ import annotations

import torch

# Histogram resolution of the streaming lifecycle path: 512 buckets over
# [0, 1] bound the stranding-quantile error at ~0.2% absolute.
DEFAULT_BINS = 512


def _rank_value(counts, cdf, j, n_bins, lo, width):
    """Histogram estimate of the value at integer 0-indexed rank `j`
    ([..., 1]), batched over the leading axes of `counts`/`cdf`
    ([..., n_bins]).

    Bucket k holds ranks ``[cdf[k-1], cdf[k])``, so the true order
    statistic lies in ``[lo + k·width, lo + (k+1)·width)``; spreading the
    bucket's mass uniformly places rank j at fraction ``(j - cdf[k-1] +
    0.5) / counts[k]`` through the bucket, so the estimate never leaves
    the true bucket."""
    k = torch.clamp(torch.searchsorted(cdf, j, right=True), 0, n_bins - 1)
    below = torch.where(k > 0, cdf.gather(-1, torch.clamp(k - 1, min=0)),
                        torch.zeros_like(j))
    c = torch.clamp(counts.gather(-1, k), min=1.0)
    frac = torch.clamp((j - below + 0.5) / c, 0.0, 1.0)
    return lo + width * (k.float() + frac)


def hist_masked_quantiles(x, mask, qs, n_bins: int = DEFAULT_BINS,
                          lo: float = 0.0, hi: float = 1.0):
    """Histogram quantiles of ``x[mask]`` along the last axis for each
    static q in `qs`; `x` and `mask` are ``[..., H]`` and each result is
    ``[...]``.

    Values are clipped into ``[lo, hi]`` before binning.  The continuous
    rank ``q/100 · (n - 1)`` interpolates linearly between its two
    neighbouring integer-rank estimates, so the absolute error is at most
    one bin width ``(hi - lo) / n_bins``.  A NaN value counts in the
    lowest bucket, as in `repro`.  NaN where the mask selects nothing."""
    width = (hi - lo) / n_bins
    w = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    # NaN goes to bucket 0, as `repro`'s int cast gives on XLA:CPU; the
    # float-to-int cast of NaN itself differs between platforms
    w = torch.nan_to_num(w, nan=0.0)
    b = torch.clamp((w * n_bins).to(torch.int32), max=n_bins - 1).long()
    counts = torch.zeros(x.shape[:-1] + (n_bins,), dtype=torch.float32,
                         device=x.device)
    counts.scatter_add_(-1, b, mask.float())
    cdf = torch.cumsum(counts, dim=-1)
    n = cdf[..., -1:]
    top = torch.clamp(n - 1.0, min=0.0)
    out = []
    for q in qs:
        pos = q / 100.0 * top
        j_lo = torch.floor(pos)
        frac = pos - j_lo
        v_lo = _rank_value(counts, cdf, j_lo, n_bins, lo, width)
        v_hi = _rank_value(counts, cdf, torch.ceil(pos), n_bins, lo, width)
        val = v_lo * (1.0 - frac) + v_hi * frac
        out.append(torch.where(n > 0, val, torch.full_like(val,
                                                          float("nan")))
                   [..., 0])
    return tuple(out)


def _fma(a, b, c):
    """``a·b + c`` rounded once to float32, as a fused multiply-add: the
    product of two float32 values is exact in float64, so only the sum
    rounds there (a second rounding to float32 could differ only on an
    exact float32 half-way point of the float64 sum)."""
    return (a.double() * b.double() + c.double()).float()


def _small_sample_quantiles(buf, n, qs):
    """Exact 'linear' quantiles of the first `n` (< 5) entries of the
    sorted, +inf-padded 5-slot P² bootstrap buffer `buf` ([5]).  For
    n ≥ 5 the result is discarded; its ranks are clamped into the buffer,
    as the reference's gathers clamp them."""
    top = torch.clamp(n - 1.0, min=0.0)
    out = []
    for q in qs:
        pos = q / 100.0 * top
        k_lo = torch.clamp(torch.floor(pos).long(), max=4)
        k_hi = torch.clamp(torch.ceil(pos).long(), max=4)
        frac = pos - k_lo.float()
        out.append(buf[k_lo] * (1.0 - frac) + buf[k_hi] * frac)
    return torch.stack(out)


def _p2_update(h, pos, n, x, d):
    """One P² step for all Q marker sets at once ([Q, 5] heights and
    positions): stretch the end markers to x, move the positions above
    x's cell, then adjust the middle markers in turn, marker i seeing
    marker i−1's move."""
    h = h.clone()
    h[:, 0] = torch.minimum(h[:, 0], x)
    h[:, 4] = torch.maximum(h[:, 4], x)
    k = torch.clamp((x >= h).sum(dim=1), 1, 4)                   # [Q]
    pos = pos + (torch.arange(5, device=h.device)[None, :]
                 >= k[:, None]).float()
    n_des = _fma(n - 1.0, d, torch.ones_like(d))                 # [Q, 5]
    for i in (1, 2, 3):
        hm, hi, hp = h[:, i - 1], h[:, i], h[:, i + 1]
        pm, pi, pp = pos[:, i - 1], pos[:, i], pos[:, i + 1]
        delta = n_des[:, i] - pi
        one = torch.ones_like(hi)
        s = torch.where((delta >= 1.0) & (pp - pi > 1.0), one,
                        torch.where((delta <= -1.0) & (pm - pi < -1.0),
                                    -one, 0.0 * one))
        # parabolic estimate; the linear fallback keeps monotonicity
        para = _fma(s / (pp - pm),
                    (pi - pm + s) * (hp - hi) / (pp - pi)
                    + (pp - pi - s) * (hi - hm) / (pi - pm), hi)
        lin = _fma(s, torch.where(s > 0, (hp - hi) / (pp - pi),
                                  (hi - hm) / (pi - pm)), hi)
        new = torch.where((para <= hm) | (para >= hp), lin, para)
        h[:, i] = torch.where(s != 0.0, new, hi)
        pos = pos.clone()
        pos[:, i] = pi + s
    return h, pos


def p2_stream_quantiles(xs, mask, qs):
    """P² streaming quantiles of the masked stream ``xs[mask]`` ([E]
    each; `qs` a static tuple of percentiles).  Returns a ``[len(qs)]``
    float32 tensor.

    Each quantile keeps five markers (heights, integer positions,
    desired positions ``1 + (n-1)·d``).  The first five valid
    observations are inserted into a sorted, +inf-padded 5-slot buffer
    shared by every marker row; the step that fills the fifth slot
    leaves the sorted initial markers at positions 1..5.  Streams that
    never reach five fall back to the exact small-sample quantile (NaN
    when the mask selects nothing).  A loop over the stream, one step
    per element, as the reference's scan."""
    xs = torch.as_tensor(xs, dtype=torch.float32)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=xs.device)
    Q = len(qs)
    qarr = torch.tensor([q / 100.0 for q in qs], dtype=torch.float32,
                        device=xs.device)
    # desired-position increments d = [0, p/2, p, (1+p)/2, 1]      [Q, 5]
    d = torch.stack([torch.zeros_like(qarr), qarr / 2.0, qarr,
                     (1.0 + qarr) / 2.0, torch.ones_like(qarr)], dim=1)
    pos0 = torch.arange(1.0, 6.0, device=xs.device).expand(Q, 5)
    h = torch.full((Q, 5), float("inf"), device=xs.device)
    pos = pos0.clone()
    n = torch.zeros((), dtype=torch.float32, device=xs.device)
    for x, ok in zip(xs.unbind(0), mask.tolist()):
        if not ok:
            continue
        if float(n) < 5.0:
            boot = h.clone()
            boot[:, min(int(n), 4)] = x
            h, pos = torch.sort(boot, dim=1).values, pos0.clone()
        else:
            h, pos = _p2_update(h, pos, n + 1.0, x, d)
        n = n + 1.0
    small = _small_sample_quantiles(h[0], n, qs)   # rows equal for n < 5
    est = torch.where(n >= 5.0, h[:, 2], small)
    return torch.where(n > 0.0, est, torch.full_like(est, float("nan")))

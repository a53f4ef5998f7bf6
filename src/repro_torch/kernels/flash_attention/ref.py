"""Plain PyTorch versions of flash attention.

`reference_attention` is the independent oracle
(`repro.kernels.flash_attention.ref.reference_attention`): GQA by head
repeat, float32 scores, causal mask with −1e30, one softmax.
`reference_flash_bhsd` is the reference kernel's function, tile by tile
as `_flash_kernel` computes it, with whole-tensor float32 ops: q scaled
by hd^-1/2 before the product, keys in tiles of `block_k` masked to −1e30
past `kv_len` and above the diagonal, the running max, sum and output
updated once per tile, and `acc / max(l, 1e-30)` in q's type.  The CPU
path and `interpret=True` compute it, and the float32 CUDA kernel differs
from it only in the order of the sums inside a tile.

`rounded_flash_bhsd` is the bf16 CUDA kernel's plain version: the same
function with the kernel's one extra rounding, p to bf16 before P·V (l
sums the float32 p), in the kernel's order (tiles of `KEY_TILE` keys, q
unscaled, the scores times hd^-1/2·log2 e, exp2).  The checks on the card
hold the kernel to it; nothing on the main path calls it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30
KEY_TILE = 128              # keys per tile of the bf16 kernel
LOG2E = np.float32(math.log2(math.e))
# float32 arithmetic of two orders, for the flip slack below: one float32
# ulp per addition of the hd-term dot product on each side (which also
# covers an accumulator that truncates), one rounding of each later
# operation, and 2 ulps for each side's exp2
F32_ULP = 2.0 ** -23
EXP2_REL = 2.0 ** -21


def score_scale(hd: int) -> float:
    """What the bf16 kernel multiplies its float32 scores by: hd^-1/2
    rounded to float32 (as ctypes passes it) times log2 e, in float32."""
    return float(np.float32(1.0 / hd ** 0.5) * LOG2E)


def reference_attention(q, k, v, causal=True):
    """q: [B,H,Sq,hd]; k,v: [B,Hk,Skv,hd]; GQA via head repeat."""
    B, H, Sq, hd = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    G = H // Hk
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (hd ** 0.5)
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= \
            torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def reference_flash_bhsd(q, k, v, *, causal: bool = True, kv_len: int,
                         block_k: int = 128):
    """The kernel's function: q [B,H,Sq,hd], k, v [B,Hk,Skv,hd] with Skv a
    multiple of `block_k` → o [B,H,Sq,hd] in q's type."""
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    G = H // k.shape[1]
    dev = q.device
    qs = q.float() * (1.0 / hd ** 0.5)
    kk = k.float().repeat_interleave(G, dim=1)
    vv = v.float().repeat_interleave(G, dim=1)
    rows = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, Skv, block_k):
        s = qs @ kk[:, :, k0:k0 + block_k].transpose(-1, -2)
        cols = k0 + torch.arange(block_k, device=dev)[None, :]
        mask = cols < kv_len
        if causal:
            mask = mask & (rows >= cols)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vv[:, :, k0:k0 + block_k]
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def rounded_flash_bhsd(q, k, v, *, causal: bool = True, kv_len: int,
                       with_slack: bool = False):
    """The bf16 kernel's function: q [B,H,Sq,hd], k, v [B,Hk,Skv,hd] →
    o [B,H,Sq,hd] in q's type, with p rounded to bf16 before P·V.

    With `with_slack`, also returns the flip slack [B,H,Sq,hd]: where
    another float32 order (the kernel's) could round some p to the
    neighbouring bf16 value, how far that moves each output.  A p whose
    float32 value lies within η·p of a bf16 rounding midpoint may round
    either way, by one bf16 ulp; η bounds the two orders' disagreement
    in p:
      |Δs| <= 2^-22·hd·c·(|q|·|k|) + 2^-23·|s|   (dot products, scaling)
      |Δd| <= |Δs| + max_row |Δs| + 2^-23·|d|    (d = s − m)
      η    =  ln 2·|Δd| + 2^-21                  (two exp2s)
    and the slack is Σ (one ulp at each such p)·|v| / l, carried across
    tiles like the output.  Away from those p the two roundings agree."""
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    G = H // k.shape[1]
    dev = q.device
    c = score_scale(hd)
    n_tiles = -(-kv_len // KEY_TILE)
    pad = n_tiles * KEY_TILE - Skv
    widen = lambda t: torch.nn.functional.pad(
        t.float(), (0, 0, 0, max(pad, 0))).repeat_interleave(G, dim=1)
    kk, vv = widen(k), widen(v)
    qf = q.float()
    rows = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    if with_slack:
        slack = torch.zeros_like(acc)
        ds_max = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    for k0 in range(0, n_tiles * KEY_TILE, KEY_TILE):
        kt = kk[:, :, k0:k0 + KEY_TILE]
        vt = vv[:, :, k0:k0 + KEY_TILE]
        s = (qf @ kt.transpose(-1, -2)) * c
        cols = k0 + torch.arange(KEY_TILE, device=dev)[None, :]
        mask = cols < kv_len
        if causal:
            mask = mask & (rows >= cols)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(torch.bfloat16).float() @ vt
        if with_slack:
            ds = 2.0 ** -22 * hd * c * (qf.abs() @ kt.abs().transpose(-1, -2))
            ds = torch.where(mask, ds + F32_ULP * s.abs(), 0.0)
            ds_max = torch.maximum(ds_max, ds.amax(dim=-1))
            d = s - m_new[..., None]
            eta = math.log(2) * (ds + ds_max[..., None] + F32_ULP * d.abs()) \
                + EXP2_REL
            flip = (p * (1 + eta)).to(torch.bfloat16).float() - \
                (p * (1 - eta)).to(torch.bfloat16).float()
            slack = slack * corr[..., None] + torch.where(mask, flip, 0.0) \
                @ vt.abs()
        m = m_new
    o = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
    if not with_slack:
        return o
    return o, slack / torch.clamp_min(l, 1e-30)[..., None]

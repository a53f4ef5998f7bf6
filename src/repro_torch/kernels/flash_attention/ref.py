"""Plain PyTorch versions of flash attention.

`reference_attention` is the independent oracle
(`repro.kernels.flash_attention.ref.reference_attention`): GQA by head
repeat, float32 scores, causal mask with −1e30, one softmax.
`reference_flash_bhsd` computes what the kernel returns, tile by tile as
`_flash_kernel` does, with whole-tensor float32 ops: q scaled by hd^-1/2
before the product, keys in tiles of `block_k` masked to −1e30 past
`kv_len` and above the diagonal, the running max, sum and output updated
once per tile, and `acc / max(l, 1e-30)` in q's type.  The kernel then
differs from it only in the order of the sums inside a tile.  The CPU
path, `interpret=True` and the tests use it; on the card nothing on the
main path does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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

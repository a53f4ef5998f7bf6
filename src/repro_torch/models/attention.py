"""Grouped-query attention (port of `repro.models.attention`): the full
attention of scoring and prefill, the encoder's and the cross-attention,
and decode with a KV cache.

The default math path is plain PyTorch (`_sdpa`, or `_sdpa_blockwise`
for long sequences).  `cfg.use_flash_kernel` switches the causal
self-attention of the scoring forward (`attention` without `x_kv`) to
`repro_torch.kernels.flash_attention`, the hand-written CUDA kernel on
the card; the encoder's non-causal attention, the cross-attention,
prefill and decode always take the plain path, as in the reference.
Every family runs through it (GQA groups of 1 to 8 query heads per K/V
head); with `cfg.mrope_sections` and `positions3` the rotation is
M-RoPE, else RoPE.

Under a wide mesh axis that the rules put the heads on (`sharding.tp`
`axis_of`: "model" under `base_rules`, "data" under
`sequence_parallel_rules` with "data" > 1), the scoring and training
attention computes this rank's range of query heads on that axis and
the K/V heads they read (`_local_heads`), and `attention` returns its
partial sum of the output projection; qk-norm and the rotation act per
head.  Where the rules put the heads on no wide axis
(`sequence_parallel_rules` with "data" 1) every rank computes them all.

Serving (`prefill_attention`, `decode_attention`, each given the
cache's global length `max_seq`): the rank's q heads, and the K/V heads
its cache block holds (`_serve_heads`): its block of them where the
rules shard `kv_heads` on the heads' axis, else all of them (K/V heads
that do not divide over it, 8 over 16 in the reference's dry-run), every
rank of that axis writing the same whole cache heads.  Where the rules
put the cache's sequence (`seq_kv`) on a wide axis (`decode_32k`'s
layout and `sequence_parallel_rules`: "model") rank r of it holds
positions [r·Sl, (r+1)·Sl), Sl = max_seq / M, so the cache block is
[B, Sl, its K/V heads, hd].  Prefill then attends over the whole prompt
and writes only the rank's positions; decode writes the new row on the
rank that holds `pos`, and each rank attends its q heads over its
positions: the q heads of the whole axis gathered first where the heads
lie on the sequence's axis (`decode_32k`), its own heads where they lie
on another ("data").  The partial softmax merges over the sequence's
axis by an all-reduce of the row maxima and then one of the rescaled
sums and weighted values (`_merged_decode`), flash-decoding's combine.
The cache is never gathered.  The write's clamp (`_write`) is taken on
the global length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention import ops as fa
from ..sharding import ranks
from ..sharding import tp as tpl
from .layers import apply_mrope, apply_rope, rms_norm
from .params import ParamDef, Spec

NEG_INF = -2.0e38


def attn_spec(cfg: ArchConfig, cross: bool = False) -> Spec:
    """The projections; q/k norms with `cfg.qk_norm`, except on the
    cross-attention (`cross`)."""
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    spec = {
        "q": ParamDef((d, H, hd), ("embed", "heads", "head_dim")),
        "k": ParamDef((d, Hk, hd), ("embed", "kv_heads", "head_dim")),
        "v": ParamDef((d, Hk, hd), ("embed", "kv_heads", "head_dim")),
        "o": ParamDef((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm and not cross:
        spec["q_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
        spec["k_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
    return spec


def _local_heads(cfg: ArchConfig, p):
    """(p with this rank's q and o heads and the K/V heads they read,
    the K/V head of each local q head where the local heads do not group
    evenly, else None).  The reference groups q head h with K/V head
    h // G (G = H / Hk); this rank's q heads [lo, hi) read the K/V heads
    [lo // G, (hi − 1) // G], a block of the rules' where they shard
    kv_heads, else a narrowing of the whole K/V weights (kv_heads do not
    divide over the axis, e.g. fewer than its size: one K/V head may
    serve the q heads of several ranks).  `p` and None where the heads
    lie on no wide axis."""
    tp = tpl.axis_of("heads")
    if tp is None:
        return p, None
    H, Hk = cfg.n_heads, cfg.n_kv_heads
    G = H // Hk
    lo, hi = tp.range(H)
    k_lo, k_hi = lo // G, (hi - 1) // G + 1
    out = dict(p, q=tp.local(p["q"], 1, H), o=tp.local(p["o"], 0, H))
    for name in ("k", "v"):
        w = p[name]
        if w.shape[1] == Hk:
            w = w[:, k_lo:k_hi]
        elif w.shape[1] != k_hi - k_lo:
            raise ValueError(f"{name} has {w.shape[1]} K/V heads; this "
                             f"rank's q heads [{lo}, {hi}) read "
                             f"[{k_lo}, {k_hi})")
        out[name] = w
    of_q = torch.arange(lo, hi) // G - k_lo
    n_q, n_kv = hi - lo, k_hi - k_lo
    even = n_q % n_kv == 0 and torch.equal(
        of_q, torch.arange(n_kv).repeat_interleave(n_q // n_kv))
    return out, None if even else of_q


def _project_qkv(cfg: ArchConfig, p, x, x_kv=None, positions=None,
                 positions3=None, use_rope=True):
    """q [B,S,H,hd] from x, k and v [B,Skv,Hk,hd] from `x_kv` (default
    x); qk-norm per head, then M-RoPE (with `cfg.mrope_sections` and
    `positions3` [3,B,S]) or RoPE, unless `use_rope` is off or there are
    no `positions`.  Under a tensor-parallel axis `p` holds this rank's
    heads (`_local_heads`)."""
    x_kv = x if x_kv is None else x_kv
    q = torch.einsum("bsd,dhk->bshk", x, p["q"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x_kv, p["k"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x_kv, p["v"].to(x.dtype))
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and positions is not None:
        if cfg.mrope_sections is not None and positions3 is not None:
            q = apply_mrope(q, positions3, cfg.mrope_sections,
                            cfg.rope_theta)
            k = apply_mrope(k, positions3, cfg.mrope_sections,
                            cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sqrt_hd(hd: int):
    """√hd in float32, as `jnp.sqrt(hd).astype(jnp.float32)`."""
    return torch.sqrt(torch.tensor(hd, dtype=torch.float32))


def _sdpa(cfg: ArchConfig, q, k, v, mask):
    """q: [B,Sq,H,hd]; k,v: [B,Skv,Hk,hd]; mask broadcastable to
    [B,1,Sq,Skv] (True = attend).  Mixed types promote, as `jnp.einsum`
    does (a float32 query against the bfloat16 cache); the softmax weights
    are cast to q's type before the PV product."""
    B, Sq, H, hd = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = q.reshape(B, Sq, Hk, G, hd)
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.to(dt), k.to(dt)).float()
    logits = logits / _sqrt_hd(hd).to(logits.device)
    if cfg.attn_logits_soft_cap:
        c = cfg.attn_logits_soft_cap
        logits = c * torch.tanh(logits / c)
    logits = torch.where(mask[:, :, None] if mask.dim() == 4 else mask,
                         logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = torch.promote_types(w.dtype, v.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", w.to(dt), v.to(dt))
    return out.reshape(B, Sq, H, hd)


# Use blockwise (online-softmax) attention above this many score elements.
_BLOCKWISE_THRESHOLD = 4096 * 4096


def _sdpa_blockwise(cfg: ArchConfig, q, k, v, causal: bool,
                    q_chunk: int = 512, kv_chunk: int = 1024):
    """Flash-style double-blocked attention in plain PyTorch: loops over
    query blocks and, for each, key/value blocks with an online-softmax
    carry; never materializes [Sq,Skv] scores."""
    B, Sq0, H, hd = q.shape
    Skv0 = k.shape[1]
    Hk = k.shape[2]
    G = H // Hk
    qc = max(1, min(q_chunk, Sq0))
    kc = max(1, min(kv_chunk, Skv0))
    # pad instead of shrinking blocks; padded KV columns are masked below
    qpad, kpad = (-Sq0) % qc, (-Skv0) % kc
    q = F.pad(q, (0, 0, 0, 0, 0, qpad))
    k = F.pad(k, (0, 0, 0, 0, 0, kpad))
    v = F.pad(v, (0, 0, 0, 0, 0, kpad))
    Sq, Skv = Sq0 + qpad, Skv0 + kpad
    dev = q.device
    scale = (1.0 / _sqrt_hd(hd)).to(dev)

    blocks = []
    for q0 in range(0, Sq, qc):
        qblk = q[:, q0:q0 + qc].reshape(B, qc, Hk, G, hd)
        q_pos = q0 + torch.arange(qc, device=dev)
        m = torch.full((B, Hk, G, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hk, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hk, G, qc, hd), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, Skv, kc):
            kblk, vblk = k[:, k0:k0 + kc], v[:, k0:k0 + kc]
            s = torch.einsum("bqhgk,bshk->bhgqs", qblk, kblk).float() * scale
            if cfg.attn_logits_soft_cap:
                c = cfg.attn_logits_soft_cap
                s = c * torch.tanh(s / c)
            k_pos = k0 + torch.arange(kc, device=dev)
            mask = k_pos[None, :] < Skv0                   # padded KV cols
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))       # [B,Hk,G,qc]
            corr = torch.exp(m - m_new)
            p_ = torch.exp(s - m_new[..., None])
            l = l * corr + p_.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqs,bshk->bhgqk", p_, vblk.float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)   # [B,Hk,G,qc,hd]
        out = out.permute(0, 3, 1, 2, 4).reshape(B, qc, H, hd)
        blocks.append(out.to(q.dtype))
    return torch.cat(blocks, dim=1)[:, :Sq0]


def _dispatch_sdpa(cfg: ArchConfig, q, k, v, causal: bool, mask=None):
    """Pick the O(S²)-mask path (small) or blockwise path (large)."""
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq * Skv >= _BLOCKWISE_THRESHOLD and mask is None:
        return _sdpa_blockwise(cfg, q, k, v, causal)
    if mask is None:
        if causal:
            qp = torch.arange(Sq, device=q.device)
            kp = torch.arange(Skv, device=q.device)
            mask = (qp[:, None] >= kp[None, :])[None, None]
        else:
            mask = torch.ones((1, 1, Sq, Skv), dtype=torch.bool,
                              device=q.device)
    return _sdpa(cfg, q, k, v, mask)


def attention(cfg: ArchConfig, p, x, positions, positions3=None,
              causal=True, x_kv=None, use_rope=True,
              interpret: bool = False):
    """Full attention of the scoring forward and the encoder (`x_kv`
    None: self-attention; `causal` off: the encoder's).  With
    `cfg.use_flash_kernel`, causal self-attention goes through the flash
    kernel (its plain version on the CPU or under `interpret=True`), which
    has no gradient.  Under a tensor-parallel axis `x` is the full rows
    and the result this rank's partial sum over its q heads."""
    p, kv_of_q = _local_heads(cfg, p)
    q, k, v = _project_qkv(cfg, p, x, x_kv, positions, positions3, use_rope)
    if kv_of_q is not None:     # one K/V head per local q head
        idx = kv_of_q.to(k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    if cfg.use_flash_kernel and causal and x_kv is None:
        out = fa.flash_attention(q, k, v, causal=True, interpret=interpret)
    else:
        out = _dispatch_sdpa(cfg, q, k, v, causal)
    return torch.einsum("bshk,hkd->bsd", out, p["o"].to(out.dtype))


class KVCache(NamedTuple):
    k: torch.Tensor       # [B, Smax, Hk, hd]
    v: torch.Tensor


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _write(cache: KVCache, k, v, start: int,
           max_seq: Optional[int] = None, offset: int = 0) -> KVCache:
    """Write k, v [B,S,Hk,hd] at sequence index `start`, in place (the
    reference's `dynamic_update_slice` makes a new array; the port writes
    into the caller's tensors, which may be views of the stacked
    caches).  Like `dynamic_update_slice`, `start` is clamped so that the
    update fits the cache's `max_seq` positions (default: its length): a
    decode step at or past the cache's end overwrites its last row.  A
    cache block that holds positions [offset, offset + its length) of
    them takes the rows that fall there."""
    n = cache.k.shape[1]
    max_seq = n if max_seq is None else max_seq
    start = max(0, min(start, max_seq - k.shape[1]))
    lo, hi = max(start, offset), min(start + k.shape[1], offset + n)
    if lo < hi:
        cache.k[:, lo - offset:hi - offset] = \
            k[:, lo - start:hi - start].to(cache.k.dtype)
        cache.v[:, lo - offset:hi - offset] = \
            v[:, lo - start:hi - start].to(cache.v.dtype)
    return cache


def _serve_heads(cfg: ArchConfig, p, cache: KVCache):
    """Serving's heads on this rank: (p with its q and o heads and the
    K/V weights of the heads its cache holds, (a, b) the K/V heads its q
    heads read as a range of those, the K/V head of each q head within
    that range where they do not group evenly, else None).  The cache
    holds the rules' block of the K/V heads, or all of them where
    `kv_heads` falls back to replicated (or is not on the axis); every
    rank then computes them all.  `p` whole where the heads lie on no
    wide axis."""
    H, Hk = cfg.n_heads, cfg.n_kv_heads
    tp = tpl.axis_of("heads")
    held = cache.k.shape[2]
    if tp is None:
        return p, (0, held), None
    G = H // Hk
    lo, hi = tp.range(H)
    k_lo, k_hi = lo // G, (hi - 1) // G + 1
    c_lo = 0 if held == Hk else tp.range(Hk)[0]
    if not c_lo <= k_lo < k_hi <= c_lo + held:
        raise ValueError(f"this rank's q heads [{lo}, {hi}) read K/V heads "
                         f"[{k_lo}, {k_hi}), its cache holds "
                         f"[{c_lo}, {c_lo + held})")
    out = dict(p, q=tp.local(p["q"], 1, H), o=tp.local(p["o"], 0, H))
    for name in ("k", "v"):
        w = p[name]
        out[name] = w[:, c_lo:c_lo + held] if w.shape[1] == Hk else w
    of_q = torch.arange(lo, hi) // G - k_lo
    n_q, n_kv = hi - lo, k_hi - k_lo
    even = n_q % n_kv == 0 and torch.equal(
        of_q, torch.arange(n_kv).repeat_interleave(n_q // n_kv))
    return out, (k_lo - c_lo, k_hi - c_lo), None if even else of_q


def _kv_all(cfg: ArchConfig, k, v, cache: KVCache):
    """k, v projected for the heads the K/V weights give, gathered over
    their axis where the cache holds more of them (`kv_heads` split over
    the axis in the weights while the cache's sequence takes the axis)."""
    if k.shape[2] == cache.k.shape[2]:
        return k, v
    tp = tpl.axis_of("kv_heads")
    return (tp.gather_ranges(k, 2, cfg.n_kv_heads),
            tp.gather_ranges(v, 2, cfg.n_kv_heads))


def _read(k, v, span, of_q):
    """The K/V heads this rank's q heads read: the range `span` of the
    cache's heads, and one per q head where they do not group evenly."""
    k, v = k[:, :, span[0]:span[1]], v[:, :, span[0]:span[1]]
    if of_q is not None:
        idx = of_q.to(k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return k, v


def _seq_block(cache: KVCache, max_seq: Optional[int]):
    """(the sequence's axis, the first position this rank's cache holds)
    where the cache's sequence is split over a wide axis, else (None,
    0)."""
    if max_seq is None or cache.k.shape[1] == max_seq:
        return None, 0
    tp = tpl.axis_of("seq_kv")
    if tp is None or cache.k.shape[1] * tp.n != max_seq:
        raise ValueError(f"a cache of {cache.k.shape[1]} positions for a "
                         f"length of {max_seq}")
    return tp, tp.r * cache.k.shape[1]


def prefill_attention(cfg: ArchConfig, p, x, positions, cache: KVCache,
                      positions3=None, max_seq: Optional[int] = None):
    """Causal attention that also writes the prompt K/V into the cache
    (this rank's heads and positions of it under a tensor-parallel axis:
    the module docstring).  Returns (y, cache): y the output projection,
    this rank's partial sum where the rules split the heads."""
    p, span, of_q = _serve_heads(cfg, p, cache)
    q, k, v = _project_qkv(cfg, p, x, None, positions, positions3)
    k, v = _kv_all(cfg, k, v, cache)
    _, offset = _seq_block(cache, max_seq)
    cache = _write(cache, k, v, 0, max_seq, offset)
    k, v = _read(k, v, span, of_q)
    out = _dispatch_sdpa(cfg, q, k, v, causal=True)
    y = torch.einsum("bshk,hkd->bsd", out, p["o"].to(out.dtype))
    return y, cache


def _merged_decode(cfg: ArchConfig, tp, q, k, v, pos: int, offset: int):
    """One query row [B,1,H,hd] against this rank's cache positions
    [offset, offset + Sl) of k, v [B,Sl,Hk,hd], masked to positions ≤
    `pos`, merged over the axis: the row maxima all-reduced (max), then
    each rank's sum of exp(s − max) and its weighted values (float32)
    all-reduced (sum).  `_sdpa`'s math: the scores in float32, scaled,
    soft-capped and masked, the output cast to q's type."""
    B, _, H, hd = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = q.reshape(B, 1, Hk, G, hd)
    dt = torch.promote_types(q.dtype, k.dtype)
    s = torch.einsum("bqhgk,bshk->bhgqs", qg.to(dt), k.to(dt)).float()
    s = s / _sqrt_hd(hd).to(s.device)
    if cfg.attn_logits_soft_cap:
        c = cfg.attn_logits_soft_cap
        s = c * torch.tanh(s / c)
    at = offset + torch.arange(k.shape[1], device=q.device)
    s = torch.where(at <= pos, s, NEG_INF)
    m = ranks.all_max_(s.amax(dim=-1, keepdim=True), tp.group)
    e = torch.exp(s - m)                                  # [B,Hk,G,1,Sl]
    acc = torch.einsum("bhgqs,bshk->bhgqk", e, v.float())
    both = ranks.all_sum_(torch.cat([e.sum(-1, keepdim=True), acc], -1),
                          tp.group)
    out = both[..., 1:] / both[..., :1]
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, hd).to(q.dtype)


def decode_attention(cfg: ArchConfig, p, x, pos: int, cache: KVCache,
                     positions3=None, max_seq: Optional[int] = None):
    """One-token decode: x [B,1,d]; `pos` the current index (same for all
    batch rows).  Returns (y [B,1,d], cache'); under a tensor-parallel
    axis the module docstring's layout."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    p, span, of_q = _serve_heads(cfg, p, cache)
    q, k, v = _project_qkv(cfg, p, x, None, positions, positions3)
    k, v = _kv_all(cfg, k, v, cache)
    tp, offset = _seq_block(cache, max_seq)
    cache = _write(cache, k, v, pos, max_seq, offset)
    if tp is not None:          # the cache's sequence over the axis
        split = tp.splits("heads")
        if split:               # every q head, to attend this rank's slice
            q = tp.gather_ranges(q, 2, cfg.n_heads)
            k, v = cache.k, cache.v
        else:                   # this rank's heads, whole or on "data"
            k, v = _read(cache.k, cache.v, span, of_q)
        out = _merged_decode(cfg, tp, q, k, v, pos, offset)
        if split:
            out = out[:, :, slice(*tp.range(cfg.n_heads))]
    else:
        Smax = cache.k.shape[1]
        mask = (torch.arange(Smax, device=x.device)[None, None, :]
                <= pos)[:, None]
        k, v = _read(cache.k, cache.v, span, of_q)
        out = _sdpa(cfg, q, k, v, mask)
    y = torch.einsum("bshk,hkd->bsd", out, p["o"].to(out.dtype))
    return y, cache


def cross_attention_cached(cfg: ArchConfig, p, x, enc_k, enc_v):
    """Decoder cross-attention against precomputed encoder K/V
    [B,S_enc,Hk,hd]: no q-norm, no rotation, no mask."""
    q = torch.einsum("bsd,dhk->bshk", x, p["q"].to(x.dtype))
    out = _dispatch_sdpa(cfg, q, enc_k, enc_v, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, p["o"].to(out.dtype))

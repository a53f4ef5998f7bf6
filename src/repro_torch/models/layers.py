"""Shared layer primitives (port of `repro.models.layers`): the RMS norm,
rotary embeddings (RoPE, and M-RoPE for the VLM), the MLP
variants (SwiGLU / squared-ReLU / GELU), the token embedding and head,
and the chunked cross-entropy.

Under a tensor-parallel axis (`sharding.tp`) the MLP is column-parallel
into this rank's MLP columns and row-parallel out, returning its partial
sum (whole on every rank where the rules leave `mlp` off the axis); the
embedding looks up this rank's vocabulary range and reduce-scatters to
the residual's block; the cross-entropy computes this rank's vocabulary
range of the logits and combines the ranks' logsumexp terms and the
label's logit with all-reduces; the full logits of serving (`unembed`)
are this rank's vocabulary range, all-gathered."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding import ranks
from ..sharding import tp as tpl
from .params import ParamDef, Spec


def rms_norm(x, scale, eps=1e-6):
    """Float32 statistics, cast back to the input type, then scaled."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float = 1e6):
    """x: [B, S, H, hd]; positions: [B, S] (int).  Split halves rotated in
    float32, cast back to x's type."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., None].float() * freqs           # [B,S,hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, sections: Tuple[int, int, int],
                theta: float = 1e6):
    """Multimodal RoPE (Qwen2-VL): the hd/2 rotary frequency bands are
    split into (temporal, height, width) sections, each rotated by its own
    position stream.  x: [B, S, H, hd]; positions3: [3, B, S] (int).  The
    sections are cut to hd/2 bands, as the reference cuts them; bands past
    their sum would find no stream, so a shorter sum raises."""
    hd = x.shape[-1]
    if sum(sections) < hd // 2:
        raise ValueError(f"M-RoPE sections {sections} cover fewer than the "
                         f"{hd // 2} frequency bands of head_dim {hd}")
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    sec = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])[:hd // 2]
    p = positions3.permute(1, 2, 0).float()                 # [B,S,3]
    band_pos = torch.gather(p, -1, sec.expand(p.shape[:2] + sec.shape))
    angles = band_pos * freqs                               # [B,S,hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_spec(cfg: ArchConfig, d_ff: Optional[int] = None) -> Spec:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi0": ParamDef((d, f), ("embed", "mlp")),
            "wi1": ParamDef((d, f), ("embed", "mlp")),
            "wo": ParamDef((f, d), ("mlp", "embed")),
        }
    return {
        "wi": ParamDef((d, f), ("embed", "mlp")),
        "wo": ParamDef((f, d), ("mlp", "embed")),
    }


def silu(a):
    """`jax.nn.silu` as XLA computes it on the CPU, eagerly and under
    `jit` alike: a · (1 / (1 + exp(−a))), each step rounded in a's type.
    `F.silu` rounds once; in bfloat16 the two differ by an ulp in many
    elements.  Both SwiGLUs (`mlp_apply`, the MoE experts) take it."""
    return a * (1.0 / (1.0 + torch.exp(-a)))


def mlp_apply(cfg: ArchConfig, p, x):
    """x [..., d] → [..., d]; under a tensor-parallel axis x is the full
    rows and the result this rank's partial sum over its MLP columns."""
    tp = tpl.context()
    if tp is not None and tp.splits("mlp"):
        p = {k: tp.local(w, 0 if k == "wo" else 1, cfg.d_ff)
             for k, w in p.items()}
    if cfg.act == "swiglu":
        h = silu(x @ p["wi0"]) * (x @ p["wi1"])
    elif cfg.act == "sq_relu":
        h = torch.square(F.relu(x @ p["wi"]))
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")   # jax.nn.gelu's default
    return h @ p["wo"]


def embed_spec(cfg: ArchConfig) -> Spec:
    d = cfg.d_model
    spec = {
        "tok": ParamDef((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
        "final_norm": ParamDef((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        spec["head"] = ParamDef((d, cfg.vocab), ("embed", "vocab"))
    return spec


def embed_tokens(p, tokens, vocab: Optional[int] = None):
    """The token rows; under a tensor-parallel axis this rank's block of
    them (`act_embed`): each rank looks up the ids of its range of the
    `vocab` entries (zero rows elsewhere) and the ranks' rows are summed
    and scattered, exactly the lookup's values."""
    tp = tpl.context()
    if tp is None:
        return p["tok"][tokens]
    if vocab is None:
        raise ValueError("a tensor-parallel lookup needs the vocabulary "
                         "size")
    lo, hi = tp.range(vocab)
    w = tp.local(p["tok"], 0, vocab)
    inside = (tokens >= lo) & (tokens < hi)
    rows = w[torch.where(inside, tokens - lo, 0)]
    return tp.scatter(torch.where(inside[..., None], rows, 0.0))


def unembed(cfg: ArchConfig, p, x, eps=1e-6):
    """Final norm and head; logits in float32.  Under a tensor-parallel
    axis `x` is the residual's block: each rank computes its vocabulary
    range of the logits from the full rows, and the ranges are
    all-gathered (padded where they are uneven), the same bits on every
    rank."""
    tp = tpl.context()
    x = rms_norm(tpl.gather(x), p["final_norm"], eps)
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    if tp is None:
        return (x @ w.to(x.dtype)).float()
    w = tp.local(w, 1, cfg.vocab)
    return tp.gather_ranges((x @ w.to(x.dtype)).float(), -1, cfg.vocab)


def chunked_ce(cfg: ArchConfig, p, hidden, labels, chunk: int = 512):
    """Cross-entropy without materializing [B,S,vocab] logits: logits are
    computed per sequence chunk in float32, labels < 0 are masked, and a
    sequence off the chunk is padded with label −1.  Returns (nll_sum
    float32, count).  Under a tensor-parallel axis `hidden` is the
    residual's block, gathered here; each rank computes its vocabulary
    range of the logits, the logsumexp comes from all-reduces of the row
    maxima and of the sums of exponentials, the label's logit from the
    rank whose range holds it (`_vocab_parallel_terms`)."""
    tp = tpl.context()
    x = rms_norm(tpl.gather(hidden), p["final_norm"], cfg.norm_eps)
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    if tp is not None:
        w = tp.local(w, 1, cfg.vocab)
    B, S, d = x.shape
    c = max(1, min(chunk, S))
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, S + pad, c):
        xb, lb = x[:, i:i + c], labels[:, i:i + c]
        logits = (xb @ w.to(xb.dtype)).float()
        valid = lb >= 0
        if tp is None:
            lse = torch.logsumexp(logits, dim=-1)           # [B,c]
            gold = torch.gather(logits, -1,
                                torch.where(valid, lb, 0)[..., None])[..., 0]
        else:
            lse, gold = _vocab_parallel_terms(tp, cfg.vocab, logits, lb)
        nll_sum = nll_sum + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum()
    return nll_sum, cnt


def _vocab_parallel_terms(tp, vocab: int, logits, labels):
    """(logsumexp, the label's logit) of rows whose logits are spread
    over the ranks by vocabulary range, this rank's `logits` [B,c,V_r];
    labels < 0 give a 0 label logit.  The all-reduces of the partial sums
    pass the gradient through, so each rank's logits get their part of
    it (`ranks.all_reduce`)."""
    lo, hi = tp.range(vocab)
    m = ranks.all_max_(logits.detach().amax(dim=-1), tp.group)
    sum_exp = tp.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1))
    lse = m + torch.log(sum_exp)
    own = (labels >= lo) & (labels < hi)
    gold = torch.gather(logits, -1,
                        torch.where(own, labels - lo, 0)[..., None])[..., 0]
    return lse, tp.all_reduce(torch.where(own, gold, 0.0))

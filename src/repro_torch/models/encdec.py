"""Encoder-decoder transformer, the audio family (Whisper); port of
`repro.models.encdec`.

The conv frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings [B, S_enc, d_model] (post-conv features),
and `encode` adds sinusoidal positions.  The encoder's attention is
non-causal and has no rotation.  Each decoder layer is causal
self-attention (RoPE), cross-attention over the encoder's states
(`attention.cross_attention_cached`, on K/V projected once per layer)
and the MLP.

The layers' parameters and caches are stacked along a leading layer
axis, as in the reference, and a Python loop walks that axis in place
of `lax.scan`.  Under grad mode, with `cfg.remat` other than "none",
each encoder and decoder layer is wrapped in a full checkpoint: the
reference wraps its scan bodies in a plain `jax.checkpoint`, with no
"dots" policy.  With `cfg.use_flash_kernel` the decoder's causal
self-attention in `decode_train` (scoring) goes through the flash
kernel; the encoder, the cross-attention and serving take the plain
attention, as in the reference.

Serving writes the decoder's self-attention K/V into the stacked caches
in place (each layer's cache is a view of them), as `lm` does, where the
reference returns new arrays: `serve_decode_step` returns the `DecCache`
it was given, updated, so a caller that needs the caches from before a
step copies them first.  The cross K/V are written once, by
`serve_prefill`, and only read after.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig
from . import attention as attn
from .layers import embed_tokens, mlp_apply, mlp_spec, rms_norm, unembed
from .lm import _positions, _unstack
from .params import ParamDef, Spec, stack_spec


def _sinusoid(S: int, d: int, device=None):
    """[S, d] float32: sin then cos of pos / 10000^(2i/d), i < d/2."""
    pos = torch.arange(S, device=device)[:, None].float()
    dim = torch.arange(d // 2, device=device)[None, :].float()
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def enc_block_spec(cfg: ArchConfig) -> Spec:
    d = cfg.d_model
    return {
        "norm1": ParamDef((d,), ("embed",), init="ones"),
        "mixer": attn.attn_spec(cfg),
        "norm2": ParamDef((d,), ("embed",), init="ones"),
        "ffn": mlp_spec(cfg),
    }


def dec_block_spec(cfg: ArchConfig) -> Spec:
    d = cfg.d_model
    return {
        "norm1": ParamDef((d,), ("embed",), init="ones"),
        "self": attn.attn_spec(cfg),
        "norm_x": ParamDef((d,), ("embed",), init="ones"),
        "cross": attn.attn_spec(cfg, cross=True),
        "norm2": ParamDef((d,), ("embed",), init="ones"),
        "ffn": mlp_spec(cfg),
    }


def encdec_spec(cfg: ArchConfig) -> Spec:
    d = cfg.d_model
    return {
        "embed": {
            "tok": ParamDef((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
            "final_norm": ParamDef((d,), ("embed",), init="ones"),
            "head": ParamDef((d, cfg.vocab), ("embed", "vocab")),
        },
        "encoder": stack_spec(enc_block_spec(cfg), cfg.n_enc_layers,
                              "layers"),
        "enc_norm": ParamDef((d,), ("embed",), init="ones"),
        "decoder": stack_spec(dec_block_spec(cfg), cfg.n_layers, "layers"),
    }


def _remat(cfg: ArchConfig, fn):
    """`fn` under a full checkpoint, unless `cfg.remat` is "none" or grad
    mode is off."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)


def encode(cfg: ArchConfig, params, frames):
    """frames: [B, S_enc, d] precomputed frame embeddings (frontend stub)
    → the encoder's states [B, S_enc, d], after `enc_norm`."""
    x = frames + _sinusoid(frames.shape[1], frames.shape[2],
                           frames.device).to(frames.dtype)[None]
    positions = _positions(x)

    def body(xcur, p):
        h = rms_norm(xcur, p["norm1"], cfg.norm_eps)
        xcur = xcur + attn.attention(cfg, p["mixer"], h, positions,
                                     causal=False, use_rope=False)
        h = rms_norm(xcur, p["norm2"], cfg.norm_eps)
        return xcur + mlp_apply(cfg, p["ffn"], h)

    body = _remat(cfg, body)
    for p in _unstack(params["encoder"]):
        x = body(x, p)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(cfg: ArchConfig, p_cross, enc_out):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p_cross["k"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p_cross["v"].to(enc_out.dtype))
    return k, v


class DecCache(NamedTuple):
    self_kv: attn.KVCache          # stacked [L, B, dec_max_seq, Hk, hd]
    cross_k: torch.Tensor          # [L, B, S_enc, Hk, hd]
    cross_v: torch.Tensor


def dec_cache_axes(cfg: ArchConfig) -> DecCache:
    """Logical axes of `init_dec_caches`' output, the reference's tree."""
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    cx = ("layers", "batch", "seq_kv", "kv_heads", "head_dim")
    return DecCache(attn.KVCache(kv, kv), cx, cx)


def precompute_cross(cfg: ArchConfig, params, enc_out):
    """Every decoder layer's cross K and V, stacked [L, B, S_enc, Hk, hd]."""
    ks, vs = zip(*(_cross_kv(cfg, p["cross"], enc_out)
                   for p in _unstack(params["decoder"])))
    return torch.stack(ks), torch.stack(vs)


def _dec_block(cfg: ArchConfig, p, x, self_attn, k, v):
    """One decoder layer: `self_attn(h)` (the causal self-attention of
    training, prefill or decode), cross-attention over k, v, the MLP."""
    x = x + self_attn(rms_norm(x, p["norm1"], cfg.norm_eps))
    h = rms_norm(x, p["norm_x"], cfg.norm_eps)
    x = x + attn.cross_attention_cached(cfg, p["cross"], h, k, v)
    return x + mlp_apply(cfg, p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps))


def decode_train(cfg: ArchConfig, params, tokens, enc_out,
                 interpret: bool = False):
    """Teacher-forced decoder pass: tokens [B, S_dec] → logits [B, S_dec,
    vocab] in float32."""
    x = embed_tokens(params["embed"], tokens)
    positions = _positions(x)

    def body(xcur, p):
        k, v = _cross_kv(cfg, p["cross"], enc_out)
        return _dec_block(cfg, p, xcur, lambda h: attn.attention(
            cfg, p["self"], h, positions, interpret=interpret), k, v)

    body = _remat(cfg, body)
    for p in _unstack(params["decoder"]):
        x = body(x, p)
    return unembed(cfg, params["embed"], x, cfg.norm_eps)


def encdec_loss(cfg: ArchConfig, params, batch,
                interpret: bool = False) -> Tuple[torch.Tensor, Dict]:
    """batch: {"frames": [B, S_enc, d], "tokens": [B, S_dec]}.  The decoder
    reads tokens[:, :-1] and predicts tokens[:, 1:] (labels < 0 masked),
    through full logits and `log_softmax`, as the reference; no aux loss."""
    enc_out = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"].long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits = decode_train(cfg, params, inputs, enc_out, interpret)
    logp = F.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = torch.clamp_min(valid.sum(), 1)
    loss = torch.where(valid, nll, 0.0).sum() / denom
    return loss, {"loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device),
                  "tokens": denom.to(torch.float32)}


def _self_caches(cfg: ArchConfig, batch: int, dtype, device):
    """The decoder's self-attention caches, [L, batch, dec_max_seq, Hk,
    hd] zeros."""
    shape = (cfg.n_layers, batch, cfg.dec_max_seq, cfg.n_kv_heads, cfg.hd)
    return attn.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def init_dec_caches(cfg: ArchConfig, batch: int, enc_seq: int,
                    dtype=torch.bfloat16, device=None) -> DecCache:
    """Zero caches: self-attention K/V over `dec_max_seq`, cross K/V over
    `enc_seq` encoder positions."""
    ck = torch.zeros((cfg.n_layers, batch, enc_seq, cfg.n_kv_heads, cfg.hd),
                     dtype=dtype, device=device)
    return DecCache(_self_caches(cfg, batch, dtype, device), ck,
                    torch.zeros_like(ck))


def serve_prefill(cfg: ArchConfig, params, frames, prompt):
    """Encode the audio, project every layer's cross K/V, prefill the
    decoder prompt [B, S].  Returns (logits [B, vocab] of the last prompt
    position, DecCache), the caches in `frames.dtype`."""
    enc_out = encode(cfg, params, frames)
    cross_k, cross_v = precompute_cross(cfg, params, enc_out)
    caches = DecCache(_self_caches(cfg, frames.shape[0], frames.dtype,
                                   frames.device),
                      cross_k.to(frames.dtype), cross_v.to(frames.dtype))
    x = embed_tokens(params["embed"], prompt)
    positions = _positions(x)
    for i, p in enumerate(_unstack(params["decoder"])):
        kv = attn.KVCache(caches.self_kv.k[i], caches.self_kv.v[i])
        x = _dec_block(cfg, p, x, lambda h: attn.prefill_attention(
            cfg, p["self"], h, positions, kv)[0], caches.cross_k[i],
            caches.cross_v[i])
    logits = unembed(cfg, params["embed"], x[:, -1:], cfg.norm_eps)
    return logits[:, 0], caches


def serve_decode_step(cfg: ArchConfig, params, token, pos, caches: DecCache):
    """One decoder token [B, 1] at the shared index `pos`: self K/V
    written into `caches` in place, cross-attention over the fixed
    encoder cache.  Returns (logits [B, vocab], caches)."""
    x = embed_tokens(params["embed"], token)
    pos = int(pos)
    for i, p in enumerate(_unstack(params["decoder"])):
        kv = attn.KVCache(caches.self_kv.k[i], caches.self_kv.v[i])
        x = _dec_block(cfg, p, x, lambda h: attn.decode_attention(
            cfg, p["self"], h, pos, kv)[0], caches.cross_k[i],
            caches.cross_v[i])
    logits = unembed(cfg, params["embed"], x, cfg.norm_eps)
    return logits[:, 0], caches

"""Layer primitives the SSM family uses (port of `repro.models.layers`):
the RMS norm and the token embedding and head.  RoPE and the MLPs come
with the dense slice."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .params import ParamDef, Spec


def rms_norm(x, scale, eps=1e-6):
    """Float32 statistics, cast back to the input type, then scaled."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def embed_spec(cfg: ArchConfig) -> Spec:
    d = cfg.d_model
    spec = {
        "tok": ParamDef((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
        "final_norm": ParamDef((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        spec["head"] = ParamDef((d, cfg.vocab), ("embed", "vocab"))
    return spec


def embed_tokens(p, tokens):
    return p["tok"][tokens]


def unembed(cfg: ArchConfig, p, x, eps=1e-6):
    """Final norm and head; logits in float32."""
    x = rms_norm(x, p["final_norm"], eps)
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return (x @ w.to(x.dtype)).float()

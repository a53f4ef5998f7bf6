"""Decoder-only language models, the SSM family (Mamba2); port of
`repro.models.lm`.

One parameter spec and the serving entry points `prefill` and
`decode_step`.  The layers' parameters and caches are stacked along a
leading layer axis, as in the reference, and a Python loop walks that
axis in place of `lax.scan`.  The dense, MoE, hybrid and VLM families
raise `NotImplementedError` until their layers are ported (ROADMAP.md,
queue 1, item 11).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import ssm as ssm_lib
from .layers import embed_spec, embed_tokens, rms_norm, unembed
from .params import ParamDef, Spec, stack_spec


def _check_family(cfg: ArchConfig):
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet: its "
            "attention, MoE and dense layers come with the model-zoo "
            "slices (ROADMAP.md, queue 1, item 11)")


def _layer_kinds(cfg: ArchConfig):
    """Per-layer (mixer, ffn) kinds of the stack."""
    _check_family(cfg)
    return [("mamba", "none")]


def block_spec(cfg: ArchConfig, mixer: str, ffn: str) -> Spec:
    if (mixer, ffn) != ("mamba", "none"):
        raise NotImplementedError(
            f"({mixer}, {ffn}) blocks are not ported yet (ROADMAP.md, "
            "queue 1, item 11)")
    d = cfg.d_model
    return {"norm1": ParamDef((d,), ("embed",), init="ones"),
            "mixer": ssm_lib.ssm_spec(cfg)}


def lm_spec(cfg: ArchConfig) -> Spec:
    (kind,) = _layer_kinds(cfg)
    return {"embed": embed_spec(cfg),
            "blocks": stack_spec(block_spec(cfg, *kind), cfg.n_layers,
                                 "layers")}


def _apply_block(cfg: ArchConfig, p, x, cache, mode: str,
                 interpret: bool = False):
    """Pre-norm mixer block with its residual (no FFN in the SSM family)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mode == "decode":
        y, new_cache = ssm_lib.ssm_decode_step(cfg, p["mixer"], h, cache)
    else:
        y, new_cache = ssm_lib.ssm_apply(cfg, p["mixer"], h, cache,
                                         interpret=interpret)
    return x + y, new_cache


def _layer(tree, i: int):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _run_stack(cfg: ArchConfig, blocks_p, x, caches, mode: str,
               interpret: bool = False):
    """Walk the stacked layer axis; returns (x, caches stacked anew)."""
    convs, hs = [], []
    for i in range(cfg.n_layers):
        cache_l = ssm_lib.SSMCache(caches.conv[i], caches.h[i])
        x, new = _apply_block(cfg, _layer(blocks_p, i), x, cache_l, mode,
                              interpret)
        convs.append(new.conv)
        hs.append(new.h)
    return x, ssm_lib.SSMCache(torch.stack(convs), torch.stack(hs))


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device=None):
    """Stacked per-layer caches [L, batch, …]: the conv state in `dtype`,
    the SSM state in float32.  `max_seq` is unused by the SSM family."""
    _check_family(cfg)
    one = ssm_lib.init_ssm_cache(cfg, batch, dtype, device)
    return ssm_lib.SSMCache(
        *(t[None].expand((cfg.n_layers,) + t.shape).contiguous()
          for t in one))


def prefill(cfg: ArchConfig, params, tokens, max_seq: int, caches=None,
            interpret: bool = False):
    """Prompt processing; writes the SSM caches (bfloat16 conv state
    unless `caches` are given).  Returns (logits_last [B,vocab], caches,
    seq_len)."""
    x = embed_tokens(params["embed"], tokens)
    B, S, _ = x.shape
    if caches is None:
        caches = init_caches(cfg, B, max_seq, device=x.device)
    x, caches = _run_stack(cfg, params["blocks"], x, caches, "prefill",
                           interpret)
    logits = unembed(cfg, params["embed"], x[:, -1:], cfg.norm_eps)
    return logits[:, 0], caches, S


def decode_step(cfg: ArchConfig, params, token, pos, caches):
    """One decode step.  token [B,1] int; `pos` (the shared position) is
    not read by the SSM family.  Returns (logits [B,vocab], new_caches)."""
    x = embed_tokens(params["embed"], token)
    x, caches = _run_stack(cfg, params["blocks"], x, caches, "decode")
    logits = unembed(cfg, params["embed"], x, cfg.norm_eps)
    return logits[:, 0], caches

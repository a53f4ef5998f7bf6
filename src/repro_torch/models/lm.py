"""Decoder-only language models, the SSM (Mamba2), dense, MoE, hybrid
(Jamba) and VLM (Qwen2-VL) families; port of `repro.models.lm`.

One parameter spec and the entry points `forward_hidden`,
`forward_train` and `lm_loss` (the training objective, which scoring
runs without grad), `prefill` and
`decode_step` (serving).  The layers' parameters and caches are stacked
along a leading layer axis, as in the reference, and a Python loop walks
that axis in place of `lax.scan`; the MoE layers' aux losses are summed
over it, as the scan's carry does.  The hybrid family stacks one period
of `attn_period` sub-layers (``{"sub0": block, …}``, attention at
`attn_offset`, MoE where ``i % moe_period == 1``) over
``n_layers // attn_period`` periods; the loop walks the periods and,
inside each, the sub-layers, and its caches are a dict of per-sub-layer
caches, each stacked over the periods.  Prefill and decode drop the aux
loss, as the reference does, so there the router does not compute it.
Under grad mode `forward_hidden` wraps each layer, or each period of the
hybrid, in `_remat` (the reference wraps its scan body): `cfg.remat`
"full" recomputes it in the backward pass, "dots" saves only the matrix
products without batch dimensions, "none" saves everything; scoring and
serving run no remat.  The VLM is the dense stack with M-RoPE and an
optional prefix of precomputed vision embeddings (`extra_embeds`,
prepended to the token embeddings; no loss on it); its three position
streams are the same stream, as the reference builds them
(`_positions3`).  The audio family is `encdec`'s.

Under a tensor-parallel axis (`sharding.tp`; `base_rules`,
`decode_32k`'s layout or `sequence_parallel_rules` with "model" larger
than 1) every entry point holds the residual stream as this rank's block
of `act_embed`: each block gathers it before its norm, and the mixer's
and the FFN's outputs go back to the block (`tp.out`: a reduce-scatter
of partial sums, the block of the partial sums all-reduced over the
mixer's second axis, "data" under `sequence_parallel_rules`, or the
block of a whole sum where the rules put the mixer on no wide axis). A
mixer on a second axis takes its input through `tp.enter`. Prefill and
decode take this rank's blocks of the caches (`Model.init_caches(...,
shardings=)`) and the caches' global K/V length (`max_seq`), which tells
a block of the sequence from a whole one; the logits are gathered whole
on every rank (`layers.unembed`). Under `fsdp_rules` each layer's
parameters, and the embedding's at each use, are gathered over the data
axes inside the remat'd layer (`tp.fsdp_gather`).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig
from ..sharding import tp as tpl
from ..sharding.axes import shard
from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (chunked_ce, embed_spec, embed_tokens, mlp_apply,
                     mlp_spec, rms_norm, unembed)
from .params import ParamDef, Spec, stack_spec


def _layer_kinds(cfg: ArchConfig):
    """Per-layer (mixer, ffn) kinds for one period (hybrid) or the whole
    stack (homogeneous)."""
    if cfg.family == "ssm":
        return [("mamba", "none")]
    if cfg.family == "hybrid":
        return [("attn" if i == cfg.attn_offset else "mamba",
                 "moe" if cfg.moe_period and i % cfg.moe_period == 1
                 else "mlp")
                for i in range(cfg.attn_period)]
    if cfg.family in ("dense", "moe", "vlm"):
        return [("attn", "moe" if cfg.is_moe else "mlp")]
    raise ValueError(f"{cfg.name} is of the {cfg.family} family, which is "
                     "not a decoder-only stack (the encoder-decoder is "
                     "models.encdec's)")


def _period(cfg: ArchConfig):
    """[(key, mixer, ffn)] of the layers of one step of the stack: the
    homogeneous families' one layer (key None: its parameters and caches
    are the stack's own leaves), or the hybrid's sub-layers ``sub{i}``."""
    kinds = _layer_kinds(cfg)
    if len(kinds) == 1:
        return [(None, *kinds[0])]
    return [(f"sub{i}", m, f) for i, (m, f) in enumerate(kinds)]


def _sub(tree, key):
    return tree if key is None else tree[key]


def block_spec(cfg: ArchConfig, mixer: str, ffn: str) -> Spec:
    d = cfg.d_model
    s: Spec = {"norm1": ParamDef((d,), ("embed",), init="ones")}
    s["mixer"] = attn.attn_spec(cfg) if mixer == "attn" else \
        ssm_lib.ssm_spec(cfg)
    if ffn != "none":
        s["norm2"] = ParamDef((d,), ("embed",), init="ones")
        s["ffn"] = mlp_spec(cfg) if ffn == "mlp" else moe_lib.moe_spec(cfg)
    return s


def lm_spec(cfg: ArchConfig) -> Spec:
    kinds = _layer_kinds(cfg)
    if len(kinds) == 1:
        blocks = block_spec(cfg, *kinds[0])
    else:
        blocks = {f"sub{i}": block_spec(cfg, m, f)
                  for i, (m, f) in enumerate(kinds)}
    return {"embed": embed_spec(cfg),
            "blocks": stack_spec(blocks, cfg.n_layers // len(kinds),
                                 "layers")}


def _apply_block(cfg: ArchConfig, mixer: str, ffn: str, p, x, *,
                 positions=None, positions3=None, cache=None,
                 mode: str = "train", pos=None, max_seq=None,
                 interpret: bool = False):
    """Pre-norm mixer block with its residual, then the FFN and its
    residual (no FFN in the SSM family).  Returns (x, cache, aux): the
    MoE layer's aux loss in training mode, else None."""
    logical = "heads" if mixer == "attn" else "ssm_inner"
    h = tpl.enter(rms_norm(tpl.gather(x), p["norm1"], cfg.norm_eps), logical)
    new_cache = cache
    if mixer == "attn":
        if mode == "train":
            y = attn.attention(cfg, p["mixer"], h, positions, positions3,
                               interpret=interpret)
        elif mode == "prefill":
            y, new_cache = attn.prefill_attention(
                cfg, p["mixer"], h, positions, cache, positions3, max_seq)
        else:
            y, new_cache = attn.decode_attention(
                cfg, p["mixer"], h, pos, cache, positions3, max_seq)
    elif mode == "decode":
        y, new_cache = ssm_lib.ssm_decode_step(cfg, p["mixer"], h, cache)
    else:
        y, new_cache = ssm_lib.ssm_apply(cfg, p["mixer"], h, cache,
                                         interpret=interpret)
    x = x + tpl.out(y, logical)
    aux = None
    if ffn != "none":
        h = rms_norm(tpl.gather(x), p["norm2"], cfg.norm_eps)
        if ffn == "mlp":
            y = mlp_apply(cfg, p["ffn"], h)
        else:
            y, aux = moe_lib.moe_apply(cfg, p["ffn"], h,
                                       need_aux=mode == "train",
                                       interpret=interpret)
        x = x + tpl.out(y, "mlp" if ffn == "mlp" else "expert")
    return x, new_cache, aux


def _layer(tree, i: int):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _unstack(tree):
    """Per-layer views of a stacked tree, one `unbind` per leaf.  Under
    autograd its backward stacks the layers' gradients once, where
    indexing each layer (`_layer`) would give every layer's gradient the
    whole stacked shape, zero-filled, and sum them: L times the traffic
    of the stacked leaves."""
    per_leaf = {k: _unstack(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def _positions3(cfg: ArchConfig, positions):
    """M-RoPE's (t, h, w) streams [3,B,S]: `positions` three times, as the
    reference's `_positions3_default`; None without `mrope_sections`."""
    if cfg.mrope_sections is None:
        return None
    return positions[None].expand((3,) + tuple(positions.shape))


def _embed(cfg: ArchConfig, params, tokens, extra_embeds):
    """Token embeddings, after the prefix `extra_embeds` [B,Sv,d] cast to
    their type when given; under a tensor-parallel axis this rank's block
    of both."""
    x = embed_tokens(tpl.fsdp_gather(params["embed"], embed_spec(cfg)),
                     tokens, cfg.vocab)
    if extra_embeds is not None:
        tp = tpl.context()
        if tp is not None:
            extra_embeds = tp.block(extra_embeds)
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _layer_spec(cfg: ArchConfig) -> Spec:
    """One step of the stack's parameter spec: a layer, or the hybrid's
    period of sub-layers."""
    kinds = _layer_kinds(cfg)
    if len(kinds) == 1:
        return block_spec(cfg, *kinds[0])
    return {f"sub{i}": block_spec(cfg, m, f)
            for i, (m, f) in enumerate(kinds)}


def _run_stack(cfg: ArchConfig, blocks_p, x, caches, mode: str, pos=None,
               max_seq=None, interpret: bool = False):
    """Walk the stacked layer axis (the hybrid's periods, and each
    period's sub-layers) with caches; returns (x, caches).  The attention
    layers write K/V into the stacked caches in place (each layer's cache
    is a view of them); the SSM layers' new states are stacked anew.
    Under a tensor-parallel axis `x` and the caches are this rank's
    blocks and `max_seq` is the caches' global K/V length."""
    period = _period(cfg)
    if tpl.context() is None:
        max_seq = None          # one device: each cache's own length
    if mode == "prefill":
        positions = _positions(x)
        positions3 = _positions3(cfg, positions)
    else:
        positions = positions3 = None
        if cfg.mrope_sections is not None:
            positions3 = _positions3(cfg, torch.full(
                (x.shape[0], 1), pos, dtype=torch.int64, device=x.device))
    spec = _layer_spec(cfg)
    news = {key: [] for key, _, _ in period}
    for i in range(cfg.n_layers // len(period)):
        p_i = tpl.fsdp_gather(_layer(blocks_p, i), spec)
        for key, mixer, ffn in period:
            stacked = _sub(caches, key)
            cache_l = type(stacked)(*(t[i] for t in stacked))
            x, new, _ = _apply_block(cfg, mixer, ffn, _sub(p_i, key), x,
                                     positions=positions,
                                     positions3=positions3, cache=cache_l,
                                     mode=mode, pos=pos, max_seq=max_seq,
                                     interpret=interpret)
            news[key].append(new)
    out = {}
    for key, mixer, _ in period:
        stacked = _sub(caches, key)
        out[key] = stacked if mixer == "attn" else type(stacked)(
            *(torch.stack(ts) for ts in zip(*news[key])))
    return x, out[None] if None in out else out


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device=None):
    """Stacked per-layer caches [L, batch, …]: K/V in `dtype` (attention),
    or the conv state in `dtype` and the SSM state in float32 (`max_seq`
    is unused by the SSM layers).  The hybrid's are a dict of its
    sub-layers' caches, each stacked over the periods."""
    period = _period(cfg)
    n = cfg.n_layers // len(period)

    def stacked(mixer):
        if mixer == "attn":
            one = attn.init_cache(cfg, batch, max_seq, dtype, device)
        else:
            one = ssm_lib.init_ssm_cache(cfg, batch, dtype, device)
        return type(one)(*(t[None].expand((n,) + t.shape).contiguous()
                           for t in one))

    out = {key: stacked(mixer) for key, mixer, _ in period}
    return out[None] if None in out else out


def cache_axes(cfg: ArchConfig):
    """Logical axes of `init_caches`' output, the reference's tree: a
    `KVCache` or `SSMCache` of axes tuples, or the hybrid's dict of them
    by sub-layer."""
    def one(mixer):
        if mixer == "attn":
            kv = ("layers", "batch", "seq_kv", "kv_heads", "head_dim")
            return attn.KVCache(kv, kv)
        return ssm_lib.SSMCache(
            ("layers", "batch", "conv", None),
            ("layers", "batch", "ssm_heads", "head_dim", "ssm_state"))

    out = {key: one(mixer) for key, mixer, _ in _period(cfg)}
    return out[None] if None in out else out


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy, the counterpart of
    `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`: save the
    outputs of matrix products without batch dimensions, recompute the
    rest.  `x @ w` lowers to `aten.mm`; an einsum without batch axes
    ("bsd,dhk->bshk") to `aten.bmm` over a batch of one, while the
    attention and expert einsums are `bmm`s over heads, experts or token
    groups (a batch axis of size one, e.g. one MoE group, counts as
    none here)."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig, fn):
    """`fn` wrapped per `cfg.remat`; unchanged without grad mode."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_saveable))
    raise ValueError(f"unknown remat {cfg.remat!r}: none, full or dots")


def forward_hidden(cfg: ArchConfig, params, tokens, extra_embeds=None,
                   interpret: bool = False):
    """tokens [B,S] (inputs), `extra_embeds` [B,Sv,d] an optional
    multimodal prefix → (hidden [B,Sv+S,d], aux_loss: the MoE layers'
    sum, 0 without them; the hybrid's summed over each period's
    sub-layers, then over the periods, as the reference's scan does)."""
    period = _period(cfg)
    x = shard(_embed(cfg, params, tokens, extra_embeds), "batch", "seq",
              "act_embed")
    positions = _positions(x)
    positions3 = _positions3(cfg, positions)
    layer_spec = _layer_spec(cfg)

    def layers(x, p_l):
        p_l = tpl.fsdp_gather(p_l, layer_spec)
        total = None
        for key, mixer, ffn in period:
            x, _, aux = _apply_block(cfg, mixer, ffn, _sub(p_l, key), x,
                                     positions=positions,
                                     positions3=positions3, mode="train",
                                     interpret=interpret)
            if aux is not None:
                total = aux if total is None else total + aux
        return x, total

    layers = _remat(cfg, layers)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_l in _unstack(params["blocks"]):
        x, aux = layers(x, p_l)
        if aux is not None:
            total = total + aux
    return x, total


def forward_train(cfg: ArchConfig, params, tokens, extra_embeds=None,
                  interpret: bool = False):
    """Full-logits variant (tests / small models)."""
    x, aux = forward_hidden(cfg, params, tokens, extra_embeds, interpret)
    return unembed(cfg, params["embed"], x, cfg.norm_eps), aux


def lm_loss(cfg: ArchConfig, params, batch,
            interpret: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Causal LM loss via chunked CE (never materializes full logits).
    batch: {"tokens": [B,S]} (+ "vision_embeds" [B,Sv,d], the VLM's
    prefix, whose Sv positions get label −1).  Inputs keep the full length
    S; the last position's label is −1 (masked), as in the reference."""
    tokens = batch["tokens"].long()
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    extra = batch.get("vision_embeds")
    hidden, aux = forward_hidden(cfg, params, tokens, extra, interpret)
    if extra is not None:
        labels = F.pad(labels, (extra.shape[1], 0), value=-1)
    nll_sum, cnt = chunked_ce(cfg, tpl.fsdp_gather(params["embed"],
                                                   embed_spec(cfg)),
                              hidden, labels)
    denom = torch.clamp_min(cnt, 1)
    loss = nll_sum / denom
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "tokens": denom.to(torch.float32)}


def prefill(cfg: ArchConfig, params, tokens, max_seq: int,
            extra_embeds=None, caches=None, interpret: bool = False):
    """Prompt processing, after the prefix `extra_embeds` [B,Sv,d] when
    given; writes the caches (K/V, or the SSM state with a bfloat16 conv
    state, unless `caches` are given: under a tensor-parallel axis this
    rank's blocks of caches of `max_seq` positions).  Returns
    (logits_last [B,vocab], caches, seq_len = Sv + S)."""
    x = _embed(cfg, params, tokens, extra_embeds)
    B, S, _ = x.shape
    if caches is None:
        caches = init_caches(cfg, B, max_seq, device=x.device)
    x, caches = _run_stack(cfg, params["blocks"], x, caches, "prefill",
                           max_seq=max_seq, interpret=interpret)
    logits = unembed(cfg, tpl.fsdp_gather(params["embed"], embed_spec(cfg)),
                     x[:, -1:], cfg.norm_eps)
    return logits[:, 0], caches, S


def decode_step(cfg: ArchConfig, params, token, pos, caches,
                interpret: bool = False, max_seq=None):
    """One decode step.  token [B,1] int; `pos` the shared current index
    (not read by the SSM family); `max_seq` the caches' global K/V length
    under a tensor-parallel axis (default: this rank's).  Returns
    (logits [B,vocab], new_caches)."""
    x = _embed(cfg, params, token, None)
    x, caches = _run_stack(cfg, params["blocks"], x, caches, "decode",
                           pos=int(pos), max_seq=max_seq,
                           interpret=interpret)
    logits = unembed(cfg, tpl.fsdp_gather(params["embed"], embed_spec(cfg)),
                     x, cfg.norm_eps)
    return logits[:, 0], caches

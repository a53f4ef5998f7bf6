"""Model facade (port of `repro.models.api`), every family: the
decoder-only stacks of `lm` (SSM, dense, MoE, hybrid, VLM) and the
encoder-decoder of `encdec` (audio).

`Model(cfg, device)` exposes
    spec / init / n_params / param_axes
    loss(params, batch) → (loss, metrics)                 — training objective
    prefill(params, batch, max_seq) → (logits, caches)   — prompt phase
    decode_step(params, token, pos, caches)               — decode phase
    init_caches / cache_axes
`param_axes` and `cache_axes` are the logical-axes trees that the rule
sets of `sharding.axes` map onto a mesh.  `interpret=True` makes every
kernel on the path run its plain PyTorch version, on whatever device;
the card's comparison run uses it.

Under a model mesh (`axes.use_rules(rules, mesh)`, one process per rank)
`init(..., shardings=param_shardings(mesh, rules))` gives each rank its
blocks as DTensors, and `loss`, `prefill` and `decode_step` run the
decoder-only families under tensor, expert and FSDP parallelism on them
(`sharding.tp`); each checks the layout first (`check_layout`).  There
`batch` and `token` are this rank's rows of the global batch (its block
on the rules' batch axes), the logits are those rows' whole logits, and
the caches are DTensors of this rank's blocks under
`cache_shardings(batch, max_seq, mesh, rules)` (`init_caches(...,
shardings=)`; `prefill` makes them): their global shapes tell `lm` the
K/V length.  Under `sequence_parallel_rules` with "data" > 1 every rank
holds every row, and a K/V block is [B, S/M, Hk/D, hd], an SSM state
block [B, H/D, P, N].
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..sharding import axes as ax
from ..sharding import ranks
from . import encdec, lm
from .params import axes_tree, init_params, leaves, n_params


class Model:
    def __init__(self, cfg: ArchConfig, device="cuda",
                 interpret: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.interpret = interpret
        self.is_encdec = cfg.family == "audio"
        self.spec = (encdec.encdec_spec(cfg) if self.is_encdec
                     else lm.lm_spec(cfg))

    # --- parameters ---
    def init(self, generator: torch.Generator, dtype=torch.bfloat16,
             shardings=None):
        """The parameters drawn from `generator`; with `shardings` (a
        tree of `NamedSharding`, `param_shardings`) each leaf a DTensor
        of this rank's block, the same numbers as one device's."""
        return init_params(self.spec, generator, dtype, self.device,
                           shardings)

    def param_axes(self):
        return axes_tree(self.spec)

    def param_shardings(self, mesh, rules: ax.Rules):
        """Each leaf's `NamedSharding` under `rules`, a mapping dropped
        where it does not divide the leaf (`tree_shardings_matched`)."""
        return ax.tree_shardings_matched(self.param_axes(), self.spec, mesh,
                                         rules)

    def check_layout(self, rules: ax.Rules, mesh):
        """Raise `NotImplementedError` for a layout of this model that the
        port does not run: the sequence on a wide axis, or model-parallel
        axes where `axes.check_ported` refuses them, and the
        encoder-decoder under any layout that shards more than the
        batch."""
        logical = {a for _, p in leaves(self.spec) for a in p.axes}
        logical |= {"batch", "seq", "seq_kv", "act_embed"}
        ax.check_ported(rules, mesh, sorted(a for a in logical if a))
        if self.is_encdec:
            sizes = ax.axis_sizes(mesh)
            wide = [k for k in logical if k and k != "batch" and any(
                sizes.get(a, 1) > 1 for a in ax._names(rules.get(k)))]
            if wide:
                raise NotImplementedError(
                    f"the encoder-decoder with {sorted(wide)} on a wide "
                    f"axis (its 'embed' residual) comes in {ax.NEXT_SLICE}")

    def n_params(self) -> int:
        return n_params(self.spec)

    # --- training and scoring ---
    def loss(self, params, batch):
        """The training objective (`lm.lm_loss`, or `encdec.encdec_loss`
        on {"frames", "tokens"}).  With `use_flash_kernel` off (the
        default, as the reference trains) it has a gradient, and
        `cfg.remat` applies under grad mode.  With the flag on, the causal
        self-attention, the SSD scan and the MoE router run their kernels,
        none of which has a gradient: their ops raise under grad mode, so
        score under `torch.no_grad()`.  Under active rules and a mesh
        `params` may be DTensors (`init(..., shardings=)`): their local
        blocks are used."""
        params, _, _ = self._on_mesh(params)
        if self.is_encdec:
            return encdec.encdec_loss(self.cfg, params, batch,
                                      interpret=self.interpret)
        return lm.lm_loss(self.cfg, params, batch, interpret=self.interpret)

    def _on_mesh(self, params):
        """(params as this rank's blocks, the active rules and mesh) after
        checking the layout; (params, None, None) without them."""
        rules, mesh = ax.get_rules(), ax.get_mesh()
        if rules is None or mesh is None:
            return params, None, None
        self.check_layout(rules, mesh)
        return local_blocks(params), rules, mesh

    # --- serving ---
    def prefill(self, params, batch, max_seq: int):
        """The prompt phase: `batch["tokens"]` after the VLM's optional
        `batch["vision_embeds"]`, or, for the encoder-decoder,
        `batch["frames"]` encoded and `batch["tokens"]` the decoder's
        prompt (its caches span `dec_max_seq`, not `max_seq`)."""
        params, rules, mesh = self._on_mesh(params)
        if self.is_encdec:
            return encdec.serve_prefill(self.cfg, params, batch["frames"],
                                        batch["tokens"])
        caches = None
        if mesh is not None:
            _, n = ranks.axis_group(mesh, ax.batch_axes(rules))
            rows = batch["tokens"].shape[0] * n
            caches = self.init_caches(rows, max_seq, shardings=(
                self.cache_shardings(rows, max_seq, mesh, rules)))
        logits, new, _ = lm.prefill(self.cfg, params, batch["tokens"],
                                    max_seq, batch.get("vision_embeds"),
                                    caches=local_blocks(caches),
                                    interpret=self.interpret)
        return logits, like_blocks(new, caches)

    def decode_step(self, params, token, pos, caches):
        params, _, _ = self._on_mesh(params)
        if self.is_encdec:
            return encdec.serve_decode_step(self.cfg, params, token, pos,
                                            caches)
        logits, new = lm.decode_step(self.cfg, params, token, pos,
                                     local_blocks(caches),
                                     interpret=self.interpret,
                                     max_seq=_kv_len(caches))
        return logits, like_blocks(new, caches)

    def init_caches(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                    shardings=None):
        """Zero caches; for the encoder-decoder `max_seq` is the encoder's
        length (the cross K/V), as the reference passes it.  With
        `shardings` (`cache_shardings`) each leaf a DTensor of this
        rank's block."""
        if self.is_encdec:
            if shardings is not None:
                raise NotImplementedError(
                    f"the encoder-decoder's caches over a mesh come in "
                    f"{ax.NEXT_SLICE}")
            return encdec.init_dec_caches(self.cfg, batch, max_seq, dtype,
                                          self.device)
        if shardings is None:
            return lm.init_caches(self.cfg, batch, max_seq, dtype,
                                  self.device)
        shapes = lm.init_caches(self.cfg, batch, max_seq, dtype, "meta")
        return ax.map_axes(lambda _, s, t: s.distribute(torch.zeros(
            t[s.block(t.shape)].shape, dtype=t.dtype, device=self.device),
            t.shape), self.cache_axes(), shardings, shapes)

    def cache_axes(self):
        if self.is_encdec:
            return encdec.dec_cache_axes(self.cfg)
        return lm.cache_axes(self.cfg)

    def cache_shardings(self, batch: int, max_seq: int, mesh,
                        rules: ax.Rules, dtype=torch.bfloat16):
        """Each cache leaf's `NamedSharding` under `rules`, a mapping
        dropped where it does not divide the leaf, as the reference's
        dry-run shards its caches (`tree_shardings_matched`)."""
        shapes = lm.init_caches(self.cfg, batch, max_seq, dtype, "meta")
        return ax.tree_shardings_matched(self.cache_axes(), shapes, mesh,
                                         rules)


def build_model(cfg: ArchConfig, device="cuda",
                interpret: bool = False) -> Model:
    return Model(cfg, device, interpret)


def local_blocks(tree):
    """`tree` (dicts and NamedTuples walked) with each DTensor leaf
    replaced by its local block (the same storage) and the other leaves
    as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: local_blocks(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(local_blocks(v) for v in tree))
    if isinstance(tree, DTensor):
        with torch.no_grad():
            return tree.to_local()
    return tree


def like_blocks(tree, like):
    """`tree`'s leaves, local blocks, as DTensors placed as `like`'s (the
    same structure); `tree` as it is where `like` is None or holds plain
    tensors."""
    from torch.distributed.tensor import DTensor
    if isinstance(like, dict):
        return {k: like_blocks(tree[k], v) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(like_blocks(a, b) for a, b in zip(tree, like)))
    if isinstance(like, DTensor):
        return DTensor.from_local(tree, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())
    return tree


def _kv_len(caches):
    """The global sequence length of the first K/V cache in `caches`
    (stacked [L, B, Smax, …]), None without one."""
    if isinstance(caches, dict):
        lens = [_kv_len(v) for v in caches.values()]
        return next((n for n in lens if n is not None), None)
    if isinstance(caches, lm.attn.KVCache):
        return caches.k.shape[2]
    return None

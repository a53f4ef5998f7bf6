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
blocks as DTensors, and `loss` runs the decoder-only families under
tensor, expert and FSDP parallelism on them (`sharding.tp`); it checks
the layout first (`check_layout`).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..sharding import axes as ax
from ..sharding import tp as tpl
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
        port does not run: sequence parallelism and the SSM mixers on a
        wide axis (`axes.check_ported`), and the encoder-decoder under
        any layout that shards more than the batch."""
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
        tpl.tp_axis(rules, mesh)

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
        rules, mesh = ax.get_rules(), ax.get_mesh()
        if rules is not None and mesh is not None:
            self.check_layout(rules, mesh)
            params = local_blocks(params)
        if self.is_encdec:
            return encdec.encdec_loss(self.cfg, params, batch,
                                      interpret=self.interpret)
        return lm.lm_loss(self.cfg, params, batch, interpret=self.interpret)

    # --- serving ---
    def prefill(self, params, batch, max_seq: int):
        """The prompt phase: `batch["tokens"]` after the VLM's optional
        `batch["vision_embeds"]`, or, for the encoder-decoder,
        `batch["frames"]` encoded and `batch["tokens"]` the decoder's
        prompt (its caches span `dec_max_seq`, not `max_seq`)."""
        if self.is_encdec:
            return encdec.serve_prefill(self.cfg, params, batch["frames"],
                                        batch["tokens"])
        logits, caches, _ = lm.prefill(self.cfg, params, batch["tokens"],
                                       max_seq, batch.get("vision_embeds"),
                                       interpret=self.interpret)
        return logits, caches

    def decode_step(self, params, token, pos, caches):
        if self.is_encdec:
            return encdec.serve_decode_step(self.cfg, params, token, pos,
                                            caches)
        return lm.decode_step(self.cfg, params, token, pos, caches,
                              interpret=self.interpret)

    def init_caches(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        """Zero caches; for the encoder-decoder `max_seq` is the encoder's
        length (the cross K/V), as the reference passes it."""
        if self.is_encdec:
            return encdec.init_dec_caches(self.cfg, batch, max_seq, dtype,
                                          self.device)
        return lm.init_caches(self.cfg, batch, max_seq, dtype, self.device)

    def cache_axes(self):
        if self.is_encdec:
            return encdec.dec_cache_axes(self.cfg)
        return lm.cache_axes(self.cfg)


def build_model(cfg: ArchConfig, device="cuda",
                interpret: bool = False) -> Model:
    return Model(cfg, device, interpret)


def local_blocks(tree):
    """`tree` with each DTensor leaf replaced by its local block (the same
    storage) and the other leaves as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: local_blocks(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        with torch.no_grad():
            return tree.to_local()
    return tree

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
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import encdec, lm
from .params import axes_tree, init_params, n_params


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
    def init(self, generator: torch.Generator, dtype=torch.bfloat16):
        return init_params(self.spec, generator, dtype, self.device)

    def param_axes(self):
        return axes_tree(self.spec)

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
        score under `torch.no_grad()`."""
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

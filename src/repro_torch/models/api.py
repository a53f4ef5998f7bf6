"""Model facade (port of `repro.models.api`), the SSM, dense, MoE and
hybrid families.

`Model(cfg, device)` exposes
    spec / init / n_params
    loss(params, batch) → (loss, metrics)                 — training objective
    prefill(params, batch, max_seq) → (logits, caches)   — prompt phase
    decode_step(params, token, pos, caches)               — decode phase
    init_caches
`interpret=True` makes every kernel on the path run its plain PyTorch
version, on whatever device; the card's comparison run uses it.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import lm
from .params import init_params, n_params


class Model:
    def __init__(self, cfg: ArchConfig, device="cuda",
                 interpret: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.interpret = interpret
        self.spec = lm.lm_spec(cfg)

    # --- parameters ---
    def init(self, generator: torch.Generator, dtype=torch.bfloat16):
        return init_params(self.spec, generator, dtype, self.device)

    def n_params(self) -> int:
        return n_params(self.spec)

    # --- training and scoring ---
    def loss(self, params, batch):
        """The training objective (`lm.lm_loss`).  With
        `use_flash_kernel` off (the default, as the reference trains) it
        has a gradient, and `cfg.remat` applies under grad mode.  With
        the flag on, the dense attention, the SSD scan and the MoE router
        run their kernels, none of which has a gradient: their ops raise
        under grad mode, so score under `torch.no_grad()`."""
        return lm.lm_loss(self.cfg, params, batch, interpret=self.interpret)

    # --- serving ---
    def prefill(self, params, batch, max_seq: int):
        logits, caches, _ = lm.prefill(self.cfg, params, batch["tokens"],
                                       max_seq, interpret=self.interpret)
        return logits, caches

    def decode_step(self, params, token, pos, caches):
        return lm.decode_step(self.cfg, params, token, pos, caches,
                              interpret=self.interpret)

    def init_caches(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        return lm.init_caches(self.cfg, batch, max_seq, dtype, self.device)


def build_model(cfg: ArchConfig, device="cuda",
                interpret: bool = False) -> Model:
    return Model(cfg, device, interpret)

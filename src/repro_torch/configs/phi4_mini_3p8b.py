"""phi4-mini-3.8b — RoPE + SwiGLU + GQA [arXiv:2412.08905].
(Copy of `repro.configs.phi4_mini_3p8b`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064,
    act="swiglu", rope_theta=1e4,
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                   d_ff=192, vocab=512, remat="none")

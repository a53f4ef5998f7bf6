"""qwen3-14b — Qwen3 dense, qk-norm + GQA [hf:Qwen/Qwen3-8B family].
(Copy of `repro.configs.qwen3_14b`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128,
    qk_norm=True, act="swiglu", rope_theta=1e6,
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                   d_ff=160, vocab=512, head_dim=16, remat="none")

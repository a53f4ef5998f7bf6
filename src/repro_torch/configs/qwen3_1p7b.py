"""qwen3-1.7b — Qwen3 dense with qk-norm + GQA [hf:Qwen/Qwen3-8B family].
(Copy of `repro.configs.qwen3_1p7b`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, head_dim=128,
    qk_norm=True, act="swiglu", rope_theta=1e6,
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=512, head_dim=16, remat="none")

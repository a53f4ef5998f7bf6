"""moonshot-v1-16b-a3b — Moonlight-16B-A3B-style MoE
[hf:moonshotai/Moonlight-16B-A3B].  64 experts, top-6, GQA kv=16 (=MHA at
16 heads).  d_ff is the per-expert FF width.
(Copy of `repro.configs.moonshot_v1_16b_a3b`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, n_experts=64, top_k=6,
    qk_norm=False, act="swiglu", rope_theta=5e4,
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=96, vocab=512, n_experts=8, top_k=2, remat="none")

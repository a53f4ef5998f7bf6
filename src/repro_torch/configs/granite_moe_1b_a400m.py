"""granite-moe-1b-a400m — IBM Granite 3.0 1B-A400M MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base].  32 experts, top-8, GQA kv=8.
(Copy of `repro.configs.granite_moe_1b_a400m`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, n_experts=32, top_k=8,
    act="swiglu", rope_theta=1e4,
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=64, vocab=512, n_experts=4, top_k=2, remat="none")

"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE
16e top-2 [arXiv:2403.19887].  Attention at index 3 of each 8-layer period
(Jamba convention); MoE FFN on alternate layers.  The Mamba mixer uses the
Mamba2/SSD formulation (TPU adaptation, DESIGN.md §3) with Jamba's
d_state=16.
(Copy of `repro.configs.jamba_1p5_large_398b`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, n_experts=16, top_k=2,
    attn_period=8, attn_offset=3, moe_period=2,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
    act="swiglu", rope_theta=1e4, fsdp=True,
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=96, vocab=512, n_experts=4, top_k=2,
                   attn_period=4, attn_offset=1, moe_period=2,
                   ssm_state=8, ssm_headdim=16, remat="none")

"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191].  The vision
frontend is a STUB: the caller provides precomputed patch embeddings
(`vision_embeds`).  (Copy of `repro.configs.qwen2_vl_2b`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936,
    act="swiglu", rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    frontend="vision_stub", frontend_seq=256,
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=512, mrope_sections=(2, 3, 3),
                   frontend_seq=8, remat="none")

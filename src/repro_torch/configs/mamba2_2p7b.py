"""mamba2-2.7b — attention-free SSD (state-space duality)
[arXiv:2405.21060].  d_inner = 2·d_model = 5120, 80 heads × headdim 64,
d_state=128.  (Copy of `repro.configs.mamba2_2p7b`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=2, d_model=64, vocab=512,
                   ssm_state=16, ssm_headdim=16, remat="none")

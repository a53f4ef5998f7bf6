"""nemotron-4-15b — GQA + squared-ReLU MLP [arXiv:2402.16819].
(Copy of `repro.configs.nemotron_4_15b`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000,
    act="sq_relu", rope_theta=1e4,
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                   d_ff=256, vocab=512, remat="none")

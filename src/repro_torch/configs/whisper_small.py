"""whisper-small — encoder-decoder audio backbone [arXiv:2212.04356].
The conv frontend is a STUB: the caller provides precomputed frame
embeddings (`frames`); decoder context 448.  (Copy of
`repro.configs.whisper_small`.)"""
from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865,
    n_enc_layers=12, dec_max_seq=448,
    act="gelu", frontend="audio_stub",
)


def smoke_config() -> ArchConfig:
    return replace(CONFIG, n_layers=2, n_enc_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
                   dec_max_seq=32, remat="none")

"""Architecture configuration and registry (copy of `repro.configs.base`).

One `ArchConfig` describes any of the model families `repro` supports,
and the port runs all ten architectures of `ARCH_IDS` (modules
`repro_torch.configs.<id>`, each exposing `CONFIG`, the published
parameters, and `smoke_config()`).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple

ARCH_IDS = (
    "moonshot-v1-16b-a3b",
    "granite-moe-1b-a400m",
    "qwen3-1.7b",
    "qwen3-14b",
    "phi4-mini-3.8b",
    "nemotron-4-15b",
    "qwen2-vl-2b",
    "jamba-1.5-large-398b",
    "mamba2-2.7b",
    "whisper-small",
)
PORTED = ("mamba2-2.7b", "qwen3-1.7b", "qwen3-14b", "phi4-mini-3.8b",
          "nemotron-4-15b", "granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
          "jamba-1.5-large-398b", "qwen2-vl-2b", "whisper-small")

_MODULES = {a: a.replace("-", "_").replace(".", "p") for a in ARCH_IDS}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (Jamba-style)
    attn_period: int = 0         # one attention layer per `attn_period`
    attn_offset: int = 0         # index of the attention layer in a period
    moe_period: int = 0          # MoE FFN every `moe_period` layers

    # attention details
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, int, int]] = None  # M-RoPE (VLM)
    attn_logits_soft_cap: float = 0.0

    act: str = "swiglu"          # swiglu | sq_relu | gelu

    # encoder-decoder (Whisper)
    n_enc_layers: int = 0
    enc_max_seq: int = 0
    dec_max_seq: int = 448

    # modality frontend stub: input_specs() provides precomputed embeddings
    frontend: str = "none"       # none | vision_stub | audio_stub
    frontend_seq: int = 0        # vision/audio prefix length (train shapes)

    tie_embeddings: bool = False
    fsdp: bool = False          # shard params over data axes too (ZeRO-3)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "full"          # none | full | dots
    scan_layers: bool = True
    use_flash_kernel: bool = False   # the hand-written CUDA kernels

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0 and self.top_k > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid; see DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True   # all assigned archs have a decoder

    def n_params_estimate(self) -> int:
        """Rough parameter count (embeddings + blocks), for MODEL_FLOPS."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_attn = (self.n_heads + 2 * self.n_kv_heads) * self.hd * d + \
            self.n_heads * self.hd * d
        mlp_mats = 3 if self.act == "swiglu" else 2
        per_mlp = mlp_mats * d * self.d_ff
        per_moe = self.n_experts * per_mlp + d * self.n_experts
        per_mamba = (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads) * d \
            + self.d_inner * d
        if self.family == "ssm":
            body = L * per_mamba
        elif self.family == "hybrid":
            n_attn = L // max(self.attn_period, 1)
            n_moe = L // max(self.moe_period, 1)
            body = (n_attn * per_attn + (L - n_attn) * per_mamba
                    + n_moe * per_moe + (L - n_moe) * per_mlp)
        else:
            n_enc = self.n_enc_layers
            ffn = per_moe if self.is_moe else per_mlp
            body = L * (per_attn + ffn)
            body += n_enc * (per_attn + per_mlp)      # encoder stack
            body += self.n_layers * per_attn * (1 if n_enc else 0)  # cross-attn
        return emb + body

    def active_params_estimate(self) -> int:
        if not (self.is_moe or self.is_hybrid):
            return self.n_params_estimate()
        cfg_active = replace(self, n_experts=self.top_k)
        return cfg_active.n_params_estimate()


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown architecture {arch_id!r}; known: "
                       f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke_config()

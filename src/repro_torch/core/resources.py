"""Multi-resource demand vectors (paper §4.1, Appendix C.1).

Each deployment unit r carries a demand vector
    d_r = (P_r [kW], CFM_r [air], LPM_r [liquid], n_r [tiles])
with 165 CFM/kW for air cooling and 2 LPM per rack for direct-to-chip
liquid cooling.  GPU racks keep `GPU_AIR_FRACTION` of their power
air-cooled; general-compute and storage racks have LPM_r = 0.

The counterpart of `repro.core.resources`, on tensors.
"""
from __future__ import annotations

import torch

# Resource dimension indices (paper §4.3: m ∈ {power, air, liquid, space}).
POWER, AIR, LIQ, TILES = 0, 1, 2, 3
N_RES = 4
RESOURCE_NAMES = ("power_kw", "air_cfm", "liquid_lpm", "tiles")

# Fixed conversions (paper §4.1, [OCP'23]).
AIR_CFM_PER_KW = 165.0
LIQ_LPM_PER_RACK = 2.0
# Fraction of a GPU rack's power that is air-cooled (networking, misc).
GPU_AIR_FRACTION = 0.10

# Hardware classes (paper §5.1).
CLASS_GPU, CLASS_COMPUTE, CLASS_STORAGE = 0, 1, 2
CLASS_NAMES = ("gpu", "compute", "storage")

# Availability tiers (paper §4.1).
TIER_HA, TIER_LA = 0, 1


def rack_demand(rack_kw: torch.Tensor, is_gpu: torch.Tensor) -> torch.Tensor:
    """Per-rack demand vector d_r = (kW, CFM, LPM, tiles), shape (..., 4).

    `rack_kw` is float32 and `is_gpu` bool, of broadcastable shapes; the
    float32 operations are the reference's, in its order."""
    rack_kw, is_gpu = torch.broadcast_tensors(rack_kw, is_gpu)
    one = torch.ones_like(rack_kw)
    air_frac = torch.where(is_gpu, one * GPU_AIR_FRACTION, one)
    air = AIR_CFM_PER_KW * rack_kw * air_frac
    liq = torch.where(is_gpu, one * LIQ_LPM_PER_RACK, torch.zeros_like(rack_kw))
    return torch.stack([rack_kw, air, liq, one], dim=-1)

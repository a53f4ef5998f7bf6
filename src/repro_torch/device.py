"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`; a CUDA device must exist.

    Entry points default to ``"cuda"`` and never fall back to the CPU on
    their own: a caller who wants the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def device_name(dev: torch.device) -> str:
    """What a result's `device` field records."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

"""`fused_gating`: the MoE router's entry to the gating kernel
(counterpart of `repro.kernels.moe_gating.ops.fused_gating`).

Logits are taken in float32, as the TPU kernel casts them; float64
raises rather than being narrowed quietly.  Tensors on a CUDA device
launch the kernel, or raise if it cannot be built or launched; tensors
on the CPU take the plain version (`ref.reference_gating`), as does
`interpret=True` on whatever device the tensor is on (the model's flag,
which the router passes through, as the other kernels' ops take it).
The reference's wrapper pads N to the TPU kernel's block; the CUDA
kernel takes any N.

There is no gradient: the reference kernel has no `custom_vjp`.  A
launch through `ctypes` is invisible to autograd, so the op raises, on
the card and on the CPU alike, whenever grad mode is on and the logits
require grad.
"""
from __future__ import annotations

import torch

from .kernel import gating_topk
from .ref import reference_gating


def fused_gating(logits, top_k: int, interpret: bool = False):
    """logits [N, E] → (gate [N, k] float32 renormalised, idx [N, k]
    int32), ids in descending order of probability, ties to the lowest
    index."""
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError(
            "fused_gating has no backward: the reference kernel "
            "(repro.kernels.moe_gating) defines no custom_vjp, so the port "
            "adds none; call it under torch.no_grad() or "
            "torch.inference_mode(), or set use_flash_kernel=False to "
            "differentiate the router")
    if logits.dtype == torch.float64:
        raise TypeError("fused_gating: logits are float64; the gating kernel "
                        "computes in float32. Cast them explicitly.")
    logits = logits.float()
    if interpret or logits.device.type == "cpu":
        return reference_gating(logits, top_k)
    return gating_topk(logits, top_k)

"""`flash_attention`: the dense models' entry to the flash-attention kernel
(counterpart of `repro.kernels.flash_attention.ops.flash_attention`).

It follows the reference wrapper step by step: swap BSHD to BHSD, pick
the blocks `min(block, max(8, next_pow2(S)))`, pad both sequences to
block multiples, pass the true key count as `kv_len`, and cut the padded
query rows off.  Tensors on a CUDA device launch the kernel, or raise if
it cannot be built or launched; tensors on the CPU take the reference's
function (`ref.reference_flash_bhsd`), as does `interpret=True` on
whatever device the tensors are on.  The bf16 kernel also rounds p to
bf16 before P·V, which the reference does not: its plain version with
that rounding is `ref.rounded_flash_bhsd`, which the checks on the card
use and no path calls.

There is no gradient: the reference kernel has no `custom_vjp`, and
`jax.grad` through it fails.  A launch through `ctypes` is invisible to
autograd, so a loss through it would get silently wrong gradients; the
op raises instead, on the card and on the CPU alike, whenever grad mode
is on and q, k or v requires grad.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import flash_attention_bhsd
from .ref import reference_flash_bhsd


def _pad_to(x, mult):
    """Pad axis 2 of a [B, H, S, hd] tensor to a multiple of `mult`."""
    pad = (-x.shape[2]) % mult
    return F.pad(x, (0, 0, 0, pad)).contiguous()


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, interpret: bool = False):
    """q: [B,S,H,hd]; k,v: [B,S,Hk,hd] (model layout).  Returns [B,S,H,hd]
    in q's type."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: the reference kernel "
            "(repro.kernels.flash_attention) defines no custom_vjp and "
            "jax.grad through it fails, so the port adds none; call it "
            "under torch.no_grad() or torch.inference_mode(), or set "
            "use_flash_kernel=False to differentiate")
    Sq, Skv = q.shape[1], k.shape[1]
    bq = min(block_q, max(8, 1 << (Sq - 1).bit_length()))
    bk = min(block_k, max(8, 1 << (Skv - 1).bit_length()))
    qt = _pad_to(q.transpose(1, 2), bq)
    kt = _pad_to(k.transpose(1, 2), bk)
    vt = _pad_to(v.transpose(1, 2), bk)
    if interpret or q.device.type == "cpu":
        out = reference_flash_bhsd(qt, kt, vt, causal=causal, kv_len=Skv,
                                   block_k=bk)
    else:
        out = flash_attention_bhsd(qt, kt, vt, causal=causal, kv_len=Skv,
                                   block_q=bq, block_k=bk)
    return out[:, :, :Sq].transpose(1, 2)

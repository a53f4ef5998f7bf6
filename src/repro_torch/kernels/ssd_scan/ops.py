"""`ssd_scan`: the Mamba2 mixer's entry to the SSD intra-chunk kernel.

It follows `repro.kernels.ssd_scan.ops.ssd_scan` step by step: pad the
sequence to a chunk multiple with identity steps (xdt = 0, log_a = 0),
run the intra-chunk pass once, carry the chunk states across chunks, add
their contribution and cut the padding off.  The intra-chunk pass also
returns its chunk-local prefix sums of log_a, which the inter-chunk term
reuses where the reference takes a cumsum again.  Tensors on a CUDA device
launch the kernel, or raise if it cannot be built or launched; tensors
on the CPU take the plain version (`ref.reference_intra_chunk`), as does
`interpret=True` on whatever device the tensors are on.

There is no gradient: the reference kernel has no `custom_vjp`, and
`jax.grad` through it fails.  A launch through `ctypes` is invisible to
autograd, so a loss through it would get silently wrong gradients; the
op raises instead, on the card and on the CPU alike, whenever grad mode
is on and an input requires grad (as `flash_attention` and
`fused_gating` do).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import ssd_intra_chunk
from .ref import reference_intra_chunk


def ssd_scan(xdt, log_a, b, c, chunk: int = 128, interpret: bool = False):
    """xdt [B,S,nh,hd]; log_a [B,S,nh] float32; b, c [B,S,st] →
    y [B,S,nh,hd] float32."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xdt, log_a, b, c)):
        raise RuntimeError(
            "ssd_scan has no backward: the reference kernel "
            "(repro.kernels.ssd_scan) defines no custom_vjp and jax.grad "
            "through it fails, so the port adds none; call it under "
            "torch.no_grad() or torch.inference_mode(), or set "
            "use_flash_kernel=False to differentiate")
    B, S, nh, hd = xdt.shape
    st = b.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        # F.pad counts axes from the last: pad only the sequence axis (1)
        zf = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xdt, log_a, b, c = zf(xdt), zf(log_a), zf(b), zf(c)
    Sp = S + pad
    nC = Sp // Q

    if interpret or xdt.device.type == "cpu":
        y_intra, h_chunk, a_chunk, acum = reference_intra_chunk(
            xdt, log_a, b, c, Q)
    else:
        y_intra, h_chunk, a_chunk, acum = ssd_intra_chunk(
            xdt.contiguous(), log_a.contiguous(), b.contiguous(),
            c.contiguous(), Q)

    # inter-chunk recurrence: the state entering each chunk
    h = torch.zeros((B, nh, hd, st), dtype=torch.float32, device=xdt.device)
    h_prevs = []
    for i in range(nC):
        h_prevs.append(h)
        h = h * a_chunk[:, i, :, None, None] + h_chunk[:, i]
    h_prevs = torch.stack(h_prevs, 1)                    # [B,nC,nh,hd,st]

    acum = acum.reshape(B, nC, Q, nh)
    y_inter = torch.einsum("bnqs,bnhds->bnqhd",
                           c.reshape(B, nC, Q, st).float(), h_prevs) * \
        torch.exp(acum)[..., None]
    y = y_intra.reshape(B, nC, Q, nh, hd) + y_inter
    return y.reshape(B, Sp, nh, hd)[:, :S]

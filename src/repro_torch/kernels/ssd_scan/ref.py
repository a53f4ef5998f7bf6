"""Plain PyTorch versions of the SSD scan.

`reference_ssd` is the independent oracle, the naive per-step recurrence
(`repro.kernels.ssd_scan.ref`).  `reference_intra_chunk` computes what
the intra-chunk kernel returns, with whole-tensor float32 ops in the
kernel's order of operations: the prefix sum step by step, C·B over the
state index, then y and the chunk state over the keys, each ascending.
That fixes every rounding, so on the card the kernel equals it bitwise,
which a library contraction (whose order is its own) would not allow.
"""
from __future__ import annotations

import torch


def reference_ssd(xdt, log_a, b, c):
    """xdt [B,S,nh,hd]; log_a [B,S,nh]; b, c [B,S,st] → y [B,S,nh,hd]
    float32 via h_t = e^{log_a_t}·h_{t-1} + xdt_t ⊗ b_t, y_t = h_t · c_t."""
    B, S, nh, hd = xdt.shape
    st = b.shape[-1]
    f32 = torch.float32
    h = torch.zeros((B, nh, hd, st), dtype=f32, device=xdt.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(log_a[:, t].to(f32))[..., None, None] + \
            torch.einsum("bhd,bs->bhds", xdt[:, t].to(f32), b[:, t].to(f32))
        ys.append(torch.einsum("bhds,bs->bhd", h, c[:, t].to(f32)))
    return torch.stack(ys, 1)


def reference_intra_chunk(xdt, log_a, b, c, chunk):
    """The kernel's function: S a multiple of `chunk`.  Returns (y_intra
    [B,S,nh,hd], h_chunk [B,nC,nh,hd,st], a_chunk [B,nC,nh]), float32."""
    B, S, nh, hd = xdt.shape
    st = b.shape[-1]
    Q = chunk
    nC = S // Q
    f32 = torch.float32
    dev = xdt.device
    x = xdt.reshape(B, nC, Q, nh, hd).to(f32)
    la = log_a.reshape(B, nC, Q, nh).to(f32)
    bb = b.reshape(B, nC, Q, st).to(f32)
    cc = c.reshape(B, nC, Q, st).to(f32)

    acum = [la[:, :, 0]]
    for q in range(1, Q):
        acum.append(acum[-1] + la[:, :, q])
    acum = torch.stack(acum, 2)                                # [B,nC,Q,nh]

    s_qk = torch.zeros((B, nC, Q, Q), dtype=f32, device=dev)
    for j in range(st):
        s_qk = s_qk + cc[:, :, :, None, j] * bb[:, :, None, :, j]
    gap = acum[:, :, :, None, :] - acum[:, :, None, :, :]      # [B,nC,Q,Q,nh]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    decay = torch.exp(torch.where(causal[:, :, None], gap, -1e9))
    w = s_qk[..., None] * decay                                # [B,nC,Q,Q,nh]
    y = torch.zeros((B, nC, Q, nh, hd), dtype=f32, device=dev)
    for k in range(Q):
        y = y + w[:, :, :, k, :, None] * x[:, :, None, k]

    tail = torch.exp(acum[:, :, -1:, :] - acum)                # [B,nC,Q,nh]
    xt = x * tail[..., None]
    h = torch.zeros((B, nC, nh, hd, st), dtype=f32, device=dev)
    for k in range(Q):
        h = h + xt[:, :, k, :, :, None] * bb[:, :, k, None, None, :]
    return y.reshape(B, S, nh, hd), h, torch.exp(acum[:, :, -1, :])

"""Plain PyTorch versions of the SSD scan.

`reference_ssd` is the independent oracle, the naive per-step recurrence
(`repro.kernels.ssd_scan.ref`).  `reference_intra_chunk` computes the
function the intra-chunk kernels compute, with whole-tensor float32 ops
in the CUDA-core kernel's order of operations: the prefix sum step by
step, C·B over the state index, then y and the chunk state over the
keys, each ascending.  That fixes every rounding, so on the card the
CUDA-core kernel equals it bitwise, which a library contraction (whose
order is its own) would not allow.  `interpret=True` and CPU tensors run
it.

`split_intra_chunk` is the tensor-core kernel's plain version: the same
serial prefix sums and decays, W = (C·B)·decay and tail·xdt each split
into bf16 hi and lo parts (`split_bf16`), and float32 sums over the hi
and lo terms together.  Its sums run in the library's order, not the
tensor cores', so the two agree within a derived bound (`chip_smoke.py`),
whose magnitudes `intra_chunk_majorants` gives.
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


def _chunked(xdt, log_a, b, c, chunk):
    """Inputs in float32 by chunk, and the chunk-local prefix sums of
    log_a taken step by step, in order: [B,nC,Q,nh]."""
    B, S, nh, hd = xdt.shape
    st = b.shape[-1]
    nC = S // chunk
    f32 = torch.float32
    x = xdt.reshape(B, nC, chunk, nh, hd).to(f32)
    la = log_a.reshape(B, nC, chunk, nh).to(f32)
    bb = b.reshape(B, nC, chunk, st).to(f32)
    cc = c.reshape(B, nC, chunk, st).to(f32)
    acum = [la[:, :, 0]]
    for q in range(1, chunk):
        acum.append(acum[-1] + la[:, :, q])
    return x, bb, cc, torch.stack(acum, 2)


def _decay(acum):
    """exp(acum_q − acum_k) for k ≤ q, else exp(−1e9) = 0: [B,nC,Q,Q,nh]."""
    Q = acum.shape[2]
    gap = acum[:, :, :, None, :] - acum[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=acum.device).tril()
    return torch.exp(torch.where(causal[:, :, None], gap, -1e9))


def reference_intra_chunk(xdt, log_a, b, c, chunk):
    """The kernels' function: S a multiple of `chunk`.  Returns (y_intra
    [B,S,nh,hd], h_chunk [B,nC,nh,hd,st], a_chunk [B,nC,nh], acum
    [B,S,nh]), float32."""
    B, S, nh, hd = xdt.shape
    st = b.shape[-1]
    Q = chunk
    nC = S // Q
    f32 = torch.float32
    dev = xdt.device
    x, bb, cc, acum = _chunked(xdt, log_a, b, c, Q)

    s_qk = torch.zeros((B, nC, Q, Q), dtype=f32, device=dev)
    for j in range(st):
        s_qk = s_qk + cc[:, :, :, None, j] * bb[:, :, None, :, j]
    w = s_qk[..., None] * _decay(acum)                         # [B,nC,Q,Q,nh]
    y = torch.zeros((B, nC, Q, nh, hd), dtype=f32, device=dev)
    for k in range(Q):
        y = y + w[:, :, :, k, :, None] * x[:, :, None, k]

    tail = torch.exp(acum[:, :, -1:, :] - acum)                # [B,nC,Q,nh]
    xt = x * tail[..., None]
    h = torch.zeros((B, nC, nh, hd, st), dtype=f32, device=dev)
    for k in range(Q):
        h = h + xt[:, :, k, :, :, None] * bb[:, :, k, None, None, :]
    return (y.reshape(B, S, nh, hd), h, torch.exp(acum[:, :, -1, :]),
            acum.reshape(B, S, nh))


def split_bf16(v):
    """float32 v → (hi, lo) in float32: hi = bf16(v), lo = bf16(v − hi),
    each rounded to nearest even; v − hi is exact, and hi + lo is v
    within 2⁻¹⁶·|v|."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def split_intra_chunk(xdt, log_a, b, c, chunk):
    """The tensor-core kernel's plain version: the outputs of
    `reference_intra_chunk` with W and tail·xdt split into bf16 hi and lo
    parts, y = Σ_k (W_hi + W_lo)·xdt_k and h = Σ_k ((tail·xdt)_hi +
    (tail·xdt)_lo) ⊗ B_k each one float32 sum over the 2Q terms, and C·B
    a float32 product; acum, the decays, the tails and a are bitwise the
    reference's."""
    B, S, nh, hd = xdt.shape
    Q = chunk
    x, bb, cc, acum = _chunked(xdt, log_a, b, c, Q)

    s_qk = cc @ bb.transpose(-1, -2)                           # [B,nC,Q,Q]
    w_hi, w_lo = split_bf16(s_qk[..., None] * _decay(acum))    # [B,nC,Q,Q,nh]
    w2 = torch.cat([w_hi, w_lo], 3).permute(0, 1, 4, 2, 3)     # [B,nC,nh,Q,2Q]
    x2 = torch.cat([x, x], 2).permute(0, 1, 3, 2, 4)           # [B,nC,nh,2Q,hd]
    y = (w2 @ x2).permute(0, 1, 3, 2, 4)                       # [B,nC,Q,nh,hd]

    tail = torch.exp(acum[:, :, -1:, :] - acum)
    xt_hi, xt_lo = split_bf16(x * tail[..., None])             # [B,nC,Q,nh,hd]
    xt2 = torch.cat([xt_hi, xt_lo], 2).permute(0, 1, 3, 4, 2)  # [B,nC,nh,hd,2Q]
    h = xt2 @ torch.cat([bb, bb], 2)[:, :, None]               # [B,nC,nh,hd,st]
    return (y.reshape(B, S, nh, hd), h, torch.exp(acum[:, :, -1, :]),
            acum.reshape(B, S, nh))


def intra_chunk_majorants(xdt, log_a, b, c, chunk):
    """The sum of the magnitudes of each output's terms, (y [B,S,nh,hd],
    h [B,nC,nh,hd,st]): Σ_{k≤q} (Σ_j |C_qj|·|B_kj|)·e^{A_q−A_k}·|xdt_k| and
    Σ_k e^{A_Q−A_k}·|xdt_k|·|B_k|, the reference function on |xdt|, |b|
    and |c|."""
    y, h, _, _ = reference_intra_chunk(xdt.abs(), log_a, b.abs(), c.abs(),
                                       chunk)
    return y, h


def split_coefficients(Q, st, nC=1, u=2.0 ** -22, split=2.0 ** -16,
                       majorant=1 + 2.0 ** -10):
    """Bounds on the tensor-core kernel's outputs, as multiples of
    `intra_chunk_majorants` (the derivation is in chip_smoke.py, beside
    SSD_SUM_U): `u` per float32 addition, `split` the relative error of
    hi + lo, `majorant` the slack of the float32 magnitude sums.  y and h
    against `split_intra_chunk` and against `reference_intra_chunk`, and
    "full": the scan through `ops.ssd_scan` against interpret=True, of
    the scan on |xdt|, |b| and |c|."""
    gamma = lambda n: n * u / (1 - n * u)
    Qp = -(-Q // 64) * 64
    hl = (1 + 2.0 ** -8) ** 2            # |hi| + |lo| over |v|
    grow = (1 + gamma(st)) * (1 + u) * majorant
    co = dict(
        y_split=(2 * gamma(st) + 2 * u + 2 * split + 2 * hl * gamma(2 * Qp))
        * grow,
        y_ref=(2 * gamma(st) + 2 * u + split + hl * gamma(2 * Qp)
               + gamma(Q)) * grow,
        h_split=2 * hl * gamma(2 * Qp) * (1 + u) * majorant,
        h_ref=(split + hl * gamma(2 * Qp) + gamma(Q)) * (1 + u) * majorant)
    co["full"] = max(co["y_ref"], co["h_ref"]) + 2 * gamma(st + nC + 2)
    return co

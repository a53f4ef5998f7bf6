"""Mamba2 mixer via SSD — state-space duality (arXiv:2405.21060); port of
`repro.models.ssm`.

The chunked SSD decomposition does the intra-chunk work as dense
contractions and carries the state across chunks with a short loop.  With
`cfg.use_flash_kernel` the intra-chunk pass is the hand-written CUDA
kernel (`repro_torch.kernels.ssd_scan`); otherwise `_ssd_chunked`, the
reference's plain path.  Types follow the reference: `xdt` is in the
parameters' type, `log_a` and the state `h` are float32, the conv state
is stored in the cache's type.

Layout: d_inner = expand·d_model = n_heads·head_dim; a single B/C group
shared across heads (the Mamba2 default).

Under a wide mesh axis that the rules put `ssm_heads` and `ssm_inner`
on (`sharding.tp` `axis_of`: "model" under `base_rules`, "data" under
`sequence_parallel_rules` with "data" > 1), each rank runs the mixer on
its range of the heads on that axis, [lo, hi) = `TP.range(n_heads)`,
and the d_inner columns [lo·hd, hi·hd) of z, x, the conv and the gate
(`_local_params`: the rules' block of a weight where it is that range,
else the whole weight narrowed, or the blocks all-gathered and narrowed
where `ssm_inner` divides over the axis and the heads do not); b and c,
whose weights every rule replicates, whole.  The gate's RMS norm is
over the whole d_inner: its mean square is the all-reduce over the axis
of the ranks' float32 sums of squares (`_gate_norm`).  The output
projection returns the rank's partial sum (`sharding.tp.out` takes it
back to the residual's block).  The caches: the state `h` is the rules'
block of the heads, [B, H/D, hd, st], or whole, gathered over the axis,
where they do not divide; the conv state, which every rule replicates,
is whole and bitwise equal on every rank, its x columns all-gathered
(the last K−1 rows at prefill, the new row a decode step).  Where the
rules put the SSM axes on no wide axis (`sequence_parallel_rules` with
"data" 1) every rank runs the whole mixer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssd_scan import ops as ssd_ops
from ..sharding import ranks
from ..sharding import tp as tpl
from .layers import rms_norm
from .params import ParamDef, Spec


def ssm_spec(cfg: ArchConfig) -> Spec:
    d, di, st, nh, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.ssm_heads, cfg.ssm_conv)
    return {
        "in_z": ParamDef((d, di), ("embed", "ssm_inner")),
        "in_x": ParamDef((d, di), ("embed", "ssm_inner")),
        "in_b": ParamDef((d, st), ("embed", "ssm_state")),
        "in_c": ParamDef((d, st), ("embed", "ssm_state")),
        "in_dt": ParamDef((d, nh), ("embed", "ssm_heads")),
        "conv_x": ParamDef((K, di), ("conv", "ssm_inner"), scale=0.5),
        "conv_b": ParamDef((K, st), ("conv", "ssm_state"), scale=0.5),
        "conv_c": ParamDef((K, st), ("conv", "ssm_state"), scale=0.5),
        "a_log": ParamDef((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((nh,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef((nh,), ("ssm_heads",), init="ones"),
        "gate_norm": ParamDef((di,), ("ssm_inner",), init="ones"),
        "out": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _silu(x):
    return x * torch.sigmoid(x)


def _softplus(x):
    """log(1 + e^x) as `jax.nn.softplus` forms it (logaddexp(x, 0))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, state=None):
    """Depthwise causal conv: x [B,S,F], w [K,F].  If `state` [B,K-1,F] is
    given (decode), convolves the concatenation and returns new state."""
    K = w.shape[0]
    pad = torch.zeros_like(x[:, : K - 1]) if state is None else state
    dtype = torch.result_type(pad, x)
    xp = torch.cat([pad.to(dtype), x.to(dtype)], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):]
    return _silu(out), new_state


def _ssd_chunked(xdt, log_a, b, c, chunk: int):
    """Chunked SSD scan (the plain path, `use_flash_kernel=False`).

    xdt: [B,S,nh,hd] (dt-scaled inputs);  log_a: [B,S,nh] (per-step log
    decay);  b, c: [B,S,st].  Returns y [B,S,nh,hd] float32.  As in the
    reference, C·B is formed in the inputs' type.
    """
    B, S0, nh, hd = xdt.shape
    st = b.shape[-1]
    Q = min(chunk, S0)
    pad = (-S0) % Q
    if pad:
        # identity steps (xdt=0, log_a=0) rather than a smaller chunk
        zf = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xdt, log_a, b, c = zf(xdt), zf(log_a), zf(b), zf(c)
    S = S0 + pad
    nC = S // Q
    rs = lambda t: t.reshape((B, nC, Q) + tuple(t.shape[2:]))
    xdt, log_a, b, c = rs(xdt), rs(log_a), rs(b), rs(c)
    f32 = torch.float32

    acum = torch.cumsum(log_a, dim=2)                      # [B,nC,Q,nh]
    s_qk = torch.einsum("bnqs,bnks->bnqk", c, b)           # [B,nC,Q,Q]
    gap = acum[:, :, :, None, :] - acum[:, :, None, :, :]  # [B,nC,Q,Q,nh]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    gap = torch.where(causal[None, None, :, :, None], gap, -1e9)
    decay = torch.exp(gap)
    w = s_qk[..., None].to(f32) * decay                    # [B,nC,Q,Q,nh]
    y_intra = torch.einsum("bnqkh,bnkhd->bnqhd", w, xdt.to(f32))

    # chunk summaries: H_n = Σ_k e^{A_Q−A_k} B_k ⊗ xdt_k   [B,nC,nh,hd,st]
    tail = torch.exp(acum[:, :, -1:, :] - acum)            # [B,nC,Q,nh]
    xtail = xdt.to(f32) * tail[..., None]                  # [B,nC,Q,nh,hd]
    h_chunk = torch.einsum("bnqhd,bnqs->bnhds", xtail, b.to(f32))
    a_chunk = torch.exp(acum[:, :, -1, :])                 # [B,nC,nh]

    h = torch.zeros((B, nh, hd, st), dtype=f32, device=xdt.device)
    h_prevs = []
    for i in range(nC):
        h_prevs.append(h)
        h = h * a_chunk[:, i, :, None, None] + h_chunk[:, i]
    h_prevs = torch.stack(h_prevs, 1)                      # [B,nC,nh,hd,st]

    y_inter = torch.einsum("bnqs,bnhds->bnqhd", c.to(f32), h_prevs) * \
        torch.exp(acum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    return y[:, :S0]


class SSMCache(NamedTuple):
    conv: torch.Tensor    # [B, K-1, di + 2·st]
    h: torch.Tensor       # [B, nh, hd, st] (float32)


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> SSMCache:
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    return SSMCache(
        torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * st), dtype=dtype,
                    device=device),
        torch.zeros((batch, nh, hd, st), dtype=torch.float32, device=device))


def _project(cfg: ArchConfig, p, x):
    z = x @ p["in_z"]
    xs = x @ p["in_x"]
    b = x @ p["in_b"]
    c = x @ p["in_c"]
    dt = _softplus((x @ p["in_dt"]).float() + p["dt_bias"])
    return z, xs, b, c, dt


def _plan(cfg: ArchConfig):
    """(the SSM mixers' wide axis, this rank's heads [lo, hi) on it) where
    the rules split them over one, else (None, (0, n_heads))."""
    tp = tpl.axis_of("ssm_heads") or tpl.axis_of("ssm_inner")
    if tp is None:
        return None, (0, cfg.ssm_heads)
    return tp, tp.range(cfg.ssm_heads)


def _local_params(cfg: ArchConfig, p, tp, lo: int, hi: int):
    """`p` with the head-indexed weights at heads [lo, hi) and the
    d_inner-indexed ones at its columns; b's and c's whole."""
    nh, hd = cfg.ssm_heads, cfg.ssm_headdim

    def cols(w, dim, size, a, b):
        if w.shape[dim] == size:            # replicated: narrow
            return w.narrow(dim, a, b - a)
        blk = size // tp.n                  # the rules' block
        if (tp.r * blk, (tp.r + 1) * blk) == (a, b):
            return w
        whole = ranks.all_gather(w, dim, tp.group, tp.n)
        return whole.narrow(dim, a, b - a)
    di, c_lo, c_hi = nh * hd, lo * hd, hi * hd
    out = dict(p)
    for k, dim in (("in_z", 1), ("in_x", 1), ("conv_x", 1),
                   ("gate_norm", 0), ("out", 0)):
        out[k] = cols(p[k], dim, di, c_lo, c_hi)
    for k, dim in (("in_dt", 1), ("a_log", 0), ("dt_bias", 0),
                   ("d_skip", 0)):
        out[k] = cols(p[k], dim, nh, lo, hi)
    return out


def _gate_norm(cfg: ArchConfig, tp, y, scale):
    """`rms_norm` over the whole d_inner of rows whose columns lie on the
    ranks: the float32 sums of squares all-reduced, with a gradient that
    sums the ranks' parts (`ranks.copy_to`: each rank uses the sum only
    for its own columns)."""
    if tp is None:
        return rms_norm(y, scale, cfg.norm_eps)
    x32 = y.float()
    sq = tp.all_reduce(torch.sum(x32 * x32, dim=-1, keepdim=True))
    var = ranks.copy_to(sq, tp.group, tp.n) / cfg.d_inner
    return (x32 * torch.rsqrt(var + cfg.norm_eps)).to(y.dtype) * scale


def _conv_local(cfg: ArchConfig, conv, c_lo: int, c_hi: int):
    """The conv state's columns of this rank: its x columns, then b, c."""
    di = cfg.d_inner
    if c_hi - c_lo == di:
        return conv
    return torch.cat([conv[..., c_lo:c_hi], conv[..., di:]], -1)


def _conv_whole(cfg: ArchConfig, tp, rows, n_x: int):
    """Conv-state rows of this rank's columns (its `n_x` x columns, then
    b, c) → every column, the x columns all-gathered over the axis."""
    if tp is None:
        return rows
    return torch.cat([tp.gather_ranges(rows[..., :n_x], -1, cfg.ssm_heads,
                                       cfg.ssm_headdim), rows[..., n_x:]],
                     -1)


def _state_local(cfg: ArchConfig, h, lo: int, hi: int):
    """The cache's SSM state at heads [lo, hi): the rules' block, or the
    whole state narrowed."""
    return h[:, lo:hi] if h.shape[1] == cfg.ssm_heads else h


def _state_out(cfg: ArchConfig, tp, h, held: int):
    """The new SSM state of this rank's heads, as the cache holds it: the
    block, or every head gathered over the axis."""
    if tp is None or h.shape[1] == held:
        return h
    return tp.gather_ranges(h, 1, cfg.ssm_heads)


def ssm_apply(cfg: ArchConfig, p, x, cache: SSMCache | None = None,
              interpret: bool = False):
    """Full-sequence Mamba2 mixer.  x: [B,S,d] → (y, new_cache or None);
    under a tensor-parallel axis x is the full rows and y this rank's
    partial sum over its heads.  `interpret=True` runs the kernel's plain
    version in its place."""
    B, S, d = x.shape
    st, hd = cfg.ssm_state, cfg.ssm_headdim
    tp, (lo, hi) = _plan(cfg)
    if tp is not None:
        p = _local_params(cfg, p, tp, lo, hi)
    nh, di = hi - lo, (hi - lo) * hd
    z, xs, b, c, dt = _project(cfg, p, x)
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], -1)
    feats = torch.cat([xs, b, c], -1)
    feats, conv_state = _causal_conv(
        feats, conv_w, _conv_local(cfg, cache.conv, lo * hd, hi * hd)
        if cache is not None else None)
    xs, b, c = torch.split(feats, [di, st, st], dim=-1)

    a = -torch.exp(p["a_log"].float())                     # [nh]
    log_a = dt * a                                         # [B,S,nh]
    xh = xs.reshape(B, S, nh, hd)
    xdt = xh * dt[..., None].to(xh.dtype)

    if cfg.use_flash_kernel:
        y = ssd_ops.ssd_scan(xdt, log_a, b, c, chunk=cfg.ssm_chunk,
                             interpret=interpret)
    else:
        y = _ssd_chunked(xdt, log_a, b, c, cfg.ssm_chunk)
    y = y + xh.float() * p["d_skip"].float()[:, None]
    y = y.reshape(B, S, di).to(x.dtype)

    y = _gate_norm(cfg, tp, y * _silu(z), p["gate_norm"])
    out = y @ p["out"]
    new_cache = None
    if cache is not None:
        # final ssm state for decode handoff
        h = _state_out(cfg, tp, _final_state(xdt, log_a, b),
                       cache.h.shape[1])
        conv = _conv_whole(cfg, tp, conv_state.to(cache.conv.dtype), di)
        new_cache = SSMCache(conv, h)
    return out, new_cache


def _final_state(xdt, log_a, b):
    """h_S = Σ_k e^{A_S−A_k} B_k ⊗ xdt_k   (float32, [B,nh,hd,st])."""
    acum = torch.cumsum(log_a, dim=1)                      # [B,S,nh]
    tail = torch.exp(acum[:, -1:, :] - acum)
    xtail = xdt.float() * tail[..., None]                  # [B,S,nh,hd]
    return torch.einsum("bqhd,bqs->bhds", xtail, b.float())


def ssm_decode_step(cfg: ArchConfig, p, x, cache: SSMCache):
    """Single-token recurrent update.  x: [B,1,d]; under a tensor-parallel
    axis as `ssm_apply`."""
    B = x.shape[0]
    st, hd = cfg.ssm_state, cfg.ssm_headdim
    tp, (lo, hi) = _plan(cfg)
    if tp is not None:
        p = _local_params(cfg, p, tp, lo, hi)
    nh, di = hi - lo, (hi - lo) * hd
    z, xs, b, c, dt = _project(cfg, p, x)
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], -1)
    feats = torch.cat([xs, b, c], -1)                      # [B,1,F]
    feats, conv_state = _causal_conv(
        feats, conv_w, _conv_local(cfg, cache.conv, lo * hd, hi * hd))
    xs, b, c = torch.split(feats, [di, st, st], dim=-1)

    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt[:, 0] * a)                           # [B,nh]
    xh = xs.reshape(B, nh, hd).float()
    xdt = xh * dt[:, 0][..., None]
    h = _state_local(cfg, cache.h, lo, hi) * da[..., None, None] + \
        torch.einsum("bhd,bs->bhds", xdt, b[:, 0].float())
    y = torch.einsum("bhds,bs->bhd", h, c[:, 0].float())
    y = y + xh * p["d_skip"].float()[:, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = _gate_norm(cfg, tp, y * _silu(z), p["gate_norm"])
    if tp is not None:          # the state's x columns, the new row
        conv_state = torch.cat([cache.conv[:, 1:], _conv_whole(
            cfg, tp, conv_state[:, -1:].to(cache.conv.dtype), di)], 1)
    return y @ p["out"], SSMCache(conv_state.to(cache.conv.dtype),
                                  _state_out(cfg, tp, h, cache.h.shape[1]))

"""Parity of the port's flash attention with `repro`'s.

Inputs come from numpy with fixed seeds and go through both packages.
On the CPU the port's `ops.flash_attention` runs the kernel's plain
version (`ref.reference_flash_bhsd`, tile by tile as `_flash_kernel`);
`repro` runs its Pallas kernel in interpret mode (the only mode its CPU
allows) and its oracle `reference_attention`.  Shapes are
`TestFlashAttention`'s (`tests/test_kernels.py`), with blocks of 32 and
the default 128.  Tolerances:

* float32 outputs: atol 1e-5 (float32 sums over the keys of a tile in
  other orders, and against the oracle a softmax taken in one piece);
* bfloat16 outputs: every element within one bfloat16 ulp of the other
  side plus the float32 tolerance, |a − b| ≤ 2⁻⁷·|b| + 1e-5: both sides
  sum in float32 (to within the float32 tolerance) and round once, so an
  element can differ by one rounding step.  The float32 term is needed
  where the weighted sum cancels near zero: there the float32 values on
  the two sides differ by more than a bf16 ulp of the element from the
  order of the sums alone (one element of (2, 128, 4, 2, 32), block 32,
  does against the Pallas kernel).

The bf16 CUDA kernel rounds p to bf16 before P·V, which the reference
does not; its plain version `ref.rounded_flash_bhsd` does the same, and
is held here two ways:

* against a float64 numpy emulation of that rounding: within one bf16
  ulp plus the float32 term plus the plain version's flip slack (where
  float32 and float64 could round a p to neighbouring bf16 values, one
  bf16 ulp of that p times |v|, over l);
* against the reference's function (the Pallas kernel in interpret
  mode) within the derived bound |a − b| ≤ 2⁻⁷·|b| + 2⁻⁸·max_head |v| +
  1e-5·max |b|: p̃ = p(1 + δ), |δ| ≤ 2⁻⁸, moves Σ p̃ v / l by at most
  2⁻⁸·max |v|, and both outputs round once to bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_bhsd as r_bhsd  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as r_flash  # noqa: E402
from repro.kernels.flash_attention.ref import reference_attention as r_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

SHAPES = [
    (2, 128, 4, 2, 32, True),
    (1, 96, 2, 2, 16, False),
    (2, 64, 4, 1, 64, True),
    (1, 80, 8, 4, 32, True),     # non-divisible seq (pad)
]
F32_ATOL = 1e-5


def inputs(seed, B, S, H, Hk, hd):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, S, H, hd), f(B, S, Hk, hd), f(B, S, Hk, hd)


def assert_within_one_bf16_ulp(got, want):
    """|got − want| ≤ 2⁻⁷·|want| + F32_ATOL elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = 2.0 ** -7 * np.abs(want) + F32_ATOL
    excess = np.abs(got - want) - bound
    assert excess.max() <= 0, \
        f"{int((excess > 0).sum())} elements beyond one bf16 ulp"


def assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=F32_ATOL)
    else:
        assert_within_one_bf16_ulp(got, want)


def oracle(q, k, v, causal):
    """`repro`'s reference_attention in the model (BSHD) layout."""
    sw = lambda x: jnp.swapaxes(x, 1, 2)
    return sw(r_ref(sw(q), sw(k), sw(v), causal=causal))


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hk,hd,causal", SHAPES)
def test_op_matches_both_oracles(B, S, H, Hk, hd, causal, dtype, block):
    q, k, v = inputs(S + hd, B, S, H, Hk, hd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    pallas = r_flash(jq, jk, jv, causal=causal, block_q=block,
                     block_k=block, interpret=True)
    want = oracle(jq, jk, jv, causal)
    before = kernel.flash_attention_bhsd.launches
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)),
                              causal=causal, block_q=block, block_k=block)
    assert kernel.flash_attention_bhsd.launches == before
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    got = got.float().numpy()
    assert_close(got, pallas, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("B,S,H,Hk,hd,causal", SHAPES)
def test_oracle_matches_repro(B, S, H, Hk, hd, causal):
    q, k, v = inputs(S, B, S, H, Hk, hd)
    sw = lambda a: np.swapaxes(a, 1, 2)
    got = ref.reference_attention(*(torch.from_numpy(sw(a).copy())
                                    for a in (q, k, v)), causal=causal)
    want = r_ref(*(jnp.asarray(sw(a)) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_masks_past_kv_len(causal):
    """Keys at or past `kv_len` do not count, whatever they hold: the
    padded form equals the unpadded one, and the Pallas kernel given the
    same padded arrays."""
    q, k, v = inputs(3, 1, 40, 4, 2, 16)
    sw = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    pad = lambda a: np.concatenate(
        [a, np.full(a.shape[:2] + (8, a.shape[3]), 7.0, np.float32)], 2)
    qt, kt, vt = sw(q), pad(sw(k)), pad(sw(v))
    t = torch.from_numpy
    padded = ref.reference_flash_bhsd(t(qt), t(kt), t(vt), causal=causal,
                                      kv_len=40, block_k=16)
    plain = ops.flash_attention(t(q), t(k), t(v), causal=causal,
                                block_k=16).transpose(1, 2)
    np.testing.assert_array_equal(padded.numpy(), plain.numpy())
    from repro.kernels.flash_attention.kernel import flash_attention_bhsd
    qp = np.concatenate([qt, np.zeros_like(qt[:, :, :8])], 2)
    pallas = flash_attention_bhsd(jnp.asarray(qp), jnp.asarray(kt),
                                  jnp.asarray(vt), causal=causal, kv_len=40,
                                  block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(padded.numpy(), np.asarray(pallas)[:, :, :40],
                               rtol=0, atol=F32_ATOL)


def test_block_sizes_follow_the_reference(monkeypatch):
    """min(block, max(8, next_pow2(S))): S=5 → 8, S=80 → 128 (or 32)."""
    seen = []
    real = ops.reference_flash_bhsd

    def spy(q, k, v, *, causal, kv_len, block_k):
        seen.append((q.shape[2], k.shape[2], kv_len, block_k))
        return real(q, k, v, causal=causal, kv_len=kv_len, block_k=block_k)

    monkeypatch.setattr(ops, "reference_flash_bhsd", spy)
    for S, block in ((5, 128), (80, 128), (80, 32), (8, 128)):
        q, k, v = (torch.from_numpy(a) for a in inputs(S, 1, S, 2, 1, 16))
        ops.flash_attention(q, k, v, block_q=block, block_k=block)
    assert seen == [(8, 8, 5, 8), (128, 128, 80, 128), (96, 96, 80, 32),
                    (8, 8, 8, 8)]


def test_gradient_guard_matches_the_reference():
    """The op raises under grad, on every device, as `jax.grad` through
    the reference kernel does; under no_grad it runs."""
    q, k, v = inputs(0, 1, 16, 2, 1, 16)
    tq = torch.from_numpy(q).requires_grad_()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(tq, tk, tv)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(tq, tk, tv, interpret=True)
    with torch.no_grad():
        assert ops.flash_attention(tq, tk, tv).shape == (1, 16, 2, 16)
    with torch.inference_mode():
        assert ops.flash_attention(tq, tk, tv).shape == (1, 16, 2, 16)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    with pytest.raises(AssertionError):
        jax.grad(lambda x: r_flash(x, jk, jv, block_q=16, block_k=16,
                                   interpret=True).sum())(jq)


def bf16_inputs(seed, B, S, H, Hk, hd, pad=0):
    """q [B,H,S,hd], k and v [B,Hk,S + pad,hd] in BHSD, rounded to bf16
    (as float32 numpy); the `pad` keys past S hold 7.0."""
    q, k, v = (np.ascontiguousarray(np.swapaxes(a, 1, 2))
               for a in inputs(seed, B, S, H, Hk, hd))
    widen = lambda a: np.concatenate(
        [a, np.full(a.shape[:2] + (pad, hd), 7.0, np.float32)], 2)
    rnd = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16),
                               np.float32)
    return rnd(q), rnd(widen(k)), rnd(widen(v))


def emulate_rounded(q, k, v, causal, kv_len):
    """The bf16 kernel's function in float64 numpy: key tiles of
    `ref.KEY_TILE`, scores times hd^-1/2·log2 e, exp2, p rounded to bf16
    before P·V, l summing the unrounded p; the output in float64."""
    B, H, Sq, hd = q.shape
    G = H // k.shape[1]
    kk, vv = (np.repeat(a.astype(np.float64), G, axis=1) for a in (k, v))
    c = ref.score_scale(hd)
    rows = np.arange(Sq)[:, None]
    m = np.full((B, H, Sq), -1e30)
    l = np.zeros((B, H, Sq))
    acc = np.zeros((B, H, Sq, hd))
    for k0 in range(0, kv_len, ref.KEY_TILE):
        kt, vt = kk[:, :, k0:k0 + ref.KEY_TILE], vv[:, :, k0:k0 + ref.KEY_TILE]
        s = q.astype(np.float64) @ np.swapaxes(kt, -1, -2) * c
        cols = k0 + np.arange(kt.shape[2])[None, :]
        mask = (cols < kv_len) & ((rows >= cols) if causal else True)
        s = np.where(mask, s, -1e30)
        m_new = np.maximum(m, s.max(-1))
        corr = np.exp2(m - m_new)
        p = np.exp2(s - m_new[..., None])
        p16 = np.asarray(jnp.asarray(p.astype(np.float32)).astype(
            jnp.bfloat16), np.float64)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p16 @ vt
        m = m_new
    return acc / np.maximum(l, 1e-30)[..., None]


@pytest.mark.parametrize("pad", [0, 16])
@pytest.mark.parametrize("B,S,H,Hk,hd,causal", SHAPES)
def test_rounded_plain_version_matches_a_float64_emulation(B, S, H, Hk, hd,
                                                           causal, pad):
    q, k, v = bf16_inputs(S + pad, B, S, H, Hk, hd, pad)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got, slack = ref.rounded_flash_bhsd(t(q), t(k), t(v), causal=causal,
                                        kv_len=S, with_slack=True)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, hd)
    want = emulate_rounded(q, k, v, causal, S).astype(np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32)
    bound = 2.0 ** -7 * np.abs(want) + F32_ATOL * np.abs(want).max() + \
        slack.numpy()
    assert np.all(np.abs(got.float().numpy() - want) <= bound)


@pytest.mark.parametrize("pad", [0, 16])
@pytest.mark.parametrize("B,S,H,Hk,hd,causal", SHAPES)
def test_rounded_plain_version_within_the_derived_bound_of_repro(
        B, S, H, Hk, hd, causal, pad):
    """Keys past `kv_len` = S (pad > 0) are masked on both sides."""
    q, k, v = bf16_inputs(S + pad + 1, B, S, H, Hk, hd, pad)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = ref.rounded_flash_bhsd(t(q), t(k), t(v), causal=causal, kv_len=S)
    j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    if pad:
        want = r_bhsd(j(q), j(k), j(v), causal=causal, kv_len=S,
                      block_q=16, block_k=16, interpret=True)
    else:
        sw = lambda a: jnp.swapaxes(a, 1, 2)
        want = sw(r_flash(sw(j(q)), sw(j(k)), sw(j(v)), causal=causal,
                          interpret=True))
    want = np.asarray(want, np.float32)
    v_max = np.repeat(np.abs(v[:, :, :S]).max(axis=(2, 3)), H // Hk,
                      axis=1)[..., None, None]
    bound = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * v_max + \
        F32_ATOL * np.abs(want).max()
    assert np.all(np.abs(got.float().numpy() - want) <= bound)


def test_kernel_refuses_what_it_does_not_take():
    """CPU tensors, unsupported head dims and blocks raise: there is no
    fallback to the plain version."""
    q = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention_bhsd(q, q, q, kv_len=16, block_q=16,
                                    block_k=16)
    with pytest.raises(ValueError, match="head dim 96"):
        kernel.check_shapes(96, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="block_k 256"):
        kernel.check_shapes(128, 256, torch.bfloat16)
    with pytest.raises(TypeError, match="float16"):
        kernel.check_shapes(128, 128, torch.float16)
    for hd in kernel.HEAD_DIMS:
        for block in (8, 16, 32, 64, 128):
            kernel.check_shapes(hd, block, torch.bfloat16)

"""Parity of the port's SSD scan kernel package with `repro`'s.

The same numpy-seeded inputs go through `repro`'s `ssd_scan` and Pallas
`ssd_intra_chunk` (interpret mode) and through the port's plain versions,
which `ops.ssd_scan` runs for CPU tensors or with `interpret=True`:

* the full scan against `repro`'s at atol 1e-4 and against the naive
  recurrence at atol 1e-3 (`repro`'s own tolerance in
  `tests/test_kernels.py`): float32 sums over up to 64-step chunks, taken
  in other orders (measured ≤ 8.1e-6 against `repro`);
* `reference_intra_chunk` against the Pallas kernel on all three outputs
  at atol 1e-4: the port fixes the kernel's order of operations, the
  Pallas body leaves it to XLA.

The CUDA kernel itself runs only on the card: `tests/test_torch_cuda.py`
holds it to the plain version there.  Its shape checks run here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.kernels.ssd_scan import kernel as r_kernel  # noqa: E402
from repro.kernels.ssd_scan import ops as r_ops  # noqa: E402
from repro.kernels.ssd_scan import ref as r_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as t_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as t_ref  # noqa: E402

# tests/test_kernels.py::TestSSDScan's shapes, the pad case included
SHAPES = [(2, 64, 4, 16, 8, 16), (1, 100, 8, 8, 16, 32),
          (2, 128, 16, 32, 16, 64)]


def make_inputs(seed, B, S, nh, hd, st):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xdt = (0.5 * rng.standard_normal((B, S, nh, hd))).astype(f32)
    log_a = (-0.5 * np.logaddexp(rng.standard_normal((B, S, nh)), 0)) \
        .astype(f32)
    b = (0.5 * rng.standard_normal((B, S, st))).astype(f32)
    c = (0.5 * rng.standard_normal((B, S, st))).astype(f32)
    return xdt, log_a, b, c


def as_torch(arrays, dtype=torch.float32):
    xdt, log_a, b, c = (torch.from_numpy(a) for a in arrays)
    return xdt.to(dtype), log_a, b.to(dtype), c.to(dtype)


@pytest.mark.parametrize("B,S,nh,hd,st,chunk", SHAPES)
def test_scan_matches_repro_and_the_recurrence(B, S, nh, hd, st, chunk):
    arrays = make_inputs(B * S + nh, B, S, nh, hd, st)
    t = as_torch(arrays)
    out = t_ops.ssd_scan(*t, chunk=chunk, interpret=True)
    assert out.dtype == torch.float32 and out.shape == (B, S, nh, hd)
    ref = np.asarray(r_ops.ssd_scan(*arrays, chunk=chunk, head_block=4,
                                    interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    naive = t_ref.reference_ssd(*t).numpy()
    np.testing.assert_allclose(out.numpy(), naive, rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        naive, np.asarray(r_ref.reference_ssd(*arrays)), rtol=0, atol=1e-4)


@pytest.mark.parametrize("B,S,nh,hd,st,chunk", SHAPES)
def test_cpu_tensors_take_the_plain_version(B, S, nh, hd, st, chunk):
    t = as_torch(make_inputs(7, B, S, nh, hd, st))
    before = t_kernel.ssd_intra_chunk.launches
    assert torch.equal(t_ops.ssd_scan(*t, chunk=chunk),
                       t_ops.ssd_scan(*t, chunk=chunk, interpret=True))
    assert t_kernel.ssd_intra_chunk.launches == before


@pytest.mark.parametrize("B,S,nh,hd,st,chunk", SHAPES)
def test_intra_chunk_matches_pallas(B, S, nh, hd, st, chunk):
    arrays = make_inputs(3 + S, B, S, nh, hd, st)
    pad = (-S) % chunk
    arrays = tuple(np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                   for a in arrays)
    got = t_ref.reference_intra_chunk(*as_torch(arrays), chunk)
    want = r_kernel.ssd_intra_chunk(*arrays, chunk=chunk, head_block=4,
                                    interpret=True)
    nC = (S + pad) // chunk
    shapes = [(B, S + pad, nh, hd), (B, nC, nh, hd, st), (B, nC, nh)]
    for g, w, shape in zip(got, want, shapes):
        assert g.dtype == torch.float32 and g.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_bfloat16_inputs_match_repro():
    """xdt, b and c in bfloat16 (the main path's type): both sides widen
    them exactly and compute in float32."""
    import jax.numpy as jnp
    arrays = make_inputs(11, 1, 96, 8, 16, 16)
    t = as_torch(arrays, torch.bfloat16)
    out = t_ops.ssd_scan(*t, chunk=32, interpret=True)
    j = [jnp.asarray(a) for a in arrays]
    j = [j[0].astype(jnp.bfloat16), j[1], j[2].astype(jnp.bfloat16),
         j[3].astype(jnp.bfloat16)]
    ref = np.asarray(r_ops.ssd_scan(*j, chunk=32, head_block=4,
                                    interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("Q,hd,st,dtype", [
    (128, 64, 128, torch.bfloat16),     # the main path: 98.5 KiB
    (128, 64, 128, torch.float32),
    (256, 64, 128, torch.bfloat16),     # the ArchConfig default chunk
    (8, 16, 16, torch.float32),         # the smoke engine's prefill
])
def test_kernel_takes_the_model_shapes(Q, hd, st, dtype):
    t_kernel.check_shapes(Q, hd, st, dtype)


@pytest.mark.parametrize("Q,hd,st,dtype,match", [
    (512, 64, 128, torch.bfloat16, "chunk 512"),
    (128, 48, 128, torch.bfloat16, "ssm_headdim 48"),
    (128, 64, 96, torch.bfloat16, "ssm_state 96"),
    (256, 128, 128, torch.bfloat16, "outputs per thread"),
    (256, 64, 128, torch.float32, "shared memory"),
    (128, 64, 128, torch.float16, "float32 or bfloat16"),
])
def test_kernel_rejects_unsupported_shapes(Q, hd, st, dtype, match):
    with pytest.raises((ValueError, TypeError), match=match):
        t_kernel.check_shapes(Q, hd, st, dtype)


def test_gradient_guard_matches_the_reference():
    """`jax.grad` through the reference op fails (its Pallas kernel has no
    VJP); the port's op raises under grad, on every device, instead of
    differentiating its plain version; under no_grad it runs."""
    xdt, log_a, b, c = make_inputs(11, 1, 32, 2, 8, 16)
    with pytest.raises(ValueError):
        jax.grad(lambda x: r_ops.ssd_scan(x, log_a, b, c, chunk=16,
                                          interpret=True).sum())(xdt)
    tx, tl, tb, tc = as_torch((xdt, log_a, b, c))
    tx.requires_grad_()
    for interpret in (False, True):
        with pytest.raises(RuntimeError, match="no backward"):
            t_ops.ssd_scan(tx, tl, tb, tc, chunk=16, interpret=interpret)
    with torch.no_grad():
        assert t_ops.ssd_scan(tx, tl, tb, tc, chunk=16).shape == \
            (1, 32, 2, 8)


def test_kernel_refuses_cpu_tensors():
    t = as_torch(make_inputs(0, 1, 16, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.ssd_intra_chunk(*t, 16)


# ---- the tensor-core kernel's plain version (`ref.split_intra_chunk`) ----
# Its bounds are `ref.split_coefficients` × the magnitude sums
# (`ref.intra_chunk_majorants`), derived in chip_smoke.py beside SSD_SUM_U.

SPLIT_SHAPES = [
    (1, 128, 3, 64, 128, 128),     # the serving widths, one chunk
    (1, 200, 2, 64, 128, 100),     # Q off a multiple of 64
    (2, 64, 8, 16, 16, 8),         # smoke widths, the smoke prefill's Q
    (2, 64, 8, 16, 16, 32),
]
SUM_U = 2.0 ** -22
SPLIT = 2.0 ** -16
HI_LO = (1 + 2.0 ** -8) ** 2


def bf16_inputs(seed, B, S, nh, hd, st):
    """make_inputs with xdt, b and c rounded to bf16 (the serving path's
    types), as float32 numpy arrays and as the port's tensors."""
    t = as_torch(make_inputs(seed, B, S, nh, hd, st), torch.bfloat16)
    return tuple(a.float().numpy() for a in t), t


def bf16_round(v):
    """float64 → the nearest bf16 value (8 significant bits), ties to
    even, in float64."""
    m, e = np.frexp(v)
    return np.ldexp(np.rint(np.ldexp(m, 8)), e - 8)


def serial_prefix(la):
    """[B,nC,Q,nh] float32 → the running sums, one float32 add per step."""
    out = np.empty_like(la)
    run = la[:, :, 0]
    out[:, :, 0] = run
    for q in range(1, la.shape[2]):
        run = (run + la[:, :, q]).astype(np.float32)
        out[:, :, q] = run
    return out


def emulate_split(arrays, Q):
    """`split_intra_chunk` in float64 numpy: C·B exact, decays of the
    float32 gaps, W and tail·xdt split by `bf16_round`, exact sums."""
    xdt, log_a, b, c = arrays
    B, S, nh, hd = xdt.shape
    st = b.shape[-1]
    nC = S // Q
    f64 = np.float64
    x = xdt.reshape(B, nC, Q, nh, hd).astype(f64)
    bb = b.reshape(B, nC, Q, st).astype(f64)
    cc = c.reshape(B, nC, Q, st).astype(f64)
    acum = serial_prefix(log_a.reshape(B, nC, Q, nh).astype(np.float32))
    gap = acum[:, :, :, None, :] - acum[:, :, None, :, :]        # float32
    causal = np.tril(np.ones((Q, Q), bool))[:, :, None]
    w = np.einsum("bnqj,bnkj->bnqk", cc, bb)[..., None] * \
        np.where(causal, np.exp(gap.astype(f64)), 0.0)
    w_hi = bf16_round(w)
    y = np.einsum("bnqkh,bnkhd->bnqhd", w_hi + bf16_round(w - w_hi), x)
    tail = np.exp((acum[:, :, -1:, :] - acum).astype(f64))
    xt = x * tail[..., None]
    xt_hi = bf16_round(xt)
    h = np.einsum("bnkhd,bnks->bnhds", xt_hi + bf16_round(xt - xt_hi), bb)
    return y.reshape(B, S, nh, hd), h, acum.reshape(B, S, nh)


def within(got, want, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= bound), float(np.max(err / np.maximum(bound,
                                                                1e-300)))


def test_split_bf16_rounds_to_nearest_even():
    """hi and lo against the bit-level rule (add 0x7FFF plus the kept
    lowest bit, clear the low 16 bits), ties included."""
    rng = np.random.default_rng(5)
    v = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))) \
        .astype(np.float32)
    bits = v.view(np.uint32)
    bits[:512] = (bits[:512] & 0xFFFF0000) | 0x8000     # exact ties
    v = bits.view(np.float32)

    def rne(a):
        u = a.view(np.uint32).astype(np.uint64)
        return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(
            np.uint32).view(np.float32)
    hi, lo = t_ref.split_bf16(torch.from_numpy(v))
    np.testing.assert_array_equal(hi.numpy(), rne(v))
    np.testing.assert_array_equal(lo.numpy(), rne(v - rne(v)))
    assert np.all(np.abs(v.astype(np.float64) - hi.numpy() - lo.numpy())
                  <= SPLIT * np.abs(v))


@pytest.mark.parametrize("B,S,nh,hd,st,chunk", SPLIT_SHAPES)
def test_split_intra_chunk_matches_a_float64_emulation(B, S, nh, hd, st,
                                                       chunk):
    """y within split_coefficients' y_split (the same two roundings of W
    and the same split on each side, float32 sums on one); h within the
    sums' term plus two splits and two roundings of tail·xdt, since the
    emulation forms them in float64; a within two float32 ulps (the
    library's expf); the prefix sums bitwise."""
    arrays, t = bf16_inputs(S + hd, B, S, nh, hd, st)
    y, h, a, acum = t_ref.split_intra_chunk(*t, chunk)
    ty, th = t_ref.intra_chunk_majorants(*t, chunk)
    e_y, e_h, e_acum = emulate_split(arrays, chunk)
    co = t_ref.split_coefficients(chunk, st)
    Qp = -(-chunk // 64) * 64
    n = 2 * Qp * SUM_U
    c_h = (4 * SUM_U + 2 * SPLIT + 2 * HI_LO * n / (1 - n)) * (1 + SUM_U)
    within(y.numpy(), e_y, co["y_split"] * ty.double().numpy())
    within(h.numpy(), e_h, c_h * th.double().numpy())
    np.testing.assert_array_equal(acum.numpy(), e_acum)
    last = e_acum.reshape(B, S // chunk, chunk, nh)[:, :, -1]
    np.testing.assert_allclose(a.numpy(), np.exp(last.astype(np.float64)),
                               rtol=2.0 ** -22, atol=0)


@pytest.mark.parametrize("B,S,nh,hd,st,chunk", SPLIT_SHAPES)
def test_split_intra_chunk_matches_pallas(B, S, nh, hd, st, chunk):
    """Against `repro`'s Pallas kernel in interpret mode, within
    split_coefficients' bounds against the reference's function, widened
    for what the Pallas body does otherwise: its prefix sums come from
    `jnp.cumsum` in XLA's order, each within e = 2γ(Q)·Σ|log_a| of the
    serial ones (γ at float32's 2⁻²⁴), which moves every decay, tail and a
    by a factor within exp(±2e); its h forms tail·B·xdt in another order
    (2u)."""
    arrays, t = bf16_inputs(S + nh, B, S, nh, hd, st)
    y, h, a, _ = t_ref.split_intra_chunk(*t, chunk)
    ty, th = t_ref.intra_chunk_majorants(*t, chunk)
    want = r_kernel.ssd_intra_chunk(*arrays, chunk=chunk, head_block=4,
                                    interpret=True)
    co = t_ref.split_coefficients(chunk, st)
    g = chunk * 2.0 ** -24
    la_sum = np.abs(arrays[1]).reshape(B, -1, chunk, nh).sum(2).max()
    moved = np.expm1(2 * 2 * g / (1 - g) * la_sum)
    within(y.numpy(), want[0], (co["y_ref"] + moved) * ty.double().numpy())
    within(h.numpy(), want[1],
           (co["h_ref"] + 2 * SUM_U + moved) * th.double().numpy())
    within(a.numpy(), want[2], (moved + 2.0 ** -22) * np.abs(want[2]))


@pytest.mark.parametrize("plain", ["reference", "split"])
def test_prefix_sums_are_serial(plain):
    """The intra-chunk pass's 4th output: the chunk-local running sums of
    log_a, one float32 add per step, in order."""
    B, S, nh, hd, st, chunk = 2, 96, 4, 16, 16, 32
    arrays, t = bf16_inputs(3, B, S, nh, hd, st)
    fn = getattr(t_ref, f"{plain}_intra_chunk")
    acum = fn(*t, chunk)[3]
    want = serial_prefix(arrays[1].reshape(B, S // chunk, chunk, nh))
    assert acum.dtype == torch.float32
    np.testing.assert_array_equal(acum.numpy(), want.reshape(B, S, nh))


@pytest.mark.parametrize("interpret", [False, True])
def test_ssd_scan_takes_no_cumsum(monkeypatch, interpret):
    """The inter-chunk term reuses the intra-chunk pass's prefix sums."""
    t = as_torch(make_inputs(4, 1, 100, 4, 16, 16), torch.bfloat16)
    want = t_ops.ssd_scan(*t, chunk=32, interpret=interpret)

    def refuse(*args, **kw):
        raise AssertionError("torch.cumsum called")
    monkeypatch.setattr(torch, "cumsum", refuse)
    monkeypatch.setattr(torch.Tensor, "cumsum", refuse)
    assert torch.equal(t_ops.ssd_scan(*t, chunk=32, interpret=interpret),
                       want)


@pytest.mark.parametrize("dtype,plain,atol", [
    (torch.float32, "reference", 1e-5),
    (torch.bfloat16, "reference", 1e-4),
    (torch.bfloat16, "split", 1e-4),     # the card's bf16 arithmetic
])
def test_scan_matches_repro_by_dtype(monkeypatch, dtype, plain, atol):
    """The full scan against `repro`'s: float32 at 1e-5, bf16 inputs at
    1e-4, with the intra-chunk pass the reference's function or the
    tensor-core kernel's plain version."""
    import jax.numpy as jnp
    B, S, nh, hd, st, chunk = 1, 200, 8, 16, 32, 64
    arrays = make_inputs(21, B, S, nh, hd, st)
    t = as_torch(arrays, dtype)
    if plain == "split":
        monkeypatch.setattr(t_ops, "reference_intra_chunk",
                            t_ref.split_intra_chunk)
    out = t_ops.ssd_scan(*t, chunk=chunk)
    j = [jnp.asarray(a) for a in arrays]
    if dtype == torch.bfloat16:
        j = [j[0].astype(jnp.bfloat16), j[1], j[2].astype(jnp.bfloat16),
             j[3].astype(jnp.bfloat16)]
    ref = np.asarray(r_ops.ssd_scan(*j, chunk=chunk, head_block=4,
                                    interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("Q,hd,st,dtype,tc", [
    (128, 64, 128, torch.bfloat16, True),     # the serving path
    (100, 64, 128, torch.bfloat16, True),     # a 100-token prompt
    (8, 16, 16, torch.bfloat16, True),        # the smoke prefill
    (256, 64, 128, torch.bfloat16, True),     # the default chunk
    (64, 64, 256, torch.bfloat16, True),
    (128, 64, 128, torch.float32, False),     # float32: CUDA cores
    (128, 8, 128, torch.bfloat16, False),     # hd below 16
    (128, 64, 8, torch.bfloat16, False),      # st below 16
    (64, 256, 64, torch.bfloat16, False),     # hd 256
    (193, 16, 256, torch.bfloat16, False),    # tiles above 227 KiB
])
def test_tensor_cores_take_bf16_by_shape(Q, hd, st, dtype, tc):
    """The dispatch is by dtype and shape alone, and every shape it sends
    to the CUDA cores is one `check_shapes` admits."""
    t_kernel.check_shapes(Q, hd, st, dtype)
    assert t_kernel.uses_tensor_cores(Q, hd, st, dtype) is tc

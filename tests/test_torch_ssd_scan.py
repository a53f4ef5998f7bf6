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

"""Parity of the port's MoE router gating with `repro`'s.

Logits come from numpy with fixed seeds and go through both packages.
On the CPU the port's `ops.fused_gating` runs the kernel's plain version
(`ref.reference_gating`); `repro` runs its Pallas kernel in interpret
mode (the only mode its CPU allows), as `tests/test_kernels.py` does,
and its oracle `reference_gating` (softmax, `lax.top_k`, renormalise).
Shapes are `TestMoEGating`'s, plus N off the Pallas block and the
router's main-path width (E 32, k 8).  Tolerances: ids equal, in order;
gates within 1e-6 (float32 softmax sums in other orders); each row's
gates summing to 1 within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.kernels.moe_gating.ops import fused_gating as r_fused  # noqa: E402
from repro.kernels.moe_gating.ref import reference_gating as r_ref  # noqa: E402
from repro_torch.kernels.moe_gating import kernel, ops, ref  # noqa: E402

SHAPES = [(128, 16, 2), (100, 64, 6), (256, 32, 8), (64, 8, 1),
          (300, 32, 8), (1000, 32, 8)]       # the last two off the block
GATE_ATOL = 1e-6
SUM_ATOL = 1e-5


def logits(seed, N, E, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((N, E))) \
        .astype(np.float32)


def assert_matches(got, want):
    (g, i), (wg, wi) = got, want
    np.testing.assert_array_equal(np.asarray(i), np.asarray(wi))
    np.testing.assert_allclose(np.asarray(g), np.asarray(wg), rtol=0,
                               atol=GATE_ATOL)


@pytest.mark.parametrize("N,E,k", SHAPES)
def test_plain_version_matches_repro(N, E, k):
    x = logits(N + E, N, E)
    got = ref.reference_gating(torch.from_numpy(x), k)
    assert got[0].dtype == torch.float32 and got[0].shape == (N, k)
    assert got[1].dtype == torch.int32 and got[1].shape == (N, k)
    assert_matches(got, r_ref(jnp.asarray(x), k))
    assert_matches(got, r_fused(jnp.asarray(x), k, block_n=64,
                                interpret=True))
    np.testing.assert_allclose(got[0].sum(-1).numpy(), np.ones(N), rtol=0,
                               atol=SUM_ATOL)


@pytest.mark.parametrize("N,E,k", SHAPES)
def test_op_on_the_cpu_is_the_plain_version(N, E, k):
    x = torch.from_numpy(logits(N * E, N, E, scale=3.0))
    before = kernel.gating_topk.launches
    g, i = ops.fused_gating(x, k)
    g2, i2 = ops.fused_gating(x, k, interpret=True)
    want = ref.reference_gating(x, k)
    assert kernel.gating_topk.launches == before
    for a, b in ((g, want[0]), (i, want[1]), (g2, want[0]), (i2, want[1])):
        assert torch.equal(a, b)
    assert_matches((g, i), r_fused(jnp.asarray(x.numpy()), k, block_n=256,
                                   interpret=True))


def test_ties_go_to_the_lowest_index():
    """Rows with equal logits: the ids are 0..k−1 and the gates 1/k; a row
    with a tie inside the top k keeps index order among the tied; the same
    as the Pallas kernel and `lax.top_k`."""
    x = np.zeros((4, 32), np.float32)
    x[1] = 2.5
    x[2, [3, 9, 17, 30]] = 1.0
    x[3, [30, 5]] = 4.0
    x[3, [7, 2, 31]] = 3.0
    g, i = ops.fused_gating(torch.from_numpy(x), 8)
    assert i[0].tolist() == i[1].tolist() == list(range(8))
    assert i[2].tolist() == [3, 9, 17, 30, 0, 1, 2, 4]
    assert i[3].tolist() == [5, 30, 2, 7, 31, 0, 1, 3]
    np.testing.assert_allclose(g[0].numpy(), np.full(8, 0.125), rtol=0,
                               atol=GATE_ATOL)
    assert_matches((g, i), r_fused(jnp.asarray(x), 8, block_n=64,
                                   interpret=True))
    assert_matches((g, i), r_ref(jnp.asarray(x), 8))


def test_op_casts_narrower_types_to_float32():
    x = torch.from_numpy(logits(7, 40, 16)).to(torch.bfloat16)
    g, i = ops.fused_gating(x, 4)
    want = ref.reference_gating(x.float(), 4)
    assert torch.equal(g, want[0]) and torch.equal(i, want[1])
    assert_matches((g, i), r_fused(jnp.asarray(x.float().numpy())
                                   .astype(jnp.bfloat16), 4, block_n=64,
                                   interpret=True))


def test_op_raises_under_grad_and_on_float64():
    """The op raises under grad on every device, as `jax.grad` through
    the reference kernel does; float64 raises rather than being
    narrowed."""
    x = torch.from_numpy(logits(0, 16, 8)).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fused_gating(x, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fused_gating(x, 2, interpret=True)
    with torch.no_grad():
        assert ops.fused_gating(x, 2)[1].shape == (16, 2)
    with pytest.raises(TypeError, match="float64"):
        ops.fused_gating(x.detach().double(), 2)
    with pytest.raises(ValueError, match="Linearization"):
        jax.grad(lambda a: r_fused(a, 2, block_n=16, interpret=True)[0]
                 .sum())(jnp.asarray(x.detach().numpy()))


def test_kernel_refuses_what_it_does_not_take():
    """CPU tensors, other types, shapes and sizes raise: there is no
    fallback to the plain version."""
    x = torch.zeros(8, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.gating_topk(x, 8)
    with pytest.raises(ValueError, match="300 experts"):
        kernel.check_sizes(300, 8)
    with pytest.raises(ValueError, match="top_k 9"):
        kernel.check_sizes(32, 9)
    with pytest.raises(ValueError, match="top_k 5"):
        kernel.check_sizes(4, 5)
    for E in (1, 8, 32, 64, 256):
        kernel.check_sizes(E, min(8, E))


@pytest.mark.parametrize("N,E,rows,stride", [
    (1024, 32, 128, 33), (4, 32, 32, 33), (16384, 64, 128, 65),
    (100, 256, 32, 257), (33, 96, 64, 97), (5000, 127, 64, 127)])
def test_launch_shape_fits_shared_memory(N, E, rows, stride):
    """An odd row stride (no bank conflicts), rows · stride floats within
    48 KiB, and no more rows per block than N needs, in warps."""
    assert kernel.launch_shape(N, E) == (rows, stride)
    assert stride % 2 == 1 and rows * stride * 4 <= 48 * 1024

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


@pytest.mark.parametrize("N,E,shape", [
    (4, 32, (4, 1, 1)), (1024, 32, (4, 256, 1)), (16384, 32, (4, 2112, 1)),
    (5000, 32, (4, 1250, 1)), (100, 8, (4, 25, 1)), (33, 127, (4, 9, 4)),
    (77, 256, (4, 20, 8))])
def test_launch_shape_gives_a_warp_per_row(N, E, shape):
    """(warps per block, blocks, columns per lane): 4 warps per block, a
    block per 4 rows up to 16 blocks per SM of the H100's 132 (N 16384
    then takes the grid-stride loop), ceil(E / 32) columns per lane."""
    assert kernel.launch_shape(N, E) == shape
    warps, blocks, cols = shape
    assert warps * blocks >= min(N, warps * kernel.MAX_BLOCKS)
    assert 32 * (cols - 1) < E <= 32 * cols <= 32 * 8


def emulated_lane_sum(p):
    """numpy float32, the kernel's steps: lane l sums columns l, l + 32,
    ... of each row in index order (columns past E add nothing), then
    every lane adds the lane `l ^ off` for off 16, 8, 4, 2, 1."""
    N, E = p.shape
    lanes = np.zeros((N, 32), np.float32)
    for l in range(32):
        cols = p[:, l::32]
        if cols.shape[1]:
            lanes[:, l] = cols[:, 0]
            for c in range(1, cols.shape[1]):
                lanes[:, l] = lanes[:, l] + cols[:, c]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    assert (lanes.view(np.int32) == lanes[:, :1].view(np.int32)).all()
    return lanes[:, 0]


@pytest.mark.parametrize("E", [1, 8, 16, 32, 64, 127, 256])
def test_plain_sum_follows_the_kernel_order(E):
    """`ref.lane_butterfly_sum` is bitwise the kernel's lane-and-butterfly
    order, emulated step by step, on probabilities over six decades."""
    rng = np.random.default_rng(E)
    p = np.exp(3.0 * rng.standard_normal((257, E))).astype(np.float32)
    got = ref.lane_butterfly_sum(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  emulated_lane_sum(p).view(np.int32))


def non_finite_rows(E):
    """Rows with a NaN logit, a +inf logit, only −inf logits, and an
    ordinary row beside them."""
    x = logits(E, 4, E, scale=2.0)
    x[0, E // 2] = np.nan
    x[1, E - 1] = np.inf
    x[2] = -np.inf
    return x


@pytest.mark.parametrize("E,k", [(32, 8), (64, 6), (8, 1)])
def test_non_finite_rows_match_repro(E, k):
    """A NaN, +inf or all-−inf row makes every probability NaN: `max`
    propagates NaN and `argmax` takes the first NaN, so the ids are
    0..k−1 and the gates NaN, in the plain version and `ops.fused_gating`
    as in `repro`'s interpret-mode kernel and its oracle."""
    x = non_finite_rows(E)
    got = ref.reference_gating(torch.from_numpy(x), k)
    assert torch.equal(got[1][:3], torch.arange(k, dtype=torch.int32)
                       .expand(3, k))
    assert torch.isnan(got[0][:3]).all() and torch.isfinite(got[0][3]).all()
    op = ops.fused_gating(torch.from_numpy(x), k)
    assert torch.equal(op[1], got[1])
    np.testing.assert_array_equal(op[0].numpy(), got[0].numpy())
    assert_matches(got, r_ref(jnp.asarray(x), k))
    assert_matches(got, r_fused(jnp.asarray(x), k, block_n=4,
                                interpret=True))

"""Parity of the port's streaming quantiles (`repro_torch.core.quantiles`)
with `repro.core.quantiles`, and of the lifecycle's streaming path.

Held bitwise, against `repro`'s functions as called (eagerly): the
histogram quantiles on seeded and adversarial masked streams, batched
``[N, H]`` and row by row; P² on the families and lengths of
`tests/test_streaming_quantiles.py`, the reference's failing case
(normal, n 8, seed 1) included.  P²'s distance from ``np.percentile`` is
printed, not asserted (the reference's own estimator misses its
tolerance there).  Under an outer `jax.jit` XLA fuses the interpolations
into one rounding each, so the jitted reference is held to rtol 1e-6.

The lifecycle with ``exact_quantiles=False`` at `repro`'s streaming
golden (3+1, scale 0.01, HIGH, seed 3): p50/p90 within 1e-6 of `repro`'s
streaming run, within one bin of the port's exact run (NaN months
coinciding), every other output bitwise the exact run's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import fleet as r_fleet  # noqa: E402
from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import quantiles as r_qt  # noqa: E402
from repro.core.arrivals import EnvelopeSpec as REnv  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import quantiles as t_qt  # noqa: E402
from repro_torch.core.arrivals import EnvelopeSpec as TEnv  # noqa: E402

QS = (50.0, 90.0)
HIST_PAD = 128
P2_PAD = 4096


def same_bits(a, b):
    return np.asarray(a, np.float32).tobytes() == \
        np.asarray(b, np.float32).tobytes()


def hist_streams(seed, N=24):
    """[N, HIST_PAD] masked streams: values in [-0.1, 1.2] (so the clip
    acts), clustered rows, bin-edge and point-mass rows, an all-masked
    row and a one-element row."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-0.1, 1.2, (N, HIST_PAD)).astype(np.float32)
    keep = rng.rand(N, HIST_PAD) < rng.uniform(0.05, 1.0, (N, 1))
    x[1] = np.clip(rng.choice(rng.uniform(0, 1, 3), HIST_PAD)
                   + rng.normal(0, 1e-3, HIST_PAD), 0, 1)
    x[2] = np.float32(1.0 / t_qt.DEFAULT_BINS) * (np.arange(HIST_PAD) % 4)
    x[3] = 0.0
    x[4, :64] = 1.0
    keep[5] = False
    keep[6] = False
    keep[6, 17] = True
    return x, keep


@pytest.mark.parametrize("seed", range(6))
def test_hist_bitwise_to_repro_batched_and_by_row(seed):
    x, keep = hist_streams(seed)
    got = t_qt.hist_masked_quantiles(torch.from_numpy(x),
                                     torch.from_numpy(keep), QS)
    for n in range(len(x)):
        want = r_qt.hist_masked_quantiles(jnp.asarray(x[n]),
                                          jnp.asarray(keep[n]), QS)
        row = t_qt.hist_masked_quantiles(torch.from_numpy(x[n]),
                                         torch.from_numpy(keep[n]), QS)
        for q in range(len(QS)):
            assert same_bits(got[q][n], want[q]), (n, QS[q])
            assert same_bits(row[q], want[q]), (n, QS[q])
    assert torch.isnan(got[0][5]) and torch.isnan(got[1][5])
    assert not torch.isnan(got[0][6])


def test_hist_within_one_bin_of_np_percentile_and_jit():
    x, keep = hist_streams(11)
    got = t_qt.hist_masked_quantiles(torch.from_numpy(x),
                                     torch.from_numpy(keep), QS, n_bins=64)
    jitted = jax.jit(lambda a, m: r_qt.hist_masked_quantiles(a, m, QS,
                                                             n_bins=64))
    for n in range(len(x)):
        if not keep[n].any():
            continue
        vals = np.clip(x[n][keep[n]].astype(np.float64), 0.0, 1.0)
        exact = np.percentile(vals, QS)
        want = jitted(x[n], keep[n])
        for q in range(len(QS)):
            assert abs(float(got[q][n]) - exact[q]) <= 1 / 64 + 1e-6
            np.testing.assert_allclose(float(got[q][n]), float(want[q]),
                                       rtol=1e-6, atol=1e-7)


F5_X = np.array([0.2, np.nan, 0.7, 0.4], np.float32)


@pytest.mark.parametrize("keep,want", [
    ((True, True, True, True), (0.2998046875, 0.6099609136581421)),
    ((True, False, True, True), (0.3994140625, 0.6400390863418579)),
])
def test_hist_nan_value_lands_in_bucket_zero(keep, want):
    """A NaN value, masked in or out, is binned into bucket 0 with its
    mask's weight, as `repro`'s int cast bins it on XLA:CPU (the port
    raised on it before: the CPU cast gives INT_MIN)."""
    keep = np.array(keep)
    got = t_qt.hist_masked_quantiles(torch.from_numpy(F5_X),
                                     torch.from_numpy(keep), QS)
    ref = r_qt.hist_masked_quantiles(jnp.asarray(F5_X), jnp.asarray(keep),
                                     QS)
    for q in range(len(QS)):
        assert same_bits(got[q], np.float32(want[q])), QS[q]
        assert same_bits(got[q], ref[q]), QS[q]


def test_hist_nan_rows_batched_bitwise_to_repro():
    """A [3, H] batch with NaN at several places of each row, masked in
    and out, against `repro`'s eager call row by row."""
    rng = np.random.RandomState(5)
    x = rng.uniform(-0.1, 1.1, (3, 40)).astype(np.float32)
    keep = rng.rand(3, 40) < 0.7
    x[0, [0, 7, 8]] = np.nan
    x[1, 3] = np.nan
    keep[1, 3] = False
    x[2, ::5] = np.nan
    x[2, 1] = np.inf
    got = t_qt.hist_masked_quantiles(torch.from_numpy(x),
                                     torch.from_numpy(keep), QS)
    for n in range(len(x)):
        want = r_qt.hist_masked_quantiles(jnp.asarray(x[n]),
                                          jnp.asarray(keep[n]), QS)
        for q in range(len(QS)):
            assert same_bits(got[q][n], want[q]), (n, QS[q])


def family_stream(family, n, seed):
    rng = np.random.RandomState(seed)
    return {"uniform": lambda: rng.uniform(0.0, 1.0, n),
            "normal": lambda: rng.normal(0.0, 1.0, n),
            "exponential": lambda: rng.exponential(1.0, n)}[family]() \
        .astype(np.float32)


@pytest.mark.parametrize("family", ["uniform", "normal", "exponential"])
@pytest.mark.parametrize("n,seed", [(8, 0), (8, 1), (37, 1), (200, 2),
                                    (1023, 3), (3, 5), (1, 6)])
def test_p2_bitwise_to_repro(family, n, seed):
    vals = family_stream(family, n, seed)
    keep = (np.arange(n) * 2654435761 % 8) != 0
    pad = 512 if n < 512 else P2_PAD
    x = np.zeros(pad, np.float32)
    m = np.zeros(pad, bool)
    x[:n], m[:n] = vals, keep
    want = np.asarray(r_qt.p2_stream_quantiles(x, m, QS))
    got = t_qt.p2_stream_quantiles(torch.from_numpy(x), torch.from_numpy(m),
                                   QS).numpy()
    assert got.tobytes() == want.tobytes(), (got, want)
    jitted = np.asarray(jax.jit(
        lambda a, b: r_qt.p2_stream_quantiles(a, b, QS))(x, m))
    np.testing.assert_allclose(got, jitted, rtol=1e-6, atol=1e-7)
    if keep.any():
        ref = np.percentile(vals[keep].astype(np.float64), QS)
        print(f"P2 {family} n={n} seed={seed}: port {got} np.percentile "
              f"{ref} |diff| {np.abs(got - ref)}")


def test_p2_all_masked_is_nan():
    x = torch.full((64,), 0.5)
    assert torch.isnan(t_qt.p2_stream_quantiles(
        x, torch.zeros(64, dtype=torch.bool), QS)).all()


@pytest.fixture(scope="module")
def golden_runs():
    r_cfg = r_fleet.FleetConfig(r_hier.get_design("3+1"),
                                REnv(demand_scale=0.01, gpu_scenario="high"),
                                seed=3)
    t_cfg = t_fleet.FleetConfig(t_hier.get_design("3+1"),
                                TEnv(demand_scale=0.01, gpu_scenario="high"),
                                seed=3)
    return (r_fleet.run_fleet(r_cfg, exact_quantiles=False),
            t_fleet.run_fleet(t_cfg, device="cpu"),
            t_fleet.run_fleet(t_cfg, device="cpu", exact_quantiles=False))


def test_streaming_lifecycle_matches_repro(golden_runs):
    ref, _, stream = golden_runs
    for f in ("p50_stranding", "p90_stranding"):
        a, b = getattr(ref, f), getattr(stream, f)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7, err_msg=f)
    assert ref.n_halls_built == stream.n_halls_built == 14


def test_streaming_within_one_bin_of_exact(golden_runs):
    _, exact, stream = golden_runs
    tol = 1.0 / t_qt.DEFAULT_BINS + 1e-6
    for f in ("p50_stranding", "p90_stranding"):
        e, s = getattr(exact, f), getattr(stream, f)
        np.testing.assert_array_equal(np.isnan(e), np.isnan(s), err_msg=f)
        ok = ~np.isnan(e)
        np.testing.assert_allclose(s[ok], e[ok], atol=tol, err_msg=f)


def test_streaming_leaves_other_outputs_bitwise(golden_runs):
    _, exact, stream = golden_runs
    assert exact.n_halls_built == stream.n_halls_built
    for f in ("halls_active", "deployed_mw", "final_hall_stranding",
              "final_lineup_stranding"):
        assert getattr(exact, f).tobytes() == getattr(stream, f).tobytes(), f
    assert exact.placed_fraction == stream.placed_fraction

"""Tests of the port that need a CUDA card.

They import neither `jax` nor `repro`, so they run on the machine with
the card, where the parity tests' reference package is not installed
(`--noconftest`: the suite's conftest imports jax):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Without a card they skip.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import arrivals, hierarchy  # noqa: E402
from repro_torch.core.sweep import SweepAxes, sweep  # noqa: E402
from repro_torch.kernels.placement_score import kernel, ops  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def kernel_inputs(seed, device, N=12, R=3000, X=300):
    """Random feeds (some rows feed-less), loads around the ratings, and
    rows exactly on the `+1e-4` slack."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    nfeeds = rng.integers(0, 5, (N, R)).astype(np.int32)
    feeds = rng.integers(0, X, (N, R, 4)).astype(np.int32)
    feeds = np.where(np.arange(4) < nfeeds[..., None], feeds, -1)
    cap = rng.choice([625.0, 2500.0], (N, X)).astype(f32)
    tot = (cap * rng.uniform(0, 1.1, (N, X))).astype(f32)
    row_cap = np.zeros((N, R, 4), f32)
    row_cap[..., 0] = rng.choice([0.0, 625.0, 2500.0], (N, R))
    row_load = (row_cap * rng.uniform(0, 1.05, (N, R, 4))).astype(f32)
    p = rng.choice([30.0, 180.0, 410.0, 1200.0], N).astype(f32)
    edge = rng.random((N, R)) < 0.2
    row_load[..., 0] = np.where(edge, (row_cap[..., 0] + f32(1e-4)) - p[:, None],
                                row_load[..., 0])
    arrays = dict(row_feeds=feeds.astype(np.int32), row_nfeeds=nfeeds,
                  row_cap=row_cap, row_load=row_load,
                  lineup_ha=(tot * rng.uniform(0, 1, (N, X))).astype(f32),
                  lineup_tot=tot, lineup_cap=cap, p_dep=p,
                  ha_frac=rng.choice([0.75, 0.8, 1.0], N).astype(f32),
                  is_ha=rng.random(N) < 0.6, is_block=rng.random(N) < 0.5)
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


@pytest.mark.parametrize("seed", range(3))
def test_kernel_matches_plain_version(cuda, seed):
    args = kernel_inputs(seed, cuda)
    before = kernel.placement_score.launches
    feas_k, score_k = ops.score_rows(**args)
    feas_p, score_p = ops.score_rows(**args, interpret=True)
    torch.cuda.synchronize()
    assert kernel.placement_score.launches == before + 1
    assert torch.equal(feas_k, feas_p)
    assert torch.equal(score_k, score_p)


def test_sweep_on_the_card_equals_the_cpu(cuda):
    axes = SweepAxes.zip(
        [hierarchy.get_design("10N/8"), hierarchy.get_design("3+1")],
        [arrivals.EnvelopeSpec(demand_scale=0.003, gpu_scenario="high")],
        policies=[1, 3], seeds=[5, 6])
    on_cpu, on_card = sweep(axes, device="cpu"), sweep(axes, device=cuda)
    assert on_card.event_steps == on_cpu.event_steps > 0
    for f in ("halls_active", "deployed_mw", "p90_stranding", "reg_rows",
              "final_lineup_stranding", "effective_dpm"):
        np.testing.assert_array_equal(getattr(on_card, f), getattr(on_cpu, f))

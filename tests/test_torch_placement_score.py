"""Parity of the port's placement-score kernel package with `repro`'s.

The port's plain version (`ref.reference_score`, which `ops.score_rows`
runs for CPU tensors) is held to `repro`'s oracle and to its Pallas
kernel in interpret mode, on the same numpy-seeded inputs:

* `feas` bitwise, including rows that sit exactly on the `+1e-4` slack
  and rows whose feeds are all padding;
* scores at rtol 1e-6 at feasible rows: `repro` runs them jitted, where
  XLA may contract `2·l̂·s + s²` into one FMA, while the port (and its
  CUDA kernel, built with `-fmad=false`) rounds the product first.
  Against `repro`'s oracle run eagerly the scores are bitwise.

The CUDA kernel itself runs only on the card: `tests/test_torch_cuda.py`
holds it to the plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.placement_score import ops as r_ops  # noqa: E402
from repro.kernels.placement_score import ref as r_ref  # noqa: E402
from repro_torch.kernels.placement_score import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.placement_score import ops as t_ops  # noqa: E402
from repro_torch.kernels.placement_score import ref as t_ref  # noqa: E402

F32 = np.float32


def make_inputs(seed, N=3, R=96, X=12):
    """Batched numpy inputs with slack-boundary and feed-less rows."""
    rng = np.random.default_rng(seed)
    feeds = rng.integers(0, X, (N, R, 4)).astype(np.int32)
    nfeeds = rng.integers(1, 5, (N, R)).astype(np.int32)
    feeds = np.where(np.arange(4)[None, None, :] < nfeeds[..., None],
                     feeds, -1).astype(np.int32)
    nofeed = rng.random((N, R)) < 0.1                  # all-invalid rows
    feeds[nofeed] = -1
    nfeeds[nofeed] = 0
    cap = rng.choice([625.0, 2500.0], (N, X)).astype(F32)
    tot = (cap * rng.uniform(0, 1.1, (N, X))).astype(F32)
    ha = (tot * rng.uniform(0, 1, (N, X))).astype(F32)
    row_cap = np.zeros((N, R, 4), F32)
    row_cap[..., 0] = rng.choice([0.0, 625.0, 2500.0], (N, R))
    row_load = (row_cap * rng.uniform(0, 1.05, (N, R, 4))).astype(F32)
    p = rng.choice([30.0, 180.0, 410.0, 1200.0], N).astype(F32)
    # rows exactly on the slack: load + P == cap + 1e-4 in float32 (loads
    # stay non-negative, as a placement state's do)
    row_edge = (row_cap[..., 0] + F32(1e-4)) - p[:, None]
    edge = (rng.random((N, R)) < 0.2) & (row_edge >= 0)
    row_load[..., 0] = np.where(edge, row_edge, row_load[..., 0])
    # line-ups exactly on the slack of the block check
    lu_edge = (cap + F32(1e-4)) - p[:, None]
    tot = np.where((rng.random((N, X)) < 0.3) & (lu_edge >= 0), lu_edge,
                   tot).astype(F32)
    ha_frac = rng.choice([0.75, 0.8, 1.0], N).astype(F32)
    is_ha = rng.random(N) < 0.6
    is_block = rng.random(N) < 0.5
    return dict(row_feeds=feeds, row_nfeeds=nfeeds, row_cap=row_cap,
                row_load=row_load, lineup_ha=ha, lineup_tot=tot,
                lineup_cap=cap, p_dep=p, ha_frac=ha_frac, is_ha=is_ha,
                is_block=is_block)


def port(inputs, **kw):
    args = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in inputs.items()}
    feas, score = t_ops.score_rows(**args, **kw)
    return feas.numpy(), score.numpy()


def repro_config(inputs, n, interpret_kernel):
    """One configuration through `repro`: its Pallas kernel in interpret
    mode (jitted) or its jnp oracle (eager)."""
    g = {k: v[n] for k, v in inputs.items()}
    if interpret_kernel:
        feas, score = r_ops.score_rows(
            g["row_feeds"], g["row_nfeeds"], g["row_cap"][:, 0],
            g["lineup_ha"], g["lineup_tot"], g["lineup_cap"],
            g["row_load"][:, 0], g["p_dep"], g["ha_frac"], g["is_ha"],
            g["is_block"], interpret=True)
        return np.asarray(feas), np.asarray(score)
    valid = g["row_feeds"] >= 0
    safe = np.where(valid, g["row_feeds"], 0)
    params = jnp.asarray([g["p_dep"], g["ha_frac"], F32(g["is_ha"]),
                          F32(g["is_block"])], jnp.float32)
    feas, score = r_ref.reference_score(
        jnp.asarray(g["lineup_ha"][safe]), jnp.asarray(g["lineup_tot"][safe]),
        jnp.asarray(g["lineup_cap"][safe]), jnp.asarray(valid, jnp.float32),
        jnp.asarray(g["row_nfeeds"]), jnp.asarray(g["row_load"][:, 0]),
        jnp.asarray(g["row_cap"][:, 0]), params)
    return np.asarray(feas) > 0, np.asarray(score)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("interpret_kernel", [False, True],
                         ids=["oracle", "pallas_interpret"])
def test_reference_score_matches_repro(seed, interpret_kernel):
    inputs = make_inputs(seed)
    feas, score = port(inputs)
    assert feas.dtype == np.bool_ and score.dtype == np.float32
    for n in range(feas.shape[0]):
        r_feas, r_score = repro_config(inputs, n, interpret_kernel)
        np.testing.assert_array_equal(feas[n], r_feas)
        np.testing.assert_array_equal(score[n][~feas[n]], F32(t_ref.BIG))
        if interpret_kernel:
            np.testing.assert_allclose(score[n][feas[n]], r_score[feas[n]],
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(score[n][feas[n]],
                                          r_score[feas[n]])


def test_inputs_cover_the_slack_and_feedless_rows():
    """The parity inputs really exercise the boundary: some rows sit on
    the row slack and pass, and feed-less rows pass the power check."""
    inputs = make_inputs(0)
    feas, _ = port(inputs)
    row = inputs["row_load"][..., 0] + inputs["p_dep"][:, None]
    on_edge = row == inputs["row_cap"][..., 0] + F32(1e-4)
    assert (on_edge & feas).any()
    nofeed = inputs["row_nfeeds"] == 0
    assert (nofeed & feas).any()


def test_cpu_tensors_take_the_plain_version():
    inputs = make_inputs(5)
    before = t_kernel.placement_score.launches
    feas, score = port(inputs)
    ref = t_ref.reference_score(**{k: torch.from_numpy(v)
                                   for k, v in inputs.items()})
    np.testing.assert_array_equal(feas, ref[0].numpy())
    assert score.tobytes() == ref[1].numpy().tobytes()
    feas_i, score_i = port(inputs, interpret=True)
    assert score_i.tobytes() == score.tobytes()
    assert t_kernel.placement_score.launches == before


@pytest.mark.parametrize("name", ["row_cap", "row_load", "lineup_ha",
                                  "lineup_tot", "lineup_cap", "p_dep",
                                  "ha_frac"])
def test_score_rows_rejects_float64(name):
    inputs = make_inputs(1)
    inputs[name] = inputs[name].astype(np.float64)
    with pytest.raises(TypeError, match=name):
        port(inputs)


def test_kernel_refuses_cpu_tensors():
    args = {k: torch.from_numpy(v) for k, v in make_inputs(2).items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.placement_score(**args)

"""Parity of the port's batched placement engine with `repro.core.placement`.

Both packages place the same numpy-seeded arrival sequences; `repro`
runs eagerly (op by op, as its own placement tests do), so every float32
operation rounds as the port's does.  Held bitwise: chosen rows, `ok`
flags, every `HallState` leaf after every step, the released state of
`release_bulk`, and hall/line-up stranding.  Deployed power is a sum over
rows; XLA sums in its own order, so it is held to rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import placement as r_pl  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import placement as t_pl  # noqa: E402
from repro_torch.core import prng  # noqa: E402

DESIGNS = ("4N/3", "3+1", "10N/8", "8+2")       # both design families
POLICIES = (r_pl.POLICY_ROUND_ROBIN, r_pl.POLICY_MIN_WASTE,
            r_pl.POLICY_VAR_MIN)
STEPS = 40


def topologies(name, halls=2):
    kw = dict(rows_per_hall=100, lineups_per_hall=10)
    r_topo = r_hier.build_topology(r_hier.get_design(name), halls, **kw)
    t_topo = t_hier.build_topology(t_hier.get_design(name), halls, **kw)
    return r_topo, r_pl.jax_topology(r_topo), t_pl.topology([t_topo], "cpu")


def arrivals(seed, n):
    """(rack_kw, n_racks, is_gpu, tier) per step, from numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gpu = rng.random() < 0.5
        kw = np.float32(rng.uniform(150, 900) if gpu else
                        rng.uniform(15, 45))
        nr = 1 if gpu else int(rng.integers(2, 11))
        out.append((kw, nr, gpu, int(rng.random() < 0.3)))
    return out


def t_dep(items):
    return t_pl.Deployment(
        torch.tensor([i[0] for i in items], dtype=torch.float32),
        torch.tensor([i[1] for i in items], dtype=torch.int32),
        torch.tensor([i[2] for i in items]),
        torch.tensor([i[3] for i in items], dtype=torch.int32),
        torch.zeros(len(items), dtype=torch.bool))


def assert_state_equal(r_state, t_state, n=0):
    for name, a, b in zip(r_pl.HallState._fields, r_state, t_state):
        a = np.asarray(a)
        b = b[n].numpy().astype(a.dtype)
        assert a.tobytes() == b.tobytes(), name


def run_reference(jt, topo, steps, policy, state=None):
    state = r_pl.init_state(topo) if state is None else state
    out = []
    for t, (kw, nr, gpu, tier) in enumerate(steps):
        active = jnp.asarray(np.asarray(topo.row_hall) < 1 + (t >= STEPS // 2))
        dep = r_pl.Deployment.make(kw, nr, gpu, tier)
        state, ok, row = r_pl.place_in_row(jt, state, dep, dep.n_racks,
                                           policy, jax.random.PRNGKey(0),
                                           active)
        out.append((state, bool(ok), int(row)))
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", DESIGNS)
def test_place_in_row_bitwise(name, policy):
    topo, jt, tt = topologies(name)
    steps = arrivals(POLICIES.index(policy) * 10 + DESIGNS.index(name),
                     STEPS)
    ref = run_reference(jt, topo, steps, policy)
    state = t_pl.init_state(tt)
    pol = t_pl.policy_tensor([policy], "cpu")
    hall = torch.as_tensor(np.asarray(topo.row_hall))[None]
    n_ok = 0
    for t, (item, (r_state, r_ok, r_row)) in enumerate(zip(steps, ref)):
        dep = t_dep([item])
        state, ok, row = t_pl.place_in_row(tt, state, dep, dep.n_racks, pol,
                                           hall < 1 + (t >= STEPS // 2))
        assert (bool(ok[0]), int(row[0])) == (r_ok, r_row), t
        assert_state_equal(r_state, state)
        n_ok += r_ok
    assert 0 < n_ok                      # the sequence really places


def test_batched_configurations_match_one_by_one():
    """Three configurations in one batch (different designs, policies and
    arrivals) give each configuration's own sequential result."""
    names = ("4N/3", "3+1", "10N/8")
    tops = [topologies(n) for n in names]
    tt = t_pl.topology([t_hier.build_topology(
        t_hier.get_design(n), 2, rows_per_hall=100, lineups_per_hall=10)
        for n in names], "cpu")
    seqs = [arrivals(40 + i, STEPS) for i in range(3)]
    refs = [run_reference(jt, topo, seq, pol)
            for (topo, jt, _), seq, pol in zip(tops, seqs, POLICIES)]
    state = t_pl.init_state(tt)
    pol = t_pl.policy_tensor(POLICIES, "cpu")
    hall = tt.row_hall
    for t in range(STEPS):
        dep = t_dep([s[t] for s in seqs])
        state, ok, row = t_pl.place_in_row(tt, state, dep, dep.n_racks, pol,
                                           hall < 1 + (t >= STEPS // 2))
        for n in range(3):
            r_state, r_ok, r_row = refs[n][t]
            assert (bool(ok[n]), int(row[n])) == (r_ok, r_row), (n, t)
            assert_state_equal(r_state, state, n)


def test_place_cluster_in_row_registry_bitwise():
    """The [N, MAX_POD_RACKS] rows/counts registry convention."""
    topo, jt, tt = topologies("8+2")
    r_state, t_state = r_pl.init_state(topo), t_pl.init_state(tt)
    pol = t_pl.policy_tensor([r_pl.POLICY_MIN_WASTE], "cpu")
    active = np.asarray(topo.row_hall) < 1
    for item in arrivals(21, 12):
        dep = r_pl.Deployment.make(*item)
        r_state, ok, rows, counts, row = r_pl.place_cluster_in_row(
            jt, r_state, dep, r_pl.POLICY_MIN_WASTE, jax.random.PRNGKey(0),
            jnp.asarray(active))
        t_state, t_ok, t_rows, t_counts, t_row = t_pl.place_cluster_in_row(
            tt, t_state, t_dep([item]), pol, torch.from_numpy(active)[None])
        assert bool(ok) == bool(t_ok[0]) and int(row) == int(t_row[0])
        np.testing.assert_array_equal(np.asarray(rows), t_rows[0].numpy())
        assert np.asarray(counts).tobytes() == t_counts[0].numpy().tobytes()
        assert_state_equal(r_state, t_state)


def test_live_mask_keeps_state():
    _, _, tt = topologies("4N/3")
    state = t_pl.init_state(tt)
    dep = t_dep([(np.float32(300.0), 1, True, 0)])
    pol = t_pl.policy_tensor([3], "cpu")
    active = torch.ones_like(tt.row_is_hd)
    st, ok, row = t_pl.place_in_row(tt, state, dep, dep.n_racks, pol,
                                    active, live=torch.tensor([False]))
    assert not bool(ok[0]) and int(row[0]) == -1
    for a, b in zip(st, state):
        assert torch.equal(a, b)


def test_argmin_ties_break_to_the_lowest_row():
    """In an empty hall every row of a class scores the same under
    var_min, so the choice is a tie; both packages take the lowest row."""
    topo, jt, tt = topologies("4N/3", halls=1)
    dep_r = r_pl.Deployment.make(np.float32(200.0), 1, True, 0)
    active = jnp.ones((topo.row_cap.shape[0],), bool)
    _, ok, row = r_pl.place_in_row(jt, r_pl.init_state(topo), dep_r, 1,
                                   r_pl.POLICY_VAR_MIN, jax.random.PRNGKey(0),
                                   active)
    dep = t_dep([(np.float32(200.0), 1, True, 0)])
    state = t_pl.init_state(tt)
    dem = t_pl._demand(dep, dep.n_racks)
    kfeas, var = t_pl._kernel_feas_scores(tt, state, dep, dem.P)
    feas = t_pl._row_fits(tt, state, dep, dem) & kfeas
    score = t_pl.row_scores(tt, state, dep, dep.n_racks,
                            t_pl.policy_tensor([3], "cpu"), var)
    best = score[0][feas[0]].min()
    tied = torch.nonzero(feas[0] & (score[0] == best))[:, 0]
    assert len(tied) > 1                 # a real tie
    _, t_ok, t_row = t_pl.place_in_row(tt, state, dep, dep.n_racks,
                                       t_pl.policy_tensor([3], "cpu"),
                                       torch.ones_like(tt.row_is_hd))
    assert int(t_row[0]) == int(tied[0]) == int(row)
    assert bool(t_ok[0]) and bool(ok)


@pytest.mark.parametrize("name", ["4N/3", "8+2"])
def test_release_bulk_bitwise(name):
    """Place 60 arrivals, then release random fractions of random
    registries (several events per row, padding slots, unplaced -1 rows)
    through both packages."""
    topo, jt, tt = topologies(name)
    steps = arrivals(7, 60)
    ref = run_reference(jt, topo, steps, r_pl.POLICY_VAR_MIN)
    r_state = ref[-1][0]
    t_state = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in r_state._asdict().items()}, "cpu")
    rng = np.random.default_rng(11)
    E, S = len(steps), 3
    rows = np.full((E, S), -1, np.int32)
    counts = np.zeros((E, S), np.float32)
    rows[:, 0] = [r for _, _, r in ref]
    counts[:, 0] = [nr if ok else 0 for (_, nr, _, _), (_, ok, _) in
                    zip(steps, ref)]
    extra = rng.random(E) < 0.3          # a second registry slot
    rows[extra, 1] = rows[extra, 0]
    counts[extra, 1] = 1.0
    kw = np.array([s[0] for s in steps], np.float32)
    gpu = np.array([s[2] for s in steps])
    tier = np.array([s[3] for s in steps], np.int32)
    frac = np.where(rng.random(E) < 0.5,
                    rng.choice([0.1, 0.15, 0.9, 1.0], E), 0.0) \
        .astype(np.float32)
    a = r_pl.release_bulk(jt, r_state, jnp.asarray(rows), jnp.asarray(counts),
                          jnp.asarray(kw), jnp.asarray(gpu),
                          jnp.asarray(tier), jnp.asarray(frac))
    t = lambda x: torch.from_numpy(x)[None]
    b = t_pl.release_bulk(tt, t_state, t(rows), t(counts), t(kw), t(gpu),
                          t(tier), t(frac))
    assert_state_equal(a, b)
    # stranding metrics read the released state bitwise; deployed power is
    # a sum over rows in XLA's order
    np.testing.assert_array_equal(np.asarray(r_pl.hall_stranding(jt, a)),
                                  t_pl.hall_stranding(tt, b)[0].numpy())
    np.testing.assert_array_equal(np.asarray(r_pl.lineup_stranding(jt, a)),
                                  t_pl.lineup_stranding(tt, b)[0].numpy())
    np.testing.assert_allclose(t_pl.deployed_kw(b)[0].item(),
                               float(r_pl.deployed_kw(a)), rtol=1e-6)


def test_random_policy_is_not_ported():
    """`policy_tensor` takes every id in [0, 4), the random policy's
    included, and rejects the others."""
    assert t_pl.policy_tensor([0, 1, 2, 3], "cpu").tolist() == [0, 1, 2, 3]
    for bad in (7, 4, -1):
        with pytest.raises(ValueError):
            t_pl.policy_tensor([r_pl.POLICY_RANDOM, bad], "cpu")


@pytest.mark.parametrize("seed", [0, 5, 61])
def test_row_scores_random_column_matches_repro(seed):
    """The random policy's scores, `uniform(key, (R,))` under `repro`'s
    `jnp.select`, plus the LD-row preference, at every row."""
    topo, jt, tt = topologies("10N/8")
    steps = arrivals(seed, 6)
    r_state = run_reference(jt, topo, steps, r_pl.POLICY_VAR_MIN)[-1][0]
    t_state = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in r_state._asdict().items()}, "cpu")
    R = topo.row_cap.shape[0]
    for t, item in enumerate(arrivals(seed + 100, 4)):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        dep = r_pl.Deployment.make(*item)
        want = r_pl.row_scores(jt, r_state, dep, dep.n_racks,
                               r_pl.POLICY_RANDOM, key)
        d = t_dep([item])
        dem = t_pl._demand(d, d.n_racks)
        _, var = t_pl._kernel_feas_scores(tt, t_state, d, dem.P)
        rand = prng.uniform(prng.fold_in(prng.prng_key(seed), t), R)[None]
        got = t_pl.row_scores(tt, t_state, d, d.n_racks,
                              t_pl.policy_tensor([0], "cpu"), var, rand)
        assert np.asarray(want).tobytes() == got[0].numpy().tobytes(), t


@pytest.mark.parametrize("name", DESIGNS)
def test_random_policy_places_bitwise(name):
    """Step t keys by ``fold_in(PRNGKey(3), t)`` in both packages."""
    topo, jt, tt = topologies(name)
    R = topo.row_cap.shape[0]
    r_state, state = r_pl.init_state(topo), t_pl.init_state(tt)
    pol = t_pl.policy_tensor([r_pl.POLICY_RANDOM], "cpu")
    hall = np.asarray(topo.row_hall)
    n_ok = 0
    for t, item in enumerate(arrivals(DESIGNS.index(name) + 50, STEPS)):
        active = hall < 1 + (t >= STEPS // 2)
        dep = r_pl.Deployment.make(*item)
        r_state, r_ok, r_row = r_pl.place_in_row(
            jt, r_state, dep, dep.n_racks, r_pl.POLICY_RANDOM,
            jax.random.fold_in(jax.random.PRNGKey(3), t), jnp.asarray(active))
        d = t_dep([item])
        rand = prng.uniform(prng.fold_in(prng.prng_key(3), t), R)[None]
        state, ok, row = t_pl.place_in_row(
            tt, state, d, d.n_racks, pol, torch.from_numpy(active)[None],
            rand=rand)
        assert (bool(ok[0]), int(row[0])) == (bool(r_ok), int(r_row)), t
        assert_state_equal(r_state, state)
        n_ok += bool(r_ok)
    assert 0 < n_ok


def test_convert_round_trip_places_like_the_reference():
    topo, jt, _ = topologies("10N/8")
    tt = convert.topology_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()}, "cpu")
    direct = t_pl.topology([t_hier.build_topology(
        t_hier.get_design("10N/8"), 2, rows_per_hall=100,
        lineups_per_hall=10)], "cpu")
    for a, b in zip(tt, direct):
        assert a.dtype == b.dtype and torch.equal(a, b)
    leaves = {k: np.asarray(v) for k, v in jt._asdict().items()}
    leaves["lineup_hall"] = leaves["lineup_hall"][::-1]
    with pytest.raises(ValueError, match="contiguous blocks"):
        convert.topology_from_numpy(leaves, "cpu")
    with pytest.raises(TypeError):
        convert.state_from_numpy({"row_load": np.zeros((5, 4)),
                                  "lineup_ha": np.zeros(3, np.float32),
                                  "lineup_tot": np.zeros(3, np.float32),
                                  "hall_liq": np.zeros(1, np.float32),
                                  "rr_cursor": np.zeros((), np.int32)},
                                 "cpu")


def test_tree_sum_is_a_fixed_pairwise_order():
    x = torch.tensor([[1e8, 1.0, -1e8, 1.0, 3.0]], dtype=torch.float32)
    # zero-padded to 8, then halved: [1e8+3, 1, -1e8, 1] (the 3 rounds
    # away), [0, 2], [2]
    assert t_pl.tree_sum(x).item() == 2.0
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random((3, 37)).astype(np.float32))
    np.testing.assert_allclose(t_pl.tree_sum(y).numpy(),
                               y.double().sum(-1).numpy(), rtol=1e-6)

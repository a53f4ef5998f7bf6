"""Parity of the port's multi-row GPU pods with `repro`.

Placement: `_place_pod` over every row and over the HD-compacted view
(`hd_subset`), `place` (the reference's `lax.cond(is_pod, …)`) and
`remove_from_row`, against `repro` run eagerly, op by op, as its own
placement tests run it.  Held bitwise: `ok`, the registry rows and
counts, every `HallState` leaf.

The fleet: the split-trace pod windows and the `legacy_pod_cond=True`
path through `sweep` and `run_fleet`, against `repro`'s jitted, vmapped
lifecycle on byte-identical traces, under all four policies.  Held
bitwise: every registry row and count (recorded from inside `repro`'s
scan), halls built, monthly active halls, placed fraction, final hall
stranding.  Held to rtol 1e-6: deployed power (XLA sums rows in its own
order) and the stranding percentiles and line-up stranding (XLA may fuse
``a·b ± c`` into one rounding inside `jit`), as
`tests/test_torch_sweep.py` holds the pod-free sweep.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import arrivals as r_arr  # noqa: E402
from repro.core import fleet as r_fleet  # noqa: E402
from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import placement as r_pl  # noqa: E402
from repro.core import sweep as r_sweep  # noqa: E402
from repro_torch.core import arrivals as t_arr  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import placement as t_pl  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402

HALLS = dict(rows_per_hall=100, lineups_per_hall=10)
# `repro`'s pod scan compiled once per shape and static scan length (its
# `lax.scan` body compiles either way; a pod rack's n·d is exact)
r_place_pod = jax.jit(r_pl._place_pod,
                      static_argnames=("max_racks", "hd_scan", "use_kernel",
                                       "interpret"))
r_place = jax.jit(r_pl.place, static_argnames=("use_kernel", "interpret"))


def topologies(name, halls=2):
    r_topo = r_hier.build_topology(r_hier.get_design(name), halls, **HALLS)
    t_topo = t_hier.build_topology(t_hier.get_design(name), halls, **HALLS)
    return r_topo, r_pl.jax_topology(r_topo), t_topo


def t_dep(kw, n, gpu=None, tier=None, pod=None):
    """A port `Deployment` of per-configuration lists (default: HA GPU
    pods)."""
    N = len(kw)
    return t_pl.Deployment(
        torch.tensor(kw, dtype=torch.float32),
        torch.tensor(n, dtype=torch.int32),
        torch.tensor(gpu or [True] * N),
        torch.tensor(tier or [0] * N, dtype=torch.int32),
        torch.tensor(pod or [True] * N))


def assert_state_equal(r_state, t_state, n=0):
    for name, a, b in zip(r_pl.HallState._fields, r_state, t_state):
        a = np.asarray(a)
        assert a.tobytes() == b[n].numpy().astype(a.dtype).tobytes(), name


def rack_draws(key, n_rows, racks=t_pl.MAX_POD_RACKS):
    """[racks, 1, R] draws of one pod: rack i keyed by fold_in(key, i)."""
    k = torch.as_tensor(np.asarray(key).astype(np.int64))
    steps = torch.arange(racks)[:, None]
    return prng.uniform(prng.fold_in(k[None], steps), n_rows)


@pytest.mark.parametrize("name", ["10N/8", "8+2"])
@pytest.mark.parametrize("policy", range(4))
def test_place_pod_compacted_and_full_match_repro(name, policy):
    """`_place_pod` over all rows and over `hd_subset` equals `repro`'s
    (full and `hd_scan`) bitwise, until the hall is full: the port's
    version of `test_compacted_pod_scan_matches_full`."""
    topo, jt, t_topo = topologies(name)
    tt = t_pl.topology([t_topo], "cpu")
    R = topo.row_cap.shape[0]
    sub = t_pl.hd_subset(tt, t_topo.n_hd_rows)
    assert sub.rows.shape == (1, topo.n_hd_rows)
    active = jnp.asarray(np.asarray(topo.row_hall) < 1)
    t_active = torch.from_numpy(np.asarray(topo.row_hall) < 1)[None]
    pol = t_pl.policy_tensor([policy], "cpu")
    r_st = r_pl.init_state(topo)
    states = {"full": t_pl.init_state(tt), "hd": t_pl.init_state(tt)}
    key = jax.random.PRNGKey(7 + policy)
    n_ok = n_fail = 0
    for i in range(24):
        n = (3, 5, 7)[i % 3]
        k = jax.random.fold_in(key, i)
        dep = r_pl.Deployment.make(600.0, n, is_gpu=True, is_pod=True)
        want = {"full": r_place_pod(jt, r_st, dep, policy, k, active),
                "hd": r_place_pod(jt, r_st, dep, policy, k, active,
                                  hd_scan=topo.n_hd_rows)}
        rand = rack_draws(k, R) if policy == 0 else None
        for view, subset in (("full", None), ("hd", sub)):
            st, ok, rows, counts = t_pl._place_pod(
                tt, states[view], t_dep([600.0], [n]), pol, t_active,
                max_racks=n, subset=subset, rand=rand)
            w_st, w_ok, w_rows, w_counts = want[view]
            assert bool(ok[0]) == bool(w_ok), (view, i)
            np.testing.assert_array_equal(rows[0].numpy(), np.asarray(w_rows))
            assert counts[0].numpy().tobytes() == \
                np.asarray(w_counts).tobytes()
            assert_state_equal(w_st, st)
            states[view] = st
        r_st = want["hd"][0]
        n_ok += bool(w_ok)
        n_fail += not bool(w_ok)
    assert n_ok > 0 and n_fail > 0     # the hall fills up


def test_place_pod_batched_mixed_sizes_and_liveness():
    """One batch of pods of 3, 5 and 7 racks and a configuration that is
    not live, on two designs, with the rack scan as long as the largest
    pod: each configuration gets its own sequential `repro` result; the
    dead one keeps its state and reports no placement."""
    names, sizes = ("10N/8", "8+2", "10N/8", "8+2"), (3, 5, 7, 5)
    refs = [topologies(n) for n in names]
    tt = t_pl.topology([t for _, _, t in refs], "cpu")
    hd_scan = max(t.n_hd_rows for _, _, t in refs)
    sub = t_pl.hd_subset(tt, hd_scan)
    pol = t_pl.policy_tensor([3, 2, 1, 3], "cpu")
    live = torch.tensor([True, True, True, False])
    active = tt.row_hall < 1
    r_states = [r_pl.init_state(t) for t, _, _ in refs]
    state = t_pl.init_state(tt)
    for i in range(10):
        dep = t_dep([600.0, 450.0, 300.0, 600.0], list(sizes))
        st, ok, rows, counts = t_pl._place_pod(
            tt, state, dep, pol, active, live=live, max_racks=7, subset=sub)
        for n in range(3):
            topo, jt, _ = refs[n]
            r_dep = r_pl.Deployment.make(float(dep.rack_kw[n]), sizes[n],
                                         is_gpu=True, is_pod=True)
            w = r_place_pod(jt, r_states[n], r_dep, int(pol[n]),
                            jax.random.PRNGKey(0),
                            jnp.asarray(np.asarray(topo.row_hall) < 1),
                            max_racks=7, hd_scan=hd_scan)
            r_states[n] = w[0]
            assert bool(ok[n]) == bool(w[1]), (n, i)
            np.testing.assert_array_equal(rows[n].numpy(), np.asarray(w[2]))
            assert counts[n].numpy().tobytes() == np.asarray(w[3]).tobytes()
            assert_state_equal(w[0], st, n)
        assert not bool(ok[3]) and (rows[3] == -1).all()
        for a, b in zip(st, state):
            assert torch.equal(a[3], b[3])
        state = st


def test_pod_atomic_and_same_domain():
    """A pod lands whole in one power domain or not at all: the port's
    version of `repro`'s `test_pod_atomic_and_same_domain`, plus a pod too
    large for any domain, which leaves the state as it was."""
    t_topo = t_hier.build_topology(t_hier.get_design("10N/8"))
    tt = t_pl.topology([t_topo], "cpu")
    state = t_pl.init_state(tt)
    pol = t_pl.policy_tensor([3], "cpu")
    active = torch.ones_like(tt.row_is_hd)
    st, ok, rows, counts = t_pl._place_pod(tt, state, t_dep([600.0], [5]),
                                           pol, active)
    assert bool(ok[0]) and float(counts.sum()) == 5.0
    landed = rows[0][rows[0] >= 0]
    assert len(set(t_topo.row_domain[landed.numpy()].tolist())) == 1
    big, okb, rows_b, counts_b = t_pl._place_pod(
        tt, st, t_dep([6000.0], [7]), pol, active)
    assert not bool(okb[0]) and (rows_b == -1).all() and \
        float(counts_b.sum()) == 0.0
    for a, b in zip(big, st):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", range(4))
def test_place_matches_repro(policy):
    """`place`, the reference's per-event `lax.cond(is_pod, …)`, on a
    mixed sequence of clusters and pods: `ok`, rows and counts bitwise
    `repro`'s `place`, every state leaf bitwise the branch the cond
    selects (`place_cluster_in_row` or `_place_pod`).  The compiled cond
    itself fuses a cluster's ``load + n·d`` into one rounding, so its
    row and liquid loads can differ from the branch's in the last bit."""
    topo, jt, t_topo = topologies("8+2")
    tt = t_pl.topology([t_topo], "cpu")
    R = topo.row_cap.shape[0]
    pol = t_pl.policy_tensor([policy], "cpu")
    rng = np.random.default_rng(policy)
    r_st, st = r_pl.init_state(topo), t_pl.init_state(tt)
    active = np.asarray(topo.row_hall) < 1
    n_pods = 0
    for i in range(40):
        pod = bool(rng.random() < 0.4)
        kw = np.float32(rng.uniform(200, 700) if pod else
                        rng.uniform(15, 45))
        n = int(rng.choice([3, 5, 7])) if pod else int(rng.integers(2, 11))
        k = jax.random.fold_in(jax.random.PRNGKey(policy), i)
        dep = r_pl.Deployment.make(kw, n, is_gpu=pod, tier=i % 2,
                                   is_pod=pod)
        _, w_ok, w_rows, w_counts = r_place(jt, r_st, dep, policy, k,
                                            jnp.asarray(active))
        r_st = (r_place_pod(jt, r_st, dep, policy, k, jnp.asarray(active))
                if pod else r_pl.place_cluster_in_row(
                    jt, r_st, dep, policy, k, jnp.asarray(active)))[0]
        rand = pod_rand = None
        if policy == 0:
            kk = torch.as_tensor(np.asarray(k).astype(np.int64))
            rand = prng.uniform(kk, R)[None]
            pod_rand = rack_draws(k, R)
        st, ok, rows, counts = t_pl.place(
            tt, st, t_dep([kw], [n], [pod], [i % 2], [pod]), pol,
            torch.from_numpy(active)[None], rand=rand, pod_rand=pod_rand,
            max_racks=n if pod else 0)
        assert bool(ok[0]) == bool(w_ok), i
        np.testing.assert_array_equal(rows[0].numpy(), np.asarray(w_rows))
        assert counts[0].numpy().tobytes() == np.asarray(w_counts).tobytes()
        assert_state_equal(r_st, st)
        n_pods += pod and bool(w_ok)
    assert n_pods > 0


def test_remove_from_row_matches_repro():
    """`remove_from_row` (no caller in `repro`) after a placed sequence:
    whole and fractional releases, HA and LA tiers, GPU and non-GPU."""
    topo, jt, t_topo = topologies("4N/3")
    tt = t_pl.topology([t_topo] * 4, "cpu")
    r_st = r_pl.init_state(topo)
    for i in range(30):
        dep = r_pl.Deployment.make(np.float32(40.0 + i), 4, is_gpu=i % 3 == 0,
                                   tier=i % 2)
        r_st, *_ = r_pl.place(jt, r_st, dep, r_pl.POLICY_VAR_MIN,
                              jax.random.PRNGKey(0))
    st = t_pl.HallState(*(torch.as_tensor(np.array(x))[None]
                          .repeat((4,) + (1,) * np.ndim(x)) for x in r_st))
    rows = [int(r) for r in np.flatnonzero(
        np.asarray(r_st.row_load)[:, 0] > 0)[:4]]
    args = dict(rack_kw=[40.0, 1200.0, 33.5, 80.0], is_gpu=[False, True,
                                                            False, True],
                tier=[0, 1, 1, 0], n=[2, 1, 3, 1], frac=[1.0, 0.15, 0.5,
                                                         0.9])
    got = t_pl.remove_from_row(
        tt, st, torch.tensor(args["rack_kw"]), torch.tensor(args["is_gpu"]),
        torch.tensor(args["tier"], dtype=torch.int32), torch.tensor(rows),
        torch.tensor(args["n"], dtype=torch.int32),
        torch.tensor(args["frac"]))
    for c in range(4):
        want = r_pl.remove_from_row(
            jt, r_st, np.float32(args["rack_kw"][c]), args["is_gpu"][c],
            args["tier"][c], rows[c], args["n"][c], args["frac"][c])
        assert_state_equal(want, got, c)


# ---------------------------------------------------------------------------
# the fleet: split-trace windows and the legacy per-event cond
# ---------------------------------------------------------------------------

POLICIES = (0, 1, 2, 3)


def pod_axes(hier, arr, sweep_mod, scale=0.005):
    """`repro`'s `test_split_trace_matches_legacy_pod_cond` grid (10N/8
    with pods of 3, 8+2 with pods of 5, seeds 3 and 4) under each of the
    four policies: 8 configurations."""
    combos = [(d, p, s, pol) for pol in POLICIES
              for d, p, s in (("10N/8", 3, 3), ("8+2", 5, 4))]
    return sweep_mod.SweepAxes.zip(
        [hier.get_design(d) for d, *_ in combos],
        [arr.EnvelopeSpec(demand_scale=scale, gpu_scenario="high",
                          pod_racks=p, pod_scale_arch=True)
         for _, p, _, _ in combos],
        policies=[c[3] for c in combos], seeds=[c[2] for c in combos])


def reference_lifecycle(monkeypatch, ax, legacy):
    """`repro`'s vmapped lifecycle on `ax` (its `sweep` path), with the
    month scan's final registry (rows, counts, placed) of every
    configuration recorded by a debug callback: `repro` keeps it in the
    scan carry and returns none of it.  The callbacks of a vmapped
    program come in no fixed order, so each carries its configuration's
    index."""
    args, months, topos, X_pad, with_pods, pod_len, hd_scan = \
        r_sweep._prepare(ax, 0, None, legacy)
    assert with_pods
    seen, tag = {}, []
    scan = jax.lax.scan

    def record(i, *carry):
        seen[int(i)] = tuple(np.asarray(x) for x in carry)

    def recording_scan(f, init, xs, *a, **k):
        out = scan(f, init, xs, *a, **k)
        if isinstance(init, tuple) and len(init) == 8:   # the month scan
            jax.debug.callback(record, tag[0], out[0][1], out[0][2],
                               out[0][3])
        return out

    def one(i, *a):
        tag[:] = [i]
        return r_fleet.simulate_lifecycle(
            *a, harvest=True, mature_months=12, with_pods=True,
            legacy_pod_cond=legacy, pod_scan_len=pod_len, hd_scan=hd_scan)

    monkeypatch.setattr(jax.lax, "scan", recording_scan)
    out = jax.block_until_ready(
        jax.jit(jax.vmap(one))(jnp.arange(len(ax)), *args))
    jax.effects_barrier()
    assert sorted(seen) == list(range(len(ax)))
    rows, counts, placed = (np.stack(x) for x in
                            zip(*(seen[i] for i in range(len(ax)))))
    return out, rows, counts, placed


@pytest.fixture(scope="module")
def pod_grids():
    ax = pod_axes(t_hier, t_arr, t_sweep)
    return {mode: t_sweep.sweep(ax, device="cpu",
                                legacy_pod_cond=mode == "legacy")
            for mode in ("split", "legacy")}


@pytest.mark.parametrize("mode", ["split", "legacy"])
def test_pod_sweep_matches_repro(pod_grids, monkeypatch, mode):
    """Every registry row and count bitwise `repro`'s, under all four
    policies (the random one draws its pod racks' keys), and the halls,
    placed fraction and hall stranding; the float columns to rtol 1e-6."""
    port = pod_grids[mode]
    out, rows, counts, placed = reference_lifecycle(
        monkeypatch, pod_axes(r_hier, r_arr, r_sweep), mode == "legacy")
    np.testing.assert_array_equal(port.reg_rows, rows)
    assert port.reg_counts.tobytes() == counts.tobytes()
    np.testing.assert_array_equal(port.reg_rows[..., 0] >= 0, placed)
    assert (counts.sum(-1) > 1).any() and (rows[..., 1] >= 0).any()
    np.testing.assert_array_equal(port.n_halls_built, out.n_halls_built)
    np.testing.assert_array_equal(port.halls_active, out.halls_active)
    assert port.placed_fraction.tobytes() == \
        np.asarray(out.placed_fraction).tobytes()
    np.testing.assert_array_equal(port.final_hall_stranding,
                                  out.final_hall_stranding)
    for f, g in (("deployed_mw", "deployed_kw"),
                 ("p50_stranding", "p50_stranding"),
                 ("p90_stranding", "p90_stranding"),
                 ("final_lineup_stranding", "final_lineup_stranding")):
        want = np.asarray(getattr(out, g)) / (1e3 if g == "deployed_kw"
                                              else 1.0)
        np.testing.assert_allclose(getattr(port, f), want, rtol=1e-6,
                                   atol=0, err_msg=f)
    assert port.pod_steps > 0 and port.event_steps > port.pod_steps


def test_split_trace_matches_legacy_in_the_port(pod_grids):
    """The port's split-trace windows and its per-event cond place alike:
    every output bitwise, the registry included."""
    split, legacy = pod_grids["split"], pod_grids["legacy"]
    for f in ("n_halls_built", "halls_active", "deployed_mw",
              "p50_stranding", "p90_stranding", "final_hall_stranding",
              "final_lineup_stranding", "placed_fraction", "act_month",
              "reg_rows", "reg_counts"):
        a, b = getattr(split, f), getattr(legacy, f)
        assert a.tobytes() == b.tobytes(), f
    assert split.pod_steps == legacy.pod_steps
    assert legacy.event_steps > split.event_steps


@pytest.mark.parametrize("case", [("10N/8", 5, 3, 8, 60.0096, 0.990950,
                                   0.6386),
                                  ("3+1", 5, 9, 11, 35.8188, 0.978448,
                                   0.6239)])
def test_run_fleet_reproduces_the_pod_goldens(case):
    """`repro`'s `test_pod_golden_regression` numbers (pods of 5, HIGH,
    scale 0.01), at its tolerances, through the port's `run_fleet`."""
    dname, pod, seed, halls, dep, pf, p90 = case
    env = t_arr.EnvelopeSpec(demand_scale=0.01, gpu_scenario="high",
                             pod_racks=pod, pod_scale_arch=True)
    r = t_fleet.run_fleet(t_fleet.FleetConfig(t_hier.get_design(dname), env,
                                              seed=seed), device="cpu")
    assert r.n_halls_built == halls
    np.testing.assert_allclose(r.final_deployed_mw, dep, atol=0.01)
    np.testing.assert_allclose(r.placed_fraction, pf, atol=1e-4)
    np.testing.assert_allclose(float(r.p90_stranding[-1]), p90, atol=2e-3)


def test_pods_after_a_cluster_of_their_month_raise():
    """The split windows need pods first in each month, as `repro`'s."""
    env = t_arr.EnvelopeSpec(demand_scale=0.005, gpu_scenario="high",
                             pod_racks=3, pod_scale_arch=True)
    tr = t_arr.generate_fleet_trace(env, 0)
    pods = np.flatnonzero(tr.is_pod)
    e = pods[0]
    later = np.flatnonzero((tr.month == tr.month[e]) & ~tr.is_pod)
    assert len(later)
    order = np.arange(len(tr))
    order[[e, later[-1]]] = order[[later[-1], e]]
    bad = type(tr)(**{f: np.asarray(getattr(tr, f))[order]
                      for f in tr.__dataclass_fields__})
    with pytest.raises(ValueError, match="precede"):
        t_fleet._event_windows(bad, env.n_months, True)
    with pytest.raises(ValueError, match="precede"):
        r_fleet._event_windows(bad, env.n_months, True)

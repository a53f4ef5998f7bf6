"""Parity of the port's pod-free fleet sweep with `repro.core.sweep`
(pods: `tests/test_torch_pods.py`).

A 4-configuration grid (the four reference designs, three TDP scenarios,
the three ported policies) at demand_scale 0.005 runs through `repro`'s
jitted, vmapped `sweep` and through the port on the CPU, from the same
byte-identical traces.

Held bitwise: halls built, monthly active halls, hall activation months,
placed events, the registry row every event landed in, and final hall
stranding.  Held to rtol 1e-6, with the reason:

* monthly and final deployed kW: a float32 sum over all rows, which XLA
  adds in its own order (measured: it differs from a sequential sum and
  from `torch.sum` for row counts above 32); the port sums in a fixed
  pairwise order that is the same on the CPU and the card;
* p50/p90 stranding and line-up stranding: XLA may contract `a*b ± c`
  into one FMA inside `jit` (the percentile interpolation, `ha_frac·C −
  load`), the port rounds the product first;
* $/MW and the TPS columns: computed from deployed MW, and `repro`'s
  throughput evaluators run jitted (see test_torch_hostmodel.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.core import arrivals as r_arr  # noqa: E402
from repro.core import fleet as r_fleet  # noqa: E402
from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import placement as r_pl  # noqa: E402
from repro.core import sweep as r_sweep  # noqa: E402
from repro_torch.core import arrivals as t_arr  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import placement as t_pl  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402

NAMES = ("4N/3", "3+1", "10N/8", "8+2")
SCENARIOS = ("low", "med", "high", "high")
POLICIES = (3, 1, 2, 3)
SEEDS = (0, 1, 2, 3)
SCALE = 0.005


def axes(hier, arr, sweep_mod):
    return sweep_mod.SweepAxes.zip(
        [hier.get_design(n) for n in NAMES],
        [arr.EnvelopeSpec(demand_scale=SCALE, gpu_scenario=s)
         for s in SCENARIOS], policies=POLICIES, seeds=SEEDS)


@pytest.fixture(scope="module")
def grids():
    ref = r_sweep.sweep(axes(r_hier, r_arr, r_sweep))
    port = t_sweep.sweep(axes(t_hier, t_arr, t_sweep), device="cpu")
    return ref, port


def activation_months(halls_active, n_halls):
    """Hall h opens in the first month whose active count exceeds h."""
    out = np.full(n_halls, -1)
    for h in range(n_halls):
        hit = np.nonzero(halls_active > h)[0]
        if len(hit):
            out[h] = hit[0]
    return out


def test_decisions_bitwise(grids):
    ref, port = grids
    np.testing.assert_array_equal(port.n_halls_built, ref.n_halls_built)
    np.testing.assert_array_equal(port.halls_active, ref.halls_active)
    assert port.placed_fraction.tobytes() == \
        np.asarray(ref.placed_fraction, np.float32).tobytes()
    for i in range(len(NAMES)):
        np.testing.assert_array_equal(
            port.act_month[i],
            activation_months(ref.halls_active[i], port.act_month.shape[1]))
    np.testing.assert_array_equal(port.final_hall_stranding,
                                  ref.final_hall_stranding)
    assert port.event_steps > 0 and port.device == "cpu"


def test_float_outputs_rtol(grids):
    ref, port = grids
    for f in ("deployed_mw", "final_deployed_mw", "p50_stranding",
              "p90_stranding", "final_lineup_stranding", "initial_dpm",
              "effective_dpm", "total_capex", "provisioned_mw",
              "delivered_tps", "tps_per_provisioned_w", "dollars_per_tps"):
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(port, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
    assert port.model_names == ref.model_names
    r, p = ref.result(2), port.result(2)
    assert (r.n_halls_built, len(r.final_lineup_stranding)) == \
        (p.n_halls_built, len(p.final_lineup_stranding))


def reference_registry(monkeypatch, ax=None):
    """Every (row, ok) `repro`'s lifecycle decides, per configuration,
    recorded with an ordered debug callback from inside its jitted scan,
    mapped back to event ids through its month windows."""
    ax = ax or axes(r_hier, r_arr, r_sweep)
    args, *_ = r_sweep._prepare(ax, 0, None)
    idx, valid = np.asarray(args[2]), np.asarray(args[3])
    calls = []
    place = r_pl.place_cluster_in_row

    def recording(*a, **k):
        out = place(*a, **k)
        jax.debug.callback(lambda row, ok: calls.append((int(row), bool(ok))),
                           out[4], out[1], ordered=True)
        return out

    monkeypatch.setattr(r_pl, "place_cluster_in_row", recording)
    run = jax.jit(functools.partial(r_fleet.simulate_lifecycle, harvest=True,
                                    mature_months=12, with_pods=False))
    E = args[1].month.shape[1]
    rows = np.full((len(ax), E), -1)
    placed = np.zeros((len(ax), E), bool)
    for n in range(len(ax)):
        calls.clear()
        jax.block_until_ready(run(*jax.tree.map(lambda x: x[n], args)))
        jax.effects_barrier()
        assert len(calls) == idx[n].size
        for (row, ok), e, live in zip(calls, idx[n].ravel(),
                                      valid[n].ravel()):
            if live:
                placed[n, e] = ok
                if ok:
                    rows[n, e] = row
    return rows, placed


def test_registry_rows_bitwise(grids, monkeypatch):
    _, port = grids
    rows, placed = reference_registry(monkeypatch)
    np.testing.assert_array_equal(port.reg_rows[..., 0] >= 0, placed)
    np.testing.assert_array_equal(port.reg_rows[..., 0], rows)
    assert (port.reg_rows[..., 1:] == -1).all()
    assert placed.sum() > 100


def random_axes(hier, arr, sweep_mod):
    """The card golden's two configurations under the random policy."""
    return sweep_mod.SweepAxes.zip(
        [hier.get_design("4N/3"), hier.get_design("8+2")],
        [arr.EnvelopeSpec(demand_scale=SCALE, gpu_scenario="high")],
        policies=[0, 0], seeds=[3, 4])


def test_random_policy_sweep_matches_repro(monkeypatch):
    """Keys ``PRNGKey(int32(seed) + 1)``, ``fold_in`` by month and by
    event slot, one draw per row of the whole padded fleet: every chosen
    row bitwise."""
    ref = r_sweep.sweep(random_axes(r_hier, r_arr, r_sweep))
    port = t_sweep.sweep(random_axes(t_hier, t_arr, t_sweep), device="cpu")
    rows, placed = reference_registry(monkeypatch,
                                      random_axes(r_hier, r_arr, r_sweep))
    np.testing.assert_array_equal(port.reg_rows[..., 0], rows)
    np.testing.assert_array_equal(port.reg_rows[..., 0] >= 0, placed)
    np.testing.assert_array_equal(port.n_halls_built, ref.n_halls_built)
    np.testing.assert_array_equal(port.halls_active, ref.halls_active)
    np.testing.assert_array_equal(port.final_hall_stranding,
                                  ref.final_hall_stranding)
    for f in ("deployed_mw", "p50_stranding", "p90_stranding",
              "final_lineup_stranding", "effective_dpm", "delivered_tps"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f),
                                   rtol=1e-6, atol=0, err_msg=f)
    # not the default policy's run under another name
    var_min = t_sweep.sweep(t_sweep.SweepAxes.zip(
        random_axes(t_hier, t_arr, t_sweep).designs,
        [t_arr.EnvelopeSpec(demand_scale=SCALE, gpu_scenario="high")],
        seeds=[3, 4]), device="cpu")
    assert not np.array_equal(var_min.reg_rows, port.reg_rows)


def test_run_fleet_matches_repro():
    check_run_fleet(policy=1)


def test_run_fleet_random_policy_matches_repro():
    check_run_fleet(policy=0)


def check_run_fleet(policy):
    kw = dict(demand_scale=SCALE, gpu_scenario="high", la_fraction=0.2)
    a = r_fleet.run_fleet(r_fleet.FleetConfig(
        r_hier.get_design("3+1"), r_arr.EnvelopeSpec(**kw), policy=policy,
        seed=5))
    b = t_fleet.run_fleet(t_fleet.FleetConfig(
        t_hier.get_design("3+1"), t_arr.EnvelopeSpec(**kw), policy=policy,
        seed=5), device="cpu")
    assert a.n_halls_built == b.n_halls_built
    np.testing.assert_array_equal(a.halls_active, b.halls_active)
    assert np.float32(a.placed_fraction) == np.float32(b.placed_fraction)
    np.testing.assert_allclose(b.deployed_mw, a.deployed_mw, rtol=1e-6)
    np.testing.assert_allclose(b.p90_stranding, a.p90_stranding, rtol=1e-6)
    np.testing.assert_allclose(b.effective_dpm, a.effective_dpm, rtol=1e-6)


def test_unported_paths_raise():
    """The paths that raised before the pods and the streaming quantiles
    were ported now run (pods of 4 racks, split and through the
    per-event cond, and ``exact_quantiles=False``); a random-policy
    lifecycle without its seeds still raises."""
    design = t_hier.get_design("4N/3")
    pods = t_sweep.SweepAxes.zip(
        [design], [t_arr.EnvelopeSpec(demand_scale=SCALE, pod_racks=4)])
    split = t_sweep.sweep(pods, device="cpu")
    legacy = t_sweep.sweep(pods, device="cpu", legacy_pod_cond=True)
    assert split.pod_steps > 0
    assert split.reg_rows.tobytes() == legacy.reg_rows.tobytes()
    env = t_arr.EnvelopeSpec(demand_scale=SCALE)
    stream = t_sweep.sweep(t_sweep.SweepAxes.zip([design], [env]),
                           device="cpu", exact_quantiles=False,
                           quantile_bins=64)
    assert np.isfinite(stream.p90_stranding[:, -1]).all()
    prep = t_sweep._prepare(t_sweep.SweepAxes.zip([design], [env]), 0, None,
                            "cpu")
    with pytest.raises(ValueError, match="seeds"):
        t_fleet.simulate_lifecycle(
            prep.jt, prep.ft, *prep.windows,
            t_pl.policy_tensor([0], "cpu"), prep.h_caps, prep.n_real,
            harvest=True, mature_months=12)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = t_arr.EnvelopeSpec(demand_scale=SCALE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sweep.sweep(t_sweep.SweepAxes.zip([t_hier.get_design("4N/3")],
                                            [env]))


@pytest.mark.parametrize("case", ["empty", "policy", "horizon", "traces"])
def test_validation_matches_repro(case):
    def build(hier, arr, sweep_mod):
        d = hier.get_design("4N/3")
        e = arr.EnvelopeSpec(demand_scale=SCALE)
        if case == "empty":
            return sweep_mod.SweepAxes([], [], [], []), None
        if case == "policy":
            return sweep_mod.SweepAxes.zip([d], [e], policies=[9]), None
        if case == "horizon":
            return sweep_mod.SweepAxes.zip(
                [d, d], [e, arr.EnvelopeSpec(end_year=2030)]), None
        return sweep_mod.SweepAxes.zip([d, d], [e]), \
            [arr.generate_fleet_trace(e, 0)]

    with pytest.raises(r_hier.SweepValidationError) as ra:
        ax, traces = build(r_hier, r_arr, r_sweep)
        r_sweep._prepare(ax, 0, traces)
    with pytest.raises(t_hier.SweepValidationError) as ta:
        ax, traces = build(t_hier, t_arr, t_sweep)
        t_sweep.sweep(ax, traces=traces, device="cpu")
    assert ra.value.field == ta.value.field

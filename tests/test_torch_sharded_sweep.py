"""The port's sharded engines (`repro_torch.core.sweep.sharded_sweep`,
`repro_torch.core.mc_sweep.sharded_mc_sweep`, `repro_torch.sharding`)
against the port's unsharded engines and `repro`'s.

The device lists name the CPU more than once (``["cpu"] * 2``, ``["cpu"]
* 4``), so every split runs here: slabs of configurations or trials,
chunked and with remainders, the slabs in turn on the calling thread
as on the cards (`repro_torch.sharding.dispatch.run_slabs`).  Held
bitwise to the port's `sweep` / `mc_sweep` on the same grid: every
output field, registries included.  The fleet grid is also held to
`repro`'s unsharded `sweep` (which `repro`'s own tests hold equal to its
sharded engine) within the ROADMAP contracts: decisions and flags
bitwise, float columns within rtol 1e-6.  The MC grid is
`tests/test_torch_mc_sweep.py`'s "mixed" grid at its `MC_KW`, where the
port's `mc_sweep` is held to `repro`'s, so bitwise here is within those
contracts too.  The grids are `tests/test_torch_sweep.py`'s and
`tests/test_torch_mc_sweep.py`'s smallest.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.core import arrivals as r_arr  # noqa: E402
from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import sweep as r_sweep  # noqa: E402
from repro.sharding import axes as r_axes  # noqa: E402
from repro_torch.core import arrivals as t_arr  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import mc_sweep as t_mc  # noqa: E402
from repro_torch.core import payoff as t_pay  # noqa: E402
from repro_torch.core import scenarios as t_sc  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.sharding import axes as t_axes  # noqa: E402
from repro_torch.sharding import dispatch as t_dispatch  # noqa: E402

NAMES = ("4N/3", "3+1", "10N/8", "8+2")
SCENARIOS = ("low", "med", "high", "high")
POLICIES = (3, 1, 2, 3)
SEEDS = (0, 1, 2, 3)
SCALE = 0.005
SMALL = 0.003             # the grids checked against the port alone
MC_KW = dict(n_trials=4, n_events=150, year=2030, scenario="high")
POD_KW = dict(n_trials=3, n_events=80, year=2030, scenario="high",
              pod_racks=5)

SWEEP_FIELDS = ("halls_active", "deployed_mw", "p50_stranding",
                "p90_stranding", "final_hall_stranding",
                "final_lineup_stranding", "lineup_is_active",
                "n_halls_built", "final_deployed_mw", "placed_fraction",
                "initial_dpm", "effective_dpm", "total_capex",
                "provisioned_mw", "delivered_tps", "tps_per_provisioned_w",
                "dollars_per_tps", "act_month", "reg_rows", "reg_counts")
DECISIONS = ("n_halls_built", "halls_active", "final_hall_stranding")
FLOATS = ("deployed_mw", "final_deployed_mw", "p50_stranding",
          "p90_stranding", "final_lineup_stranding", "effective_dpm",
          "delivered_tps")
MC_FIELDS = ("lineup_stranding", "hall_stranding", "deployed_kw",
             "saturated", "placed_a", "placed_b", "rows_a", "counts_a",
             "rows_b", "counts_b", "ha_capacity_kw", "delivered_tps",
             "tps_per_provisioned_w", "dollars_per_tps")


def grid(hier, arr, sweep_mod):
    return sweep_mod.SweepAxes.zip(
        [hier.get_design(n) for n in NAMES],
        [arr.EnvelopeSpec(demand_scale=SCALE, gpu_scenario=s)
         for s in SCENARIOS], policies=POLICIES, seeds=SEEDS)


def grid7():
    """7 configurations (a chunk of 3 leaves a ragged last chunk; two
    slots leave a remainder)."""
    envs = [t_arr.EnvelopeSpec(demand_scale=SMALL, gpu_scenario=s,
                               end_year=2028) for s in ("med", "high")]
    return t_sweep.SweepAxes.zip(
        designs=[t_hier.get_design(("4N/3", "3+1")[i % 2])
                 for i in range(7)],
        envs=[envs[i % 2] for i in range(7)], policies=[3, 2, 1, 3, 0, 3, 2],
        seeds=range(7))


def pod_grid():
    return t_sweep.SweepAxes.zip(
        designs=[t_hier.get_design(n) for n in ("10N/8", "8+2", "10N/8")],
        envs=[t_arr.EnvelopeSpec(demand_scale=SCALE, gpu_scenario="high",
                                 end_year=2028, pod_racks=p,
                                 pod_scale_arch=True) for p in (5, 3, 1)],
        seeds=[0, 1, 2])


def mc_grid(hier, mc):
    """`tests/test_torch_mc_sweep.py`'s mixed grid."""
    return mc.MCAxes.zip(
        designs=[hier.get_design(n) for n in ("4N/3", "3+1", "10N/8")],
        policies=[3, 2, 3], seeds=[11, 11, 13])


def assert_bitwise(res, ref, fields, what):
    for f in fields:
        a, b = np.asarray(getattr(res, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f)
        assert a.tobytes() == b.tobytes(), (what, f)


@pytest.fixture(scope="module")
def fleet():
    return (r_sweep.sweep(grid(r_hier, r_arr, r_sweep)),
            t_sweep.sweep(grid(t_hier, t_arr, t_sweep), device="cpu"))


@pytest.mark.parametrize("kw", [
    dict(devices=["cpu"] * 2),
    dict(devices=["cpu"] * 4, mesh_shape=(2, 2)),
], ids=["two", "four_2x2"])
def test_sharded_sweep_is_sweep(fleet, kw):
    ref, one = fleet
    res = t_sweep.sharded_sweep(grid(t_hier, t_arr, t_sweep), **kw)
    assert_bitwise(res, one, SWEEP_FIELDS, kw)
    assert res.device == "cpu" and len(res) == len(NAMES)
    # each slab runs the steps its configurations are live in
    assert res.event_steps >= one.event_steps
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f))
    assert res.placed_fraction.tobytes() == \
        np.asarray(ref.placed_fraction, np.float32).tobytes()
    for f in FLOATS:
        np.testing.assert_allclose(getattr(res, f), np.asarray(
            getattr(ref, f)), rtol=1e-6, atol=0, err_msg=f)


def test_mesh_shapes_of_one_device_count_give_the_same_slabs():
    """`repro`'s `batch_spec`: a flat batch product-shards over both mesh
    axes in device order, whatever (dc, dt) multiplies out to D."""
    devs = ["cpu"] * 4
    want = t_axes.batch_slabs(t_axes.sweep_mesh(devs), 0, 10)
    assert [s[1:] for s in want] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    for shape in ((2, 2), (1, 4)):
        assert t_axes.batch_slabs(t_axes.sweep_mesh(devs, shape), 0,
                                  10) == want
    blocks = t_axes.grid_blocks(t_axes.sweep_mesh(devs, (2, 2)), 3, 5)
    assert [b[1:] for b in blocks] == [((0, 2), (0, 3)), ((0, 2), (3, 5)),
                                       ((2, 3), (0, 3)), ((2, 3), (3, 5))]


@pytest.fixture(scope="module")
def seven():
    return t_sweep.sweep(grid7(), device="cpu")


@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 2],
                         ids=["one_slot", "two_slots"])
def test_chunked_sweep_of_seven_is_sweep(seven, devices):
    """`chunk_size=3` on 7 configurations: chunks of 3, 3, 1 on one slot;
    of 4, 3 (rounded up to the device count) on two, the last split 2 +
    1 (B mod D ≠ 0)."""
    res = t_sweep.sharded_sweep(grid7(), devices=devices, chunk_size=3)
    assert_bitwise(res, seven, SWEEP_FIELDS, devices)


def test_pod_grid_streaming_quantiles_sharded():
    """A pod grid (pods of 5, 3 and single racks) with the streaming
    quantiles, over two slots in chunks of 2."""
    axes = pod_grid()
    kw = dict(exact_quantiles=False)
    one = t_sweep.sweep(axes, device="cpu", **kw)
    res = t_sweep.sharded_sweep(axes, devices=["cpu"] * 2, chunk_size=2,
                                **kw)
    assert_bitwise(res, one, SWEEP_FIELDS, "pods")
    assert 0 < res.pod_steps < res.event_steps


def test_one_device_and_one_configuration_pass_through(monkeypatch):
    """`repro`'s rule: one device and no `chunk_size`, or one
    configuration, is `sweep` itself."""
    calls = []
    real = t_sweep.sweep

    def spy(axes, **kw):
        calls.append((len(axes), kw["device"]))
        return real(axes, **kw)

    monkeypatch.setattr(t_sweep, "sweep", spy)
    monkeypatch.setattr(t_dispatch, "run_slabs", None)   # no sharded path
    env = t_arr.EnvelopeSpec(demand_scale=SMALL, end_year=2028)
    one = t_sweep.SweepAxes.zip([t_hier.get_design("4N/3")], [env])
    two = t_sweep.SweepAxes.zip([t_hier.get_design("3+1")], [env],
                                seeds=[0, 1])
    t_sweep.sharded_sweep(one, devices=["cpu"] * 4, models=())
    t_sweep.sharded_sweep(two, devices=["cpu"], models=())
    assert calls == [(1, torch.device("cpu")), (2, torch.device("cpu"))]


def test_mesh_shape_error_is_repros():
    with pytest.raises(ValueError) as want:
        r_axes.sweep_mesh(jax.devices()[:1], (2, 1))
    with pytest.raises(ValueError) as got:
        t_axes.sweep_mesh(["cpu"], (2, 1))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"mesh shape \(3, 1\) needs 3 "):
        t_sweep.sharded_sweep(grid7(), devices=["cpu"] * 2,
                              mesh_shape=(3, 1))
    assert t_axes.SWEEP_RULES == r_axes.SWEEP_RULES
    assert (t_axes.CONFIG_AXIS, t_axes.TRIAL_AXIS) == \
        (r_axes.CONFIG_AXIS, r_axes.TRIAL_AXIS)


def test_no_card_raises_for_the_default_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sweep.sharded_sweep(grid7(), chunk_size=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mc.sharded_mc_sweep(mc_grid(t_hier, t_mc), **MC_KW)


def test_an_error_in_a_slab_propagates(monkeypatch):
    real = t_sweep._evaluate

    def fails_on_the_second(prep, lo, hi, **kw):
        if lo > 0:
            raise RuntimeError(f"slab [{lo}, {hi}) failed")
        return real(prep, lo, hi, **kw)

    monkeypatch.setattr(t_sweep, "_evaluate", fails_on_the_second)
    with pytest.raises(RuntimeError, match=r"slab \[4, 7\) failed"):
        t_sweep.sharded_sweep(grid7(), devices=["cpu"] * 2, models=())


# ---------------------------------------------------------------------------
# sharded_mc_sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mc():
    return t_mc.mc_sweep(mc_grid(t_hier, t_mc), device="cpu", **MC_KW)


@pytest.mark.parametrize("kw", [
    dict(devices=["cpu"] * 2),                          # flat, 12 / 2
    dict(devices=["cpu"] * 4, mesh_shape=(4, 1)),       # flat, 12 / 4
    dict(devices=["cpu"] * 2, mesh_shape=(1, 2)),       # 2-D, T 4 / 2
    dict(devices=["cpu"] * 3, mesh_shape=(1, 3)),       # 2-D, T 4 / 3
], ids=["flat2", "flat4", "grid1x2", "grid1x3_remainder"])
def test_sharded_mc_sweep_is_mc_sweep(mc, kw):
    res = t_mc.sharded_mc_sweep(mc_grid(t_hier, t_mc), **MC_KW, **kw)
    assert_bitwise(res, mc, MC_FIELDS, kw)
    # every device's run takes every step
    n_parts = 2 if kw.get("mesh_shape") == (1, 3) else len(kw["devices"])
    assert res.event_steps == n_parts * mc.event_steps


def test_sharded_mc_sweep_pods_2x2_with_a_trial_remainder():
    """The pod path (split pods) on a 2 × 2 mesh: 3 configurations in
    blocks of 2 and 1, 3 trials in blocks of 2 and 1."""
    axes = mc_grid(t_hier, t_mc)
    one = t_mc.mc_sweep(axes, device="cpu", **POD_KW)
    res = t_mc.sharded_mc_sweep(axes, devices=["cpu"] * 4,
                                mesh_shape=(2, 2), **POD_KW)
    assert_bitwise(res, one, MC_FIELDS, "pods")
    assert res.pod_steps > 0


def test_sharded_mc_sweep_passes_through(monkeypatch):
    calls = []
    real = t_mc.mc_sweep

    def spy(axes, **kw):
        calls.append(kw["device"])
        return real(axes, **kw)

    monkeypatch.setattr(t_mc, "mc_sweep", spy)
    axes = t_mc.MCAxes.zip([t_hier.get_design("4N/3")])
    t_mc.sharded_mc_sweep(axes, n_trials=1, n_events=20, devices=["cpu"] * 2)
    t_mc.sharded_mc_sweep(axes, n_trials=2, n_events=20, devices=["cpu"])
    assert calls == [torch.device("cpu")] * 2


# ---------------------------------------------------------------------------
# the payoff studies' route
# ---------------------------------------------------------------------------

def same_points(a, b):
    """Every field of every point equal, NaN included (`repr` round-trips
    a float exactly)."""
    return [repr(p) for p in a] == [repr(p) for p in b]


def test_frontiers_sharded_and_not_give_equal_points(monkeypatch):
    """`sharded=True` (the default) runs `sharded_sweep`, `False` runs
    `sweep`; on one device the points are equal."""
    routes = []
    for name in ("sweep", "sharded_sweep"):
        real = getattr(t_pay, name)

        def spy(axes, _real=real, _name=name, **kw):
            routes.append(_name)
            return _real(axes, **kw)
        monkeypatch.setattr(t_pay, name, spy)
    base = t_arr.EnvelopeSpec(demand_scale=SMALL, end_year=2028)
    fams = {t_sc.FAMILY_SHOCK: t_sc.ScenarioBatch(
        t_sc.FAMILY_SHOCK, ("rep",), (t_arr.EnvelopeSpec(
            demand_scale=SMALL, end_year=2028, shock_month=18,
            shock_multiplier=1.5),))}
    design = t_hier.get_design("3+1")
    pts = [t_pay.scenario_frontier(design, base, families=fams,
                                   sharded=s, device="cpu")
           for s in (True, False)]
    assert same_points(*pts) and len(pts[0]) == 2
    env = t_arr.EnvelopeSpec(demand_scale=SMALL, gpu_scenario="high",
                             end_year=2028)
    front = [t_pay.design_frontier([design], env, pod_sizes=(1,),
                                   models=["MoE-132T"], sharded=s,
                                   device="cpu")
             for s in (True, False)]
    assert same_points(*front)
    assert routes == ["sharded_sweep", "sweep"] * 2


def test_pod_payoff_study_runs_sharded_sweep(monkeypatch):
    calls = []

    def fake(axes, devices=None, **kw):
        calls.append(devices)
        raise RuntimeError("stop")

    monkeypatch.setattr(t_pay, "sharded_sweep", fake)
    for device, want in (("cpu", [torch.device("cpu")]), ("cuda", None),
                         ("cuda:1", [torch.device("cuda", 1)])):
        with pytest.raises(RuntimeError, match="stop"):
            t_pay.pod_payoff_study(t_hier.get_design("10N/8"), [],
                                   pod_sizes=(1,), device=device)
        assert calls[-1] == want

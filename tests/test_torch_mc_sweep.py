"""Parity of the port's single-hall Monte Carlo (`repro_torch.core.mc_sweep`,
`singlehall`) with `repro.core.mc_sweep`, at `repro`'s own test sizes.

Both packages sample byte-identical traces and key every trial alike,
then `repro` runs its jitted, vmapped scan and the port its batched event
loop on the CPU.  Held bitwise: the traces, the placed and saturated
flags.  Held to rtol 1e-6 (atol 1e-5), as `repro`'s own MC tests hold
its batched engine to its wrapper: line-up and hall stranding and
deployed kW, a float32 sum over rows that XLA adds in its own order.
The metric columns, computed from deployed kW, are held to rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import arrivals as r_arr  # noqa: E402
from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import mc_sweep as r_mc  # noqa: E402
from repro.core import singlehall as r_sh  # noqa: E402
from repro_torch.core import arrivals as t_arr  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import mc_sweep as t_mc  # noqa: E402
from repro_torch.core import singlehall as t_sh  # noqa: E402

MC_KW = dict(n_trials=4, n_events=150, year=2030, scenario="high")
FIG6_KW = dict(n_trials=3, n_events=120, harvest=False, single_sku_gpu=True)
POLICY_KW = dict(n_trials=3, n_events=150, year=2030, scenario="high")

GRIDS = {
    # tests/test_mc_sweep.py's heterogeneous grid: 4N/3 and 3+1 pad to
    # the rows and line-ups of 10N/8
    "mixed": (lambda mc, h: mc.MCAxes.zip(
        designs=[h.get_design(n) for n in ("4N/3", "3+1", "10N/8")],
        policies=[3, 2, 3], seeds=[11, 11, 13]), MC_KW),
    # its Fig. 6 single-SKU grid
    "fig6": (lambda mc, h: mc.MCAxes.product(
        designs=[h.get_design("4N/3"), h.get_design("3+1")],
        sku_kw=(400.0, 900.0), seeds=(6,)), FIG6_KW),
    # every policy, the random one included, on both design families
    "policies": (lambda mc, h: mc.MCAxes.product(
        designs=[h.get_design("10N/8"), h.get_design("3+1")],
        policies=range(4), seeds=(7,)), POLICY_KW),
}
FLAGS = ("placed_a", "placed_b", "saturated")
FLOATS = ("lineup_stranding", "hall_stranding", "deployed_kw")
METRICS = ("provisioned_mw", "ha_capacity_kw", "delivered_tps",
           "tps_per_provisioned_w", "dollars_per_tps")


@pytest.fixture(scope="module", params=sorted(GRIDS))
def grid(request):
    axes, kw = GRIDS[request.param]
    ref = r_mc.mc_sweep(axes(r_mc, r_hier), **kw)
    port = t_mc.mc_sweep(axes(t_mc, t_hier), device="cpu", **kw)
    return request.param, kw, ref, port


def test_flags_bitwise(grid):
    _, kw, ref, port = grid
    for f in FLAGS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f)
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert port.event_steps == kw["n_events"] + max(200,
                                                    kw["n_events"] // 3)
    assert port.device == "cpu" and port.placed_a.any()


def test_floats_rtol(grid):
    _, _, ref, port = grid
    for f in FLOATS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5, err_msg=f)
    for f in METRICS:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(port, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
    assert port.model_names == ref.model_names


def test_result_strips_padding(grid):
    _, _, ref, port = grid
    for i in range(len(port)):
        a, b = ref.result(i), port.result(i)
        assert a.keys() == b.keys()
        assert a["lineup_stranding"].shape == b["lineup_stranding"].shape
        assert a["ha_capacity_kw"] == b["ha_capacity_kw"]


def test_random_policy_places_differently():
    """The policy grid's random configurations are not another policy's
    run under a new name."""
    axes = GRIDS["policies"][0](t_mc, t_hier)
    res = t_mc.mc_sweep(axes, device="cpu", **POLICY_KW)
    for i in range(1, 4):
        assert not np.array_equal(res.lineup_stranding[0],
                                  res.lineup_stranding[i])


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("mode", ["mix", "pods_la", "single_sku"])
def test_sample_mixed_traces_bitwise(mode, phase):
    kw = dict(mix=dict(seed=3, year=2030, scenario="high"),
              pods_la=dict(seed=5, pod_racks=5, la_fraction=1.0),
              single_sku=dict(seed=6, sku_kw_override=700.0,
                              single_sku_gpu=True))[mode]
    a = r_arr.sample_mixed_traces(4, 200, phase=phase, **kw)
    b = t_arr.sample_mixed_traces(4, 200, phase=phase, **kw)
    for f in r_arr.TraceBatch.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    np.testing.assert_array_equal(a.n_pods, b.n_pods)
    assert a.max_pod_racks == b.max_pod_racks and len(a) == len(b)
    assert b.trial(2).rack_kw.tobytes() == a.trial(2).rack_kw.tobytes()


@pytest.mark.parametrize("kw", [dict(seed=2), dict(seed=4, pod_racks=5,
                                                   la_fraction=0.3)])
def test_sample_mixed_trace_bitwise(kw):
    a = r_arr.sample_mixed_trace(120, **kw)
    b = t_arr.sample_mixed_trace(120, **kw)
    for f in r_arr.Trace.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_monte_carlo_is_its_mc_sweep_row():
    kw = dict(n_trials=3, n_events=120, year=2030, scenario="high")
    d = t_hier.get_design("8+2")
    axes = t_mc.MCAxes.zip(designs=[t_hier.get_design("4N/3"), d],
                           policies=[3, 0], seeds=[9, 12])
    row = t_mc.mc_sweep(axes, device="cpu", **kw).result(1)
    one = t_sh.monte_carlo(d, policy=0, seed=12, device="cpu", **kw)
    ref = r_sh.monte_carlo(r_hier.get_design("8+2"), policy=0, seed=12,
                           **kw)
    assert one.keys() == row.keys() == ref.keys()
    for k in one:
        np.testing.assert_array_equal(one[k], row[k], err_msg=k)
    for k in ("placed_a", "placed_b", "saturated"):
        np.testing.assert_array_equal(one[k], ref[k], err_msg=k)
    np.testing.assert_allclose(one["deployed_kw"], ref["deployed_kw"],
                               rtol=1e-6)


def test_mc_axes_zip_product_tags():
    d1, d2 = t_hier.get_design("4N/3"), t_hier.get_design("3+1")
    axes = t_mc.MCAxes.product(designs=[d1, d2], sku_kw=(400.0, 900.0),
                               seeds=(1, 2), tags=("dist", "block"))
    assert axes.tags == ["dist"] * 4 + ["block"] * 4
    assert axes.seeds == [1, 2] * 4 and axes.sku_kw[:2] == [400.0, 400.0]
    assert t_mc.MCAxes.product(designs=[d1], seeds=(1, 2)).tags == ["", ""]
    with pytest.raises(t_hier.SweepValidationError):
        t_mc.MCAxes.product(designs=[d1], tags=("a", "b"))
    z = t_mc.MCAxes.zip(designs=[d1, d2], policies=[0], seeds=[3, 4])
    assert len(z) == 2 and z.policies == [0, 0] and z.sku_kw == [None, None]


@pytest.mark.parametrize("case", ["empty", "sku_kw", "policy"])
def test_validate_matches_repro(case):
    def build(mc, h):
        d = h.get_design("4N/3")
        return dict(empty=lambda: mc.MCAxes([]),
                    sku_kw=lambda: mc.MCAxes.zip([d], sku_kw=[-5.0]),
                    policy=lambda: mc.MCAxes.zip([d], policies=[4]))[case]()

    with pytest.raises(r_hier.SweepValidationError) as ra:
        build(r_mc, r_hier).validate()
    with pytest.raises(t_hier.SweepValidationError) as ta:
        build(t_mc, t_hier).validate()
    assert ra.value.field == ta.value.field
    t_mc.MCAxes.zip([t_hier.get_design("4N/3")], policies=[0]).validate()


def test_topology_cache():
    d = t_hier.get_design("4N/3")
    key = (d, d.n_rows, d.n_lineups)
    t_mc._TOPO_CACHE.pop(key, None)
    e1 = t_mc._staged_topology(d, d.n_rows, d.n_lineups)
    e2 = t_mc._staged_topology(t_hier.get_design("4N/3"), d.n_rows,
                               d.n_lineups)
    assert e1 is e2 and key in t_mc._TOPO_CACHE
    assert t_mc._staged_topology(d, 100, 10) is not e1


POD_KW = dict(n_trials=2, n_events=100, year=2030, scenario="high")


def pod_axes(mc, h, policies=(3, 3)):
    """`repro`'s `test_mc_split_pods_matches_legacy_cond` grid."""
    return mc.MCAxes.zip(designs=[h.get_design("10N/8"),
                                  h.get_design("3+1")],
                         seeds=[11, 12], policies=list(policies))


@pytest.mark.parametrize("legacy", [False, True])
def test_pod_traces_raise(legacy):
    """Pod traces no longer raise: `pod_racks` 4 through the split-pods
    path and the per-event cond places as `repro`'s split path does."""
    kw = dict(n_trials=2, n_events=50, pod_racks=4)
    ref = r_mc.mc_sweep(r_mc.MCAxes.zip(designs=[r_hier.get_design("10N/8")]),
                        **kw)
    port = t_mc.mc_sweep(t_mc.MCAxes.zip(designs=[t_hier.get_design("10N/8")]),
                         legacy_pod_cond=legacy, device="cpu", **kw)
    for f in FLAGS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
    assert port.pod_steps > 0


def test_fill_phase_with_pods_raises():
    """`_fill_phase`'s split mode refuses nothing now; the pods-first
    contract is `_pod_geometry`'s, which raises as `repro`'s does."""
    t = t_arr.sample_mixed_traces(2, 50, seed=9, pod_racks=3)
    t.is_pod = np.zeros_like(t.is_pod)
    t.is_pod[:, 1] = True                     # a cluster before a pod
    with pytest.raises(ValueError, match="precede"):
        t_mc._pod_geometry([t])


def test_pod_geometry_matches_repro():
    """`repro`'s `_pod_geometry` contract: (max, min) pod count per trial
    over the batches, on the same pods-first traces."""
    for seed, pod in ((9, 5), (3, 3), (4, 7)):
        a = r_arr.sample_mixed_traces(4, 200, seed=seed, pod_racks=pod)
        b = t_arr.sample_mixed_traces(4, 200, seed=seed, pod_racks=pod)
        c = t_arr.sample_mixed_traces(3, 120, seed=seed, phase=1,
                                      pod_racks=pod)
        assert t_mc._pod_geometry([b]) == r_mc._pod_geometry([a]) == \
            (int(b.n_pods.max()), int(b.n_pods.min()))
        assert t_mc._pod_geometry([b, c]) == (
            max(int(b.n_pods.max()), int(c.n_pods.max())),
            min(int(b.n_pods.min()), int(c.n_pods.min())))


@pytest.mark.parametrize("policies", [(3, 3), (0, 2)])
@pytest.mark.parametrize("pod_racks", [3, 7])
def test_pod_split_and_legacy_match_repro(pod_racks, policies):
    """`repro`'s split ≡ legacy grids (pods of 3 and 7; var_min, and the
    random and min-waste policies): the port's split path and its
    per-event cond give `repro`'s placed and saturated flags bitwise, and
    each other's every output bitwise, the registries included; stranding and deployed kW to rtol
    1e-6 (atol 1e-5) of `repro`'s."""
    kw = dict(POD_KW, pod_racks=pod_racks)
    ref = r_mc.mc_sweep(pod_axes(r_mc, r_hier, policies), **kw)
    split = t_mc.mc_sweep(pod_axes(t_mc, t_hier, policies), device="cpu",
                          **kw)
    legacy = t_mc.mc_sweep(pod_axes(t_mc, t_hier, policies), device="cpu",
                           legacy_pod_cond=True, **kw)
    for f in FLAGS:
        np.testing.assert_array_equal(split.__dict__[f], np.asarray(
            getattr(ref, f)), err_msg=f)
    for f in FLAGS + FLOATS + ("rows_a", "counts_a", "rows_b", "counts_b"):
        assert getattr(split, f).tobytes() == getattr(legacy, f).tobytes(), f
    assert (split.counts_a.sum(-1) > 1).any()
    for f in FLOATS:
        np.testing.assert_allclose(getattr(split, f), getattr(ref, f),
                                   rtol=1e-6, atol=1e-5, err_msg=f)
    assert 0 < split.pod_steps == legacy.pod_steps
    assert split.event_steps < legacy.event_steps


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mc.mc_sweep(t_mc.MCAxes.zip([t_hier.get_design("4N/3")]),
                      n_trials=2, n_events=10)

"""Parity of the port's payoff studies (`repro_torch.core.payoff`) and
calibration reader (`repro_torch.core.calibration`) with `repro`.

The studies run the port's `sweep` on the CPU against `repro`'s
single-device sweep (``sharded=False``), from byte-identical traces.
Held, with the reason:

* `scenario_frontier` at demand_scale 0.005, the baseline plus one
  representative envelope per family: family, label, seed and halls
  built exactly; the exact-zero deltas of the baseline row, and
  `d_capex` (halls × a per-hall constant) with ``==``; `d_p90`, a
  difference of two nearly equal values, within atol 1e-6; every other
  float within rtol 1e-6 (deployed kW is a float32 sum that XLA adds in
  its own order, see `tests/test_torch_sweep.py`), `d_dpm` and `d_tps`
  within atol 1e-6;
* `design_frontier` at 0.005 for MoE-132T: tags, designs, pod sizes,
  halls built and the Pareto `dominated` flags exactly, floats within
  rtol 1e-6 (`p90_stranding` atol 1e-6);
* `pod_payoff_study` on `repro`'s own `fleet_cache` cases
  (`tests/test_metric_stack.py`): the provisioned-W normalisation and
  its NaN when nothing is built; TPS/W, $/MW and fleet TPS/W within
  rtol 1e-6 (the serving rate is a float32 reduction), the deltas and
  the payoff (differences of two such values) within atol 1e-6; and
  once through a real sweep with pods, which fills the cache that a
  second call reuses;
* `_rel_delta` and `pareto_dominated` exactly, ties included;
* the calibration round trip: `CostScale` fields within rtol 1e-6.
"""
import json
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibration as r_cal  # noqa: E402
from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import payoff as r_pay  # noqa: E402
from repro.core import projections as r_proj  # noqa: E402
from repro.core import scenarios as r_sc  # noqa: E402
from repro.core import throughput as r_tp  # noqa: E402
from repro.core.arrivals import EnvelopeSpec as REnv  # noqa: E402
from repro_torch.core import calibration as t_cal  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import payoff as t_pay  # noqa: E402
from repro_torch.core import projections as t_proj  # noqa: E402
from repro_torch.core import scenarios as t_sc  # noqa: E402
from repro_torch.core import throughput as t_tp  # noqa: E402
from repro_torch.core.arrivals import EnvelopeSpec as TEnv  # noqa: E402
from repro_torch.core.sweep import gpu_power_share  # noqa: E402

SCALE = 0.005
RTOL = 1e-6
ATOL = 1e-6


def one_per_family(sc, Env):
    """The base envelope and one "rep" envelope per family, as
    `tests/test_scenarios.py` builds its shared grid."""
    base = Env(demand_scale=SCALE)
    envs = {
        sc.FAMILY_SHOCK: replace(base, shock_month=18, shock_multiplier=1.5),
        sc.FAMILY_COHORT: replace(base, cohort_window_m=6),
        sc.FAMILY_MIX: replace(base, mix_end=(0.8, 0.14, 0.06),
                               la_fraction=0.3),
        sc.FAMILY_REFRESH: replace(base, refresh_cycle_m=24),
    }
    return base, {k: sc.ScenarioBatch(k, ("rep",), (e,))
                  for k, e in envs.items()}


@pytest.fixture(scope="module")
def frontiers():
    base, fams = one_per_family(r_sc, REnv)
    ref = r_pay.scenario_frontier(r_hier.get_design("3+1"), base,
                                  families=fams, sharded=False)
    base, fams = one_per_family(t_sc, TEnv)
    port = t_pay.scenario_frontier(t_hier.get_design("3+1"), base,
                                   families=fams, device="cpu")
    return ref, port


def test_scenario_frontier_matches_repro(frontiers):
    ref, port = frontiers
    assert len(port) == len(ref) == 5
    exact = ("family", "label", "seed", "n_halls", "d_capex")
    near = ("p50_stranding", "p90_stranding", "deployed_mw",
            "effective_dpm", "total_capex", "delivered_tps",
            "dollars_per_tps")
    for p, r in zip(port, ref):
        for f in exact:
            assert getattr(p, f) == getattr(r, f), (r.family, f)
        for f in near:
            np.testing.assert_allclose(getattr(p, f), getattr(r, f),
                                       rtol=RTOL, err_msg=f)
        for f in ("d_p90", "d_dpm", "d_tps"):
            np.testing.assert_allclose(getattr(p, f), getattr(r, f),
                                       rtol=0, atol=ATOL, err_msg=f)
    base = port[0]
    assert (base.family, base.label) == ("baseline", "paper")
    assert base.d_p90 == base.d_capex == base.d_dpm == base.d_tps == 0.0
    assert {p.family for p in port[1:]} == set(t_sc.FAMILIES)


def test_scenario_frontier_without_the_metric_model():
    """No matching model skips the stage: delivered TPS 0, $/TPS NaN,
    and d_tps 0.0 (0 against 0 takes `_rel_delta`'s equal branch), as
    in `repro`."""
    base, fams = one_per_family(t_sc, TEnv)
    pts = t_pay.scenario_frontier(
        t_hier.get_design("4N/3"), base,
        families={t_sc.FAMILY_COHORT: fams[t_sc.FAMILY_COHORT]},
        metric_model="none", device="cpu")
    assert [p.delivered_tps for p in pts] == [0.0, 0.0]
    assert all(np.isnan(p.dollars_per_tps) for p in pts)
    assert [p.d_tps for p in pts] == [0.0, 0.0]


@pytest.fixture(scope="module")
def design_frontiers():
    ref = r_pay.design_frontier(
        base_env=REnv(demand_scale=SCALE, gpu_scenario=r_proj.HIGH),
        models=[r_tp.MODELS["MoE-132T"]], sharded=False)
    port = t_pay.design_frontier(
        base_env=TEnv(demand_scale=SCALE, gpu_scenario=t_proj.HIGH),
        models=[t_tp.MODELS["MoE-132T"]], device="cpu")
    return ref, port


def test_design_frontier_matches_repro(design_frontiers):
    ref, port = design_frontiers
    assert len(port) == len(ref) == 8
    for p, r in zip(port, ref):
        for f in ("design", "tag", "pod_racks", "seed", "model", "n_halls",
                  "provisioned_mw", "total_capex", "dominated"):
            assert getattr(p, f) == getattr(r, f), (r.design, r.tag, f)
        for f in ("deployed_mw", "delivered_tps", "tps_per_provisioned_w",
                  "effective_dpm", "dollars_per_tps"):
            np.testing.assert_allclose(getattr(p, f), getattr(r, f),
                                       rtol=RTOL, err_msg=f)
        np.testing.assert_allclose(p.p90_stranding, r.p90_stranding,
                                   rtol=0, atol=ATOL)
    assert {p.tag for p in port} == {"pod:p1", "pod:p5"}
    assert any(not p.dominated for p in port)


def test_design_frontier_needs_a_model():
    with pytest.raises(ValueError, match="non-empty model suite"):
        t_pay.design_frontier(base_env=TEnv(demand_scale=SCALE), models=(),
                              pod_sizes=(1,),
                              designs=[t_hier.get_design("4N/3")],
                              device="cpu")


ENV_KW = dict(demand_scale=0.05, gpu_scenario="high", pod_scale_arch=True)


def study(pay, hier, tp, Env, cache, pod_sizes=(1,),
          models=("MoE-132T",)):
    return pay.pod_payoff_study(
        hier.get_design("4N/3"), [tp.MODELS[m] for m in models],
        pod_sizes=pod_sizes, env=Env(**ENV_KW), fleet_cache=cache)


def assert_same_points(got, want):
    assert len(got) == len(want)
    for p, r in zip(got, want):
        assert (p.design, p.model, p.pod_racks) == \
            (r.design, r.model, r.pod_racks)
        for f in ("tps_per_watt", "effective_dpm", "fleet_tps_per_watt"):
            np.testing.assert_allclose(getattr(p, f), getattr(r, f),
                                       rtol=RTOL, err_msg=f)
        for f in ("d_tps_per_watt", "d_cost", "payoff"):
            np.testing.assert_allclose(getattr(p, f), getattr(r, f),
                                       rtol=0, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("deployed_mw,n_halls", [(75.0, 10), (60.0, 10),
                                                 (0.0, 0)])
def test_pod_payoff_fleet_tpw_on_repros_cache_cases(deployed_mw, n_halls):
    """`repro`'s fleet-TPS/W cases: normalised by provisioned W (halls
    built × HA nameplate), NaN when nothing is built."""
    def cache():
        return {1: SimpleNamespace(effective_dpm=1e7,
                                   final_deployed_mw=deployed_mw,
                                   n_halls_built=n_halls)}
    (pt,) = study(t_pay, t_hier, t_tp, TEnv, cache())
    (ref,) = study(r_pay, r_hier, r_tp, REnv, cache())
    assert_same_points([pt], [ref])
    share = gpu_power_share(TEnv(**ENV_KW))
    if n_halls == 0:
        assert np.isnan(pt.fleet_tps_per_watt)
    else:
        ha_kw = t_hier.get_design("4N/3").ha_capacity_kw
        provisioned_w = n_halls * ha_kw * 1e3
        assert pt.fleet_tps_per_watt == pytest.approx(
            pt.tps_per_watt * deployed_mw * 1e6 * share / provisioned_w,
            rel=1e-9)
        assert pt.fleet_tps_per_watt <= pt.tps_per_watt * share * (1 + 1e-9)


def test_pod_payoff_cost_side_from_a_cache_of_two_pod_sizes():
    def cache():
        return {1: SimpleNamespace(effective_dpm=1.2e7,
                                   final_deployed_mw=70.0, n_halls_built=10),
                5: SimpleNamespace(effective_dpm=1.5e7,
                                   final_deployed_mw=55.0, n_halls_built=10)}
    models = ("MoE-0.6T", "MoE-19T", "MoE-132T", "MoE-401T")
    got = study(t_pay, t_hier, t_tp, TEnv, cache(), (1, 5), models)
    want = study(r_pay, r_hier, r_tp, REnv, cache(), (1, 5), models)
    assert_same_points(got, want)
    assert [p.d_cost for p in got[1::2]] == [0.25] * 4
    assert all(p.d_cost == 0.0 and p.d_tps_per_watt == 0.0
               for p in got[::2])


def test_pod_payoff_study_through_the_sweep_fills_the_cache(monkeypatch):
    """Missing pod sizes run as one pod sweep; the cache it fills is
    reused without another sweep."""
    kw = dict(demand_scale=SCALE, gpu_scenario="high", pod_scale_arch=True)
    models = ("MoE-132T", "MoE-401T")
    ref = r_pay.pod_payoff_study(
        r_hier.get_design("10N/8"), [r_tp.MODELS[m] for m in models],
        pod_sizes=(1, 3), env=REnv(**kw))
    cache = {}
    got = t_pay.pod_payoff_study(
        t_hier.get_design("10N/8"), [t_tp.MODELS[m] for m in models],
        pod_sizes=(1, 3), env=TEnv(**kw), fleet_cache=cache, device="cpu")
    assert sorted(cache) == [1, 3]
    assert all(p.fleet_tps_per_watt > 0 for p in got)
    assert_same_points(got, ref)

    def no_sweep(*a, **k):
        raise AssertionError("the cache should have served every pod size")
    monkeypatch.setattr(t_pay, "sweep", no_sweep)
    monkeypatch.setattr(t_pay, "sharded_sweep", no_sweep)
    again = t_pay.pod_payoff_study(
        t_hier.get_design("10N/8"), [t_tp.MODELS[m] for m in models],
        pod_sizes=(1, 3), env=TEnv(**kw), fleet_cache=cache, device="cpu")
    assert again == got


@pytest.mark.parametrize("x,ref", [(2.0, 1.0), (5.0, 5.0), (2.0, 0.0),
                                   (float("nan"), 1.0), (2.0, float("inf")),
                                   (float("inf"), float("inf")), (0.0, 0.0),
                                   (1.0, 3.0), (-1.5, 2.5)])
def test_rel_delta_matches_repro(x, ref):
    got, want = t_pay._rel_delta(x, ref), r_pay._rel_delta(x, ref)
    assert type(got) is type(want) is float
    assert got == want or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("case", ["repro_mask", "ties", "random"])
def test_pareto_dominated_matches_repro(case):
    if case == "repro_mask":
        perf = np.array([1.0, 2.0, 3.0, 2.0, np.nan])
        cost = np.array([1.0, 1.0, 2.0, np.nan, 1.0])
        want = [True, False, False, True, True]
    elif case == "ties":
        # equal on both axes: neither dominates the other
        perf = np.array([2.0, 2.0, 1.0, 2.0, np.inf])
        cost = np.array([1.0, 1.0, 1.0, 3.0, 1.0])
        want = [False, False, True, True, True]
    else:
        rng = np.random.default_rng(3)
        perf = rng.integers(0, 5, 40).astype(float)
        cost = rng.integers(0, 5, 40).astype(float)
        want = None
    got = t_pay.pareto_dominated(perf, cost)
    assert got.dtype == bool
    assert got.tolist() == r_pay.pareto_dominated(perf, cost).tolist()
    if want is not None:
        assert got.tolist() == want


ARTIFACT = {"arch": "moonshot-v1-16b-a3b", "shape": "decode_32k",
            "mesh": "16x16", "n_devices": 256, "step": "decode",
            "flops_per_device": 2.9e9, "bytes_per_device": 1.3e11,
            "collective_bytes_per_device": 1.8e9,
            "batch": 128, "seq": 32768}


def test_calibration_round_trip(tmp_path):
    """`tests/test_launchers.py`'s round trip on an artifact written to a
    temporary directory: load → CostScale → the throughput model, and
    the directory scan, which keeps only the asked-for step."""
    (tmp_path / "cell_a.json").write_text(json.dumps(ARTIFACT))
    (tmp_path / "cell_b.json").write_text(json.dumps(
        {**ARTIFACT, "step": "prefill", "batch": 4, "seq": 2048}))
    (tmp_path / "notes.txt").write_text("not an artifact")
    art = t_cal.load_artifact(str(tmp_path / "cell_a.json"))
    assert art == r_cal.load_artifact(str(tmp_path / "cell_a.json"))
    assert t_cal.tokens_in_step(art) == r_cal.tokens_in_step(art) == 128.0
    t_m = t_tp.MoEModel("moonshot", 48, 2048, 64, 6, S=32768)
    r_m = r_tp.MoEModel("moonshot", 48, 2048, 64, 6, S=32768)
    for phase in ("dec", "pre"):
        got = t_cal.cost_scale_from_dryrun(art, t_m, phase)
        want = r_cal.cost_scale_from_dryrun(art, r_m, phase)
        assert isinstance(got, t_tp.CostScale)
        assert all(s > 0 for s in got)
        np.testing.assert_allclose(tuple(got), tuple(want), rtol=RTOL)
    scale = t_cal.cost_scale_from_dryrun(art, t_m, "dec")
    d = t_tp.Deployment(t_proj.VERA_RUBIN, 2026, 1)
    r_d = r_tp.Deployment(r_proj.VERA_RUBIN, 2026, 1)
    t_cal_tps = t_tp.tps_request(t_m, d, scale=scale)
    assert t_cal_tps > 0 and t_tp.tps_request(t_m, d) > 0
    np.testing.assert_allclose(
        t_cal_tps, np.asarray(r_tp.tps_request(
            r_m, r_d, scale=r_cal.cost_scale_from_dryrun(art, r_m, "dec"))),
        rtol=RTOL)
    for step in ("decode", "prefill", "train"):
        got = t_cal.calibrated_scales(str(tmp_path), t_m, step)
        want = r_cal.calibrated_scales(str(tmp_path), r_m, step)
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_allclose(tuple(got[k]), tuple(want[k]),
                                       rtol=RTOL)
    assert list(t_cal.calibrated_scales(str(tmp_path), t_m)) == ["cell_a"]
    assert t_cal.calibrated_scales(str(tmp_path / "missing"), t_m) == {}

"""Parity of the port's scenario families (`repro_torch.core.scenarios`)
with `repro.core.scenarios`.

Everything here is host-side construction, so all of it is held exactly:
each family's name, labels, `family:label` tags and envelopes (field by
field), at the catalog defaults and at other arguments, around the
default and a perturbed base envelope; `all_families`' order;
`frontier_axes`' and `ScenarioBatch.axes`' configuration order, designs,
policies, seeds and tags; and the `ValueError` of a batch whose labels
and envelopes differ in length.  The traces these envelopes generate are
held byte for byte in `tests/test_torch_hostmodel.py`.
"""
import dataclasses
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import scenarios as r_sc  # noqa: E402
from repro.core.arrivals import EnvelopeSpec as REnv  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import scenarios as t_sc  # noqa: E402
from repro_torch.core.arrivals import EnvelopeSpec as TEnv  # noqa: E402

GENERATORS = {
    "demand_shocks": dict(months=(6, 30), multipliers=(0.8, 1.25, 2.0),
                          ramp_months=(0, 3, 12)),
    "correlated_cohorts": dict(windows_m=(1, 9, 96)),
    "mix_sweeps": dict(gpu_share_end=(0.5, 0.655, 0.9),
                       la_fractions=(0.1, 0.25)),
    "refresh_waves": dict(cycles_m=(6, 48)),
    "pod_quanta": dict(pod_sizes=(1, 3, 4, 7)),
}
BASES = {
    "default": {},
    "perturbed": dict(demand_scale=0.02, gpu_scenario="high",
                      pod_scale_arch=True, la_fraction=0.2,
                      quantum_racks=4),
}


def env_fields(env):
    return {f.name: getattr(env, f.name) for f in dataclasses.fields(env)}


def assert_same_batch(got, want):
    assert got.family == want.family
    assert got.labels == want.labels
    assert got.tags() == want.tags()
    assert len(got) == len(want)
    assert [env_fields(e) for e in got.envs] == \
        [env_fields(e) for e in want.envs]


def assert_same_axes(got, want):
    assert len(got) == len(want)
    assert got.tags == want.tags
    assert got.seeds == want.seeds
    assert got.policies == want.policies
    assert [d.name for d in got.designs] == [d.name for d in want.designs]
    assert [env_fields(e) for e in got.envs] == \
        [env_fields(e) for e in want.envs]


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("catalog", [True, False])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_family_labels_tags_and_envelopes_equal(gen, catalog, base):
    kw = {} if catalog else GENERATORS[gen]
    got = getattr(t_sc, gen)(TEnv(**BASES[base]), **kw)
    want = getattr(r_sc, gen)(REnv(**BASES[base]), **kw)
    assert_same_batch(got, want)


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_family_without_a_base_uses_the_default_envelope(gen):
    assert_same_batch(getattr(t_sc, gen)(), getattr(r_sc, gen)())


def test_constants_and_all_families_order():
    for name in ("FAMILY_SHOCK", "FAMILY_COHORT", "FAMILY_MIX",
                 "FAMILY_REFRESH", "FAMILY_POD", "FAMILIES", "BASELINE_TAG"):
        assert getattr(t_sc, name) == getattr(r_sc, name), name
    got = t_sc.all_families(TEnv(demand_scale=0.04))
    want = r_sc.all_families(REnv(demand_scale=0.04))
    assert list(got) == list(want) == list(t_sc.FAMILIES)
    for k in got:
        assert_same_batch(got[k], want[k])
    assert sum(len(b) for b in got.values()) == 14


@pytest.mark.parametrize("seeds", [(0,), (0, 3)])
@pytest.mark.parametrize("which", ["catalog", "one_per_family"])
def test_frontier_axes_equal(which, seeds):
    def build(sc, Env, hier):
        base = Env(demand_scale=0.005)
        fams = None
        if which == "one_per_family":
            fams = {sc.FAMILY_SHOCK: sc.ScenarioBatch(
                        sc.FAMILY_SHOCK, ("rep",),
                        (replace(base, shock_month=18,
                                 shock_multiplier=1.5),)),
                    sc.FAMILY_REFRESH: sc.refresh_waves(base,
                                                        cycles_m=(24,))}
        return sc.frontier_axes([hier.get_design("3+1"),
                                 hier.get_design("8+2")], base=base,
                                seeds=seeds, families=fams)
    got = build(t_sc, TEnv, t_hier)
    want = build(r_sc, REnv, r_hier)
    assert_same_axes(got, want)
    assert got.tags[0] == t_sc.BASELINE_TAG
    assert t_sc.frontier_axes([t_hier.get_design("3+1")]).tags == \
        r_sc.frontier_axes([r_hier.get_design("3+1")]).tags


def test_batch_axes_cross_designs_policies_and_seeds():
    got = t_sc.mix_sweeps(TEnv(demand_scale=0.01)).axes(
        [t_hier.get_design(n) for n in ("4N/3", "10N/8")],
        policies=(3, 0), seeds=(5, 6))
    want = r_sc.mix_sweeps(REnv(demand_scale=0.01)).axes(
        [r_hier.get_design(n) for n in ("4N/3", "10N/8")],
        policies=(3, 0), seeds=(5, 6))
    assert len(got) == 2 * 4 * 2 * 2
    assert_same_axes(got, want)


def test_batch_length_mismatch_raises_as_repro():
    with pytest.raises(ValueError) as got:
        t_sc.ScenarioBatch("shock", ("a", "b"), (TEnv(),))
    with pytest.raises(ValueError) as want:
        r_sc.ScenarioBatch("shock", ("a", "b"), (REnv(),))
    assert str(got.value) == str(want.value) == "shock: 2 labels for 1 envs"

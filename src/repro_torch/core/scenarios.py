"""Scenario generators beyond the paper grid (docs/scenarios.md).

The counterpart of `repro.core.scenarios`.  The paper evaluates designs
on one fixed arrival grid (TDP scenario × pod size × seed).  This module
produces *families* of `EnvelopeSpec` perturbations around any base
envelope: demand shocks, correlated-lifetime cohorts, workload-mix /
LA-share sweeps, and decommission-wave refresh cycles, so the planning
objective (*deployable capacity over time*) can be stressed under
arrival, oversubscription, and decommissioning sequences the paper never
ran.

Each generator returns a named `ScenarioBatch` (aligned labels + envs)
that feeds the batched sweep engine, so a whole family is one batched
lifecycle on one card:

    from repro_torch.core import hierarchy, scenarios
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.sweep import sweep

    batch = scenarios.demand_shocks(EnvelopeSpec(demand_scale=0.01))
    res = sweep(batch.axes([hierarchy.get_design("3+1")]))
    dict(zip(res.tags, res.p90_stranding[:, -1]))

The perturbation *semantics* live in `arrivals.py` (EnvelopeSpec
scenario knobs + trace post-processing), so every family flows through
the same `generate_fleet_trace` synthesis and the same lifecycle; neutral
knobs (multiplier 1.0 / window 0 / cycle 0 / `mix_end=None`) reproduce
the paper baseline bit for bit.  `payoff.scenario_frontier` runs
baseline + all four families on one grid and reports stranding /
effective-capex deltas.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

from .arrivals import EnvelopeSpec
from .placement import DEFAULT_POLICY
from .sweep import SweepAxes

FAMILY_SHOCK = "shock"
FAMILY_COHORT = "cohort"
FAMILY_MIX = "mix"
FAMILY_REFRESH = "refresh"
# The four arrival-perturbation families `scenario_frontier` runs by
# default.  FAMILY_POD is deliberately NOT in this tuple: pod quanta
# change the placement granularity (a design-frontier axis), not the
# arrival stream, so `pod_quanta` batches are opt-in.
FAMILIES = (FAMILY_SHOCK, FAMILY_COHORT, FAMILY_MIX, FAMILY_REFRESH)
FAMILY_POD = "pod"
BASELINE_TAG = "baseline:paper"


@dataclass(frozen=True)
class ScenarioBatch:
    """One scenario family: aligned (labels, envs) around a base envelope.

    `labels[i]` names perturbation `i` within the family (e.g. `m18_x1.5`
    for a 1.5× surge at month 18); `tags()` prefixes the family name so
    configurations stay identifiable after batches are concatenated into
    one sweep grid.
    """
    family: str
    labels: Tuple[str, ...]
    envs: Tuple[EnvelopeSpec, ...]

    def __post_init__(self):
        if len(self.labels) != len(self.envs):
            raise ValueError(
                f"{self.family}: {len(self.labels)} labels for "
                f"{len(self.envs)} envs")

    def __len__(self):
        return len(self.envs)

    def tags(self) -> Tuple[str, ...]:
        """`"family:label"` per perturbation (see `SweepAxes.tags`)."""
        return tuple(f"{self.family}:{lb}" for lb in self.labels)

    def axes(self, designs, policies=(DEFAULT_POLICY,),
             seeds: Sequence[int] = (0,)) -> SweepAxes:
        """Cross this family with designs/policies/seeds, sweep-ready:
        the `SweepAxes` `tags` carry the family labels, so
        `sweep(batch.axes(...))` evaluates the whole family as one batch
        and `SweepResult.tags` identifies each row."""
        return SweepAxes.product(designs=list(designs), envs=list(self.envs),
                                 policies=policies, seeds=seeds,
                                 env_tags=list(self.tags()))


def demand_shocks(base: Optional[EnvelopeSpec] = None, *,
                  months: Sequence[int] = (18,),
                  multipliers: Sequence[float] = (0.5, 1.5),
                  ramp_months: Sequence[int] = (0, 6)) -> ScenarioBatch:
    """(a) Demand shocks: step/ramp multipliers on the monthly budgets.

    One perturbation per (shock month × multiplier × ramp): budgets
    before `month` are untouched; after it they scale by `multiplier`
    (>1 surge, <1 bust), stepped (`ramp 0`) or linearly ramped over
    `ramp` months.  Labels: `m{month}_x{multiplier}_{step|ramp<R>}`.
    """
    base = base if base is not None else EnvelopeSpec()
    labels, envs = [], []
    for m in months:
        for x in multipliers:
            for r in ramp_months:
                kind = "step" if r == 0 else f"ramp{r}"
                labels.append(f"m{m}_x{x:g}_{kind}")
                envs.append(replace(base, shock_month=int(m),
                                    shock_multiplier=float(x),
                                    shock_ramp_months=int(r)))
    return ScenarioBatch(FAMILY_SHOCK, tuple(labels), tuple(envs))


def correlated_cohorts(base: Optional[EnvelopeSpec] = None, *,
                       windows_m: Sequence[int] = (3, 6, 12)
                       ) -> ScenarioBatch:
    """(b) Correlated-lifetime cohorts: same-window arrivals decommission
    together.

    One perturbation per window width: all same-class deployments
    arriving within one `window`-month window share a decommission epoch
    (one lifetime draw per cohort) instead of drawing independent
    N(μ,σ) lifetimes, so the capacity-return stream becomes bursty.
    Labels: `w{window}`.
    """
    base = base if base is not None else EnvelopeSpec()
    windows = tuple(int(w) for w in windows_m)
    return ScenarioBatch(
        FAMILY_COHORT,
        tuple(f"w{w}" for w in windows),
        tuple(replace(base, cohort_window_m=w) for w in windows))


def mix_sweeps(base: Optional[EnvelopeSpec] = None, *,
               gpu_share_end: Sequence[float] = (0.35, 0.8),
               la_fractions: Sequence[float] = (0.0, 0.3)) -> ScenarioBatch:
    """(c) Workload-mix / LA-share sweeps: continuous interpolation of the
    accelerator-vs-general-vs-storage power split per year.

    One perturbation per (end-of-horizon GPU share × LA fraction): the
    per-year class split interpolates linearly from the baseline split
    to `(g, 0.7·(1−g), 0.3·(1−g))` at `end_year` (total annual demand
    preserved), optionally with an LA-tier arrival share.  Labels:
    `gpu{share%}_la{fraction%}`.
    """
    base = base if base is not None else EnvelopeSpec()
    labels, envs = [], []
    for g in gpu_share_end:
        mix = (float(g), (1.0 - g) * 0.7, (1.0 - g) * 0.3)
        for la in la_fractions:
            labels.append(f"gpu{int(round(g * 100))}_la{int(round(la * 100))}")
            envs.append(replace(base, mix_end=mix, la_fraction=float(la)))
    return ScenarioBatch(FAMILY_MIX, tuple(labels), tuple(envs))


def refresh_waves(base: Optional[EnvelopeSpec] = None, *,
                  cycles_m: Sequence[int] = (12, 24, 36)) -> ScenarioBatch:
    """(d) Decommission-wave refresh cycles: hardware-generation turnover
    pulses.

    One perturbation per cycle length: every deployment's end-of-life
    month snaps up to the next multiple of the cycle, so decommissioning
    arrives in synchronized waves instead of a smooth stream.  Labels:
    `c{cycle}`.
    """
    base = base if base is not None else EnvelopeSpec()
    cycles = tuple(int(c) for c in cycles_m)
    return ScenarioBatch(
        FAMILY_REFRESH,
        tuple(f"c{c}" for c in cycles),
        tuple(replace(base, refresh_cycle_m=c) for c in cycles))


def pod_quanta(base: Optional[EnvelopeSpec] = None, *,
               pod_sizes: Sequence[int] = (1, 5)) -> ScenarioBatch:
    """Pod placement-quantum family: the §6.5 serving-vs-deployability
    axis (`payoff.design_frontier` consumes this).

    One perturbation per pod size: GPU arrivals come in `p`-rack pods
    (`p = 1` is the rack-scale baseline quantum; pod sizes > 1 switch to
    Kyber pod-scale racks).  Labels: `p{size}`.  Not part of `FAMILIES` /
    `all_families`: see the note on the tuple above.
    """
    base = base if base is not None else EnvelopeSpec()
    sizes = tuple(int(p) for p in pod_sizes)
    return ScenarioBatch(
        FAMILY_POD,
        tuple(f"p{p}" for p in sizes),
        tuple(replace(base, pod_racks=p, pod_scale_arch=p > 1 or
                      base.pod_scale_arch) for p in sizes))


def all_families(base: Optional[EnvelopeSpec] = None
                 ) -> Dict[str, ScenarioBatch]:
    """All four scenario families at their catalog defaults, keyed by
    family name (`FAMILIES` order)."""
    base = base if base is not None else EnvelopeSpec()
    batches = (demand_shocks(base), correlated_cohorts(base),
               mix_sweeps(base), refresh_waves(base))
    return {b.family: b for b in batches}


def frontier_axes(designs, base: Optional[EnvelopeSpec] = None,
                  seeds: Sequence[int] = (0,),
                  families: Optional[Dict[str, ScenarioBatch]] = None
                  ) -> SweepAxes:
    """Baseline + every family on one tagged sweep grid.

    Configuration 0 of each (design, seed) block is the unperturbed base
    envelope (tag `baseline:paper`), so per-scenario deltas are computed
    against a baseline simulated in the same batch
    (`payoff.scenario_frontier` consumes this).
    """
    base = base if base is not None else EnvelopeSpec()
    fams = all_families(base) if families is None else families
    envs, tags = [base], [BASELINE_TAG]
    for b in fams.values():
        envs.extend(b.envs)
        tags.extend(b.tags())
    return SweepAxes.product(designs=list(designs), envs=envs, seeds=seeds,
                             env_tags=tags)

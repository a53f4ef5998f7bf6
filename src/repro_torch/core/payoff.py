"""Pod payoff analysis (paper §6.5, Figs. 17–18) and the beyond-the-paper
scenario and design frontiers.

The counterpart of `repro.core.payoff`.

Pod Payoff = (1 + ΔTPS/W) / (1 + ΔCost) − 1   relative to a single-rack
baseline, where ΔTPS/W is the serving-side gain from pod-local EP
communication and ΔCost is the lifecycle deployability penalty of the
coarser placement quantum (from fleet simulation).

`scenario_frontier` stresses one design across every scenario family in
`scenarios` (demand shocks, correlated cohorts, mix/LA sweeps, refresh
waves) on one sweep grid and reports p50/p90 stranding, effective-capex
and delivered-TPS deltas against the paper baseline simulated in the
same batch (docs/scenarios.md).

`design_frontier` is the $/performance synthesis: every design × pod
quantum × seed evaluated on one sweep grid, priced against the Table 2
model suite by the sweep's metric stage, with Pareto-dominated
(delivered tokens/s vs. effective capex) points flagged per model.

Every study runs its fleet simulations as one batched sweep, through
`sweep.sharded_sweep` as `repro`'s do (`pod_payoff_study` always, the
frontiers unless ``sharded=False``, which runs `sweep.sweep`); the
metric stage after it is host math.  ``device="cuda"`` (the default)
means every visible card under `sharded_sweep` and the current card
under `sweep`; any other device (``"cpu"``, ``"cuda:1"``) is that one
device.  On one card both routes give the same results and launches.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import fleet, hierarchy, projections as proj, scenarios as sc
from . import throughput as tp
from .arrivals import EnvelopeSpec
from .hierarchy import DesignSpec
from .sweep import SweepAxes, gpu_power_share, sharded_sweep, sweep


def _sharded(axes, device, **kw):
    """`sharded_sweep` over the devices `device` names: every visible
    card for a bare ``"cuda"``, else that one device."""
    dev = torch.device(device)
    devices = None if dev.type == "cuda" and dev.index is None else [dev]
    return sharded_sweep(axes, devices=devices, **kw)


@dataclass
class PayoffPoint:
    design: str
    model: str
    pod_racks: int
    tps_per_watt: float
    d_tps_per_watt: float
    effective_dpm: float
    d_cost: float
    payoff: float
    fleet_tps_per_watt: float = 0.0


def serving_gain(model: tp.MoEModel, pod_racks: int, year: int = 2028,
                 scenario: str = proj.HIGH) -> tuple[float, float]:
    """(TPS/W, ΔTPS/W vs single rack) for Kyber-era deployments."""
    base = tp.Deployment(proj.KYBER, year, 1, scenario)
    pod = tp.Deployment(proj.KYBER, year, pod_racks, scenario)
    t0 = tp.tps_per_watt(model, base)
    t1 = tp.tps_per_watt(model, pod)
    return t1, (t1 - t0) / t0


def pod_payoff_study(design: DesignSpec, models: Sequence[tp.MoEModel],
                     pod_sizes: Sequence[int] = (1, 3, 5, 7),
                     env: EnvelopeSpec | None = None, seed: int = 0,
                     year: int = 2028,
                     fleet_cache: Dict[int, fleet.FleetResult] | None = None,
                     device="cuda") -> list[PayoffPoint]:
    """Fleet-cost side is model-independent (the hierarchy sees only the
    placement quantum), so fleet sims are run once per pod size and reused
    across models: all missing pod sizes are evaluated in one batched
    `sharded_sweep` on `device`.  `fleet_cache` may be shared across designs'
    calls.  The default envelope sets `pod_scale_arch` for every pod size,
    1 included."""
    env = env or EnvelopeSpec(demand_scale=0.05, gpu_scenario=proj.HIGH,
                              pod_scale_arch=True)
    results: Dict[int, fleet.FleetResult] = \
        fleet_cache if fleet_cache is not None else {}
    missing = [n for n in pod_sizes if n not in results]
    if missing:
        axes = SweepAxes.zip(designs=[design],
                             envs=[replace(env, pod_racks=n)
                                   for n in missing],
                             seeds=[seed])
        res = _sharded(axes, device)
        for i, n in enumerate(missing):
            results[n] = res.result(i)

    base_cost = results[pod_sizes[0]].effective_dpm
    points = []
    for m in models:
        for n in pod_sizes:
            tw, d_tps = serving_gain(m, n, year)
            d_cost = results[n].effective_dpm / base_cost - 1.0
            payoff = (1 + d_tps) / (1 + d_cost) - 1.0
            # fleet-level TPS/W: deployed GPU MW × per-watt serving rate,
            # normalized by PROVISIONED MW (halls built × HA nameplate).
            # Normalizing by deployed MW would cancel it out of its own
            # formula (fleet_tpw ≡ tw · gpu_share), hiding exactly the
            # stranding penalty the metric exists to expose.
            r = results[n]
            fleet_tps = tw * r.final_deployed_mw * 1e6 * gpu_power_share(env)
            provisioned_w = r.n_halls_built * design.ha_capacity_kw * 1e3
            fleet_tpw = (fleet_tps / provisioned_w if provisioned_w > 0
                         else float("nan"))
            points.append(PayoffPoint(
                design.name, m.name, n, tw, d_tps, r.effective_dpm, d_cost,
                payoff, fleet_tpw))
    return points


@dataclass
class ScenarioPoint:
    """One (scenario, seed) row of the frontier study.

    Deltas are against the paper-baseline configuration with the same
    design and seed from the SAME sweep call (`d_* == 0` for the
    baseline rows themselves).
    """
    family: str             # "baseline" or a scenarios.FAMILIES name
    label: str              # perturbation label within the family
    seed: int
    p50_stranding: float    # final-month p50 over mature halls
    p90_stranding: float    # final-month p90 (the paper's tail metric)
    n_halls: int
    deployed_mw: float
    effective_dpm: float    # lifecycle-effective $/MW
    total_capex: float      # $
    d_p90: float            # p90 stranding delta vs baseline (absolute)
    d_capex: float          # fractional total-capex delta vs baseline
    d_dpm: float            # fractional effective-$/MW delta vs baseline
    # metric-stage columns for `metric_model` (0.0/NaN when stage skipped)
    delivered_tps: float = 0.0    # fleet tokens/s
    dollars_per_tps: float = float("nan")
    d_tps: float = float("nan")   # fractional delivered-TPS delta


def _rel_delta(x: float, ref: float) -> float:
    """Fractional delta `x/ref − 1`, NaN-safe: identical values are
    exactly 0.0 (baseline rows compare against themselves), and any
    non-finite or zero reference yields NaN instead of propagating
    inf through frontier aggregation."""
    if x == ref:
        return 0.0
    if not (np.isfinite(x) and np.isfinite(ref)) or ref == 0:
        return float("nan")
    return float(x / ref - 1.0)


def scenario_frontier(design: DesignSpec,
                      base_env: Optional[EnvelopeSpec] = None,
                      seeds: Sequence[int] = (0,),
                      families: Optional[Dict[str, sc.ScenarioBatch]] = None,
                      sharded: bool = True,
                      metric_model: str = "MoE-132T",
                      device="cuda") -> list[ScenarioPoint]:
    """Beyond-the-paper scenario study (docs/scenarios.md).

    Evaluates `design` on the paper baseline plus every scenario family
    (defaults: `scenarios.all_families(base_env)`) as one batched sweep
    on `device` (`sharded_sweep` when `sharded`, else `sweep`), and
    returns one `ScenarioPoint` per (scenario, seed) with stranding and
    effective-capex deltas against the same-seed baseline.

        pts = scenario_frontier(hierarchy.get_design("3+1"),
                                EnvelopeSpec(demand_scale=0.01))
        max(pts, key=lambda p: p.p90_stranding)     # worst-case envelope
    """
    base_env = base_env if base_env is not None else \
        EnvelopeSpec(demand_scale=0.01)
    axes = sc.frontier_axes([design], base=base_env, seeds=seeds,
                            families=families)
    models = tuple(m for m in tp.MODEL_SUITE if m.name == metric_model)
    res = (_sharded(axes, device, models=models) if sharded
           else sweep(axes, models=models, device=device))
    tps = (res.delivered_tps[:, 0] if models
           else np.zeros(len(axes)))
    dpt = (res.dollars_per_tps[:, 0] if models
           else np.full(len(axes), np.nan))

    base_idx = {axes.seeds[i]: i for i in range(len(axes))
                if axes.tags[i] == sc.BASELINE_TAG}
    points = []
    for i in range(len(axes)):
        fam, label = axes.tags[i].split(":", 1)
        j = base_idx[axes.seeds[i]]
        points.append(ScenarioPoint(
            family=fam, label=label, seed=axes.seeds[i],
            p50_stranding=float(res.p50_stranding[i, -1]),
            p90_stranding=float(res.p90_stranding[i, -1]),
            n_halls=int(res.n_halls_built[i]),
            deployed_mw=float(res.final_deployed_mw[i]),
            effective_dpm=float(res.effective_dpm[i]),
            total_capex=float(res.total_capex[i]),
            d_p90=float(res.p90_stranding[i, -1] - res.p90_stranding[j, -1]),
            d_capex=_rel_delta(float(res.total_capex[i]),
                               float(res.total_capex[j])),
            d_dpm=_rel_delta(float(res.effective_dpm[i]),
                             float(res.effective_dpm[j])),
            delivered_tps=float(tps[i]),
            dollars_per_tps=float(dpt[i]),
            d_tps=_rel_delta(float(tps[i]), float(tps[j]))))
    return points


@dataclass
class FrontierPoint:
    """One (design × pod quantum × seed × model) point of the design
    frontier: delivered tokens/s against effective capex."""
    design: str
    tag: str                # scenarios tag, e.g. "pod:p5"
    pod_racks: int
    seed: int
    model: str
    n_halls: int
    deployed_mw: float
    provisioned_mw: float
    p90_stranding: float
    delivered_tps: float
    tps_per_provisioned_w: float
    effective_dpm: float
    total_capex: float
    dollars_per_tps: float
    dominated: bool         # True = strictly beaten on (TPS, capex)


def pareto_dominated(perf: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """Boolean mask over points maximizing `perf` while minimizing `cost`.

    `dominated[i]` is True iff some point j is at least as good on both
    axes and strictly better on one.  Non-finite points (NaN sentinels
    from the cost model) never dominate anything and are always flagged
    dominated."""
    perf = np.asarray(perf, float)
    cost = np.asarray(cost, float)
    finite = np.isfinite(perf) & np.isfinite(cost)
    ge = perf[None, :] >= perf[:, None]          # perf_j ≥ perf_i
    le = cost[None, :] <= cost[:, None]          # cost_j ≤ cost_i
    strict = (perf[None, :] > perf[:, None]) | (cost[None, :] < cost[:, None])
    return (ge & le & strict & finite[None, :]).any(axis=1) | ~finite


def design_frontier(designs: Sequence[DesignSpec] | None = None,
                    base_env: Optional[EnvelopeSpec] = None,
                    pod_sizes: Sequence[int] = (1, 5),
                    models: Sequence[tp.MoEModel] | None = None,
                    seeds: Sequence[int] = (0,),
                    metric_year: int | None = None,
                    sharded: bool = True,
                    device="cuda") -> list[FrontierPoint]:
    """Pareto frontier over the full design grid: delivered tokens/s vs.
    effective capex (the paper's $/performance planning objective).

    Evaluates designs × pod quanta (`scenarios.pod_quanta` tags) × seeds
    as one batched sweep on `device` (`sharded_sweep` when `sharded`,
    else `sweep`) whose metric stage prices every
    configuration against `models` (default: the Table 2 suite), then
    flags Pareto-dominated points per model: domination is only
    meaningful between configurations serving the same model.

        pts = design_frontier()               # 4 designs × {1,5}-rack pods
        [p for p in pts if not p.dominated and p.model == "MoE-132T"]
    """
    designs = list(designs) if designs is not None else \
        [hierarchy.get_design(n) for n in ("4N/3", "3+1", "10N/8", "8+2")]
    base_env = base_env if base_env is not None else \
        EnvelopeSpec(demand_scale=0.02, gpu_scenario=proj.HIGH)
    batch = sc.pod_quanta(base_env, pod_sizes=pod_sizes)
    axes = batch.axes(designs, seeds=seeds)
    kw = dict(models=models, metric_year=metric_year)
    res = (_sharded(axes, device, **kw) if sharded
           else sweep(axes, device=device, **kw))
    if not res.model_names:
        raise ValueError("design_frontier needs a non-empty model suite")

    points = []
    for k, name in enumerate(res.model_names):
        dom = pareto_dominated(res.delivered_tps[:, k], res.total_capex)
        for i in range(len(axes)):
            points.append(FrontierPoint(
                design=axes.designs[i].name, tag=axes.tags[i],
                pod_racks=int(axes.envs[i].pod_racks), seed=axes.seeds[i],
                model=name,
                n_halls=int(res.n_halls_built[i]),
                deployed_mw=float(res.final_deployed_mw[i]),
                provisioned_mw=float(res.provisioned_mw[i]),
                p90_stranding=float(res.p90_stranding[i, -1]),
                delivered_tps=float(res.delivered_tps[i, k]),
                tps_per_provisioned_w=float(res.tps_per_provisioned_w[i, k]),
                effective_dpm=float(res.effective_dpm[i]),
                total_capex=float(res.total_capex[i]),
                dollars_per_tps=float(res.dollars_per_tps[i, k]),
                dominated=bool(dom[i])))
    return points

"""Arrival envelopes and deployment-trace generation (paper §5.1–5.2).

Stage (1): class-level arrival envelopes — annual power targets per hardware
class (accelerators / general compute / storage) spread into monthly budgets
with seasonality weights.  Stage (2): per-SKU rack power via empirical SKU
clusters (Eq. 3).  Stage (3): lifecycle metadata (availability tier,
lifetime, harvest fraction).

Trace generation is host-side numpy (it parameterizes the simulations);
the placement simulators consume the resulting arrays on device.

A copy of `repro.core.arrivals`: the numpy RNG call sequences are
unchanged, so `generate_fleet_trace`, `sample_mixed_traces` and
`sample_mixed_trace` are byte-identical to the reference's for equal
arguments.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from . import projections as proj
from .resources import CLASS_COMPUTE, CLASS_GPU, CLASS_STORAGE, TIER_HA, TIER_LA

# SKU clusters (α_j, p_j) — stylized from the paper's Fig. 11 empirical
# clusters of Azure general-compute / storage rack-power distributions.
COMPUTE_SKUS = ((0.45, 0.25), (0.65, 0.35), (0.85, 0.25), (1.00, 0.15))
STORAGE_SKUS = ((0.60, 0.30), (0.80, 0.50), (1.00, 0.20))

# Lifetimes (paper §5.2): N(7,1) yrs compute/storage, N(5,0.5) yrs GPU.
LIFETIME = {CLASS_GPU: (5.0, 0.5), CLASS_COMPUTE: (7.0, 1.0),
            CLASS_STORAGE: (7.0, 1.0)}
# Harvest ceilings after 1 year (paper §5.2).
HARVEST_FRAC = {CLASS_GPU: 0.10, CLASS_COMPUTE: 0.15, CLASS_STORAGE: 0.15}

# Quarterly seasonality (stylized after Azure procurement cycles, §5.1).
SEASONALITY = np.array([0.8, 0.95, 1.05, 1.2])
SEASONALITY = np.repeat(SEASONALITY / SEASONALITY.sum(), 3) / 3.0  # monthly


@dataclass
class Trace:
    """Flat arrays, one entry per deployment event (cluster or pod)."""
    month: np.ndarray        # int32, months since start
    class_id: np.ndarray     # int32
    rack_kw: np.ndarray      # float32
    n_racks: np.ndarray      # int32
    is_gpu: np.ndarray       # bool
    is_pod: np.ndarray       # bool
    tier: np.ndarray         # int32
    lifetime_m: np.ndarray   # int32 months
    harvest_frac: np.ndarray  # float32

    def __len__(self):
        return len(self.month)

    @property
    def total_kw(self):
        return float(np.sum(self.rack_kw * self.n_racks))

    @staticmethod
    def concat(traces):
        return Trace(**{f: np.concatenate([getattr(t, f) for t in traces])
                        for f in Trace.__dataclass_fields__})

    def sorted_by_month(self):
        o = np.argsort(self.month, kind="stable")
        return Trace(**{f: getattr(self, f)[o]
                        for f in Trace.__dataclass_fields__})


@dataclass
class EnvelopeSpec:
    """Demand envelope (paper Table 1) plus beyond-the-paper scenario knobs.

    The paper baseline is 10 GW *cumulative* demand over the buildout
    horizon — 6.0 GW accelerators / 2.8 GW general compute / 1.2 GW
    storage — scaled uniformly by `demand_scale` (all `*_gw` fields are
    gigawatts; everything downstream of `annual_targets_kw` is kilowatts).
    Class ids are `resources.CLASS_GPU / CLASS_COMPUTE / CLASS_STORAGE`.

    The scenario-generator fields (see `repro.core.scenarios` and
    docs/scenarios.md) perturb the baseline; at their defaults
    (`shock_multiplier=1.0`, `cohort_window_m=0`, `refresh_cycle_m=0`,
    `mix_end=None`) the generated trace is bit-for-bit the paper grid's,
    so sweeps mixing baseline and scenario envelopes stay comparable.

    Paper-grid fields:
        start_year / end_year: buildout horizon (inclusive); the
            simulated month count is `(end_year - start_year + 1) * 12`.
        demand_scale: uniform multiplier on cumulative demand
            (1.0 ⇒ 10 GW; benchmarks default to a 0.04 ⇒ 400 MW miniature).
        gpu_gw / compute_gw / storage_gw: per-class cumulative demand [GW].
        growth: per-class annual demand growth factors (class id → rate).
        gpu_scenario / nongpu_scenario: rack-power TDP trajectory names
            (`projections.LOW/MED/HIGH`).
        pod_racks: GPU placement quantum in racks (1 = rack-scale, 3–7 =
            multi-rack pods).
        pod_scale_arch: use Kyber pod-scale racks from 2027 onward.
        quantum_racks: same-SKU racks per non-GPU cluster (§6.4).
        la_fraction: probability an arrival is low-availability tier
            (may consume failover headroom, §4.1).

    Scenario fields:
        shock_month: month index of a demand shock; -1 = no shock.
        shock_multiplier: monthly-budget multiplier after the shock
            (>1 surge, <1 bust; exactly 1.0 reproduces the baseline).
        shock_ramp_months: 0 = step at `shock_month`; >0 = linear ramp
            reaching `shock_multiplier` over that many months.
        cohort_window_m: >0 = correlated-lifetime cohorts: all same-class
            deployments arriving within one window share a decommission
            epoch instead of drawing independent lifetimes.
        refresh_cycle_m: >0 = decommission-wave refresh cycles:
            end-of-life months snap up to the next multiple of the cycle
            (hardware-generation turnover pulses).
        mix_end: optional (gpu, compute, storage) power-share tuple the
            per-year class split linearly interpolates toward by
            `end_year` (normalized; total annual demand is preserved).
    """
    start_year: int = 2026
    end_year: int = 2034
    demand_scale: float = 1.0          # 1.0 ⇒ 10 GW cumulative
    gpu_gw: float = 6.0
    compute_gw: float = 2.8
    storage_gw: float = 1.2
    growth: Dict[int, float] = field(default_factory=lambda: {
        CLASS_GPU: 1.35, CLASS_COMPUTE: 1.15, CLASS_STORAGE: 1.10})
    gpu_scenario: str = proj.MED
    nongpu_scenario: str = proj.MED
    pod_racks: int = 1                  # 1 = rack-scale GPU; 3–7 = pods
    pod_scale_arch: bool = False        # use Kyber pods from 2027
    quantum_racks: int = 10             # same-SKU racks per cluster (§6.4)
    la_fraction: float = 0.0            # share of LA-tier arrivals
    # --- scenario-generator knobs (repro.core.scenarios) ---
    shock_month: int = -1               # -1 = no demand shock
    shock_multiplier: float = 1.0       # budget multiplier after the shock
    shock_ramp_months: int = 0          # 0 = step; >0 = linear ramp-in
    cohort_window_m: int = 0            # 0 = independent lifetimes
    refresh_cycle_m: int = 0            # 0 = no refresh waves
    mix_end: Optional[Tuple[float, float, float]] = None

    @property
    def n_months(self) -> int:
        """Simulated month count of the buildout horizon."""
        return (self.end_year - self.start_year + 1) * 12

    def validate(self) -> "EnvelopeSpec":
        """Raise `SweepValidationError` on an unsatisfiable envelope."""
        from .hierarchy import SweepValidationError, _require
        e = self
        _require(e.end_year >= e.start_year, "end_year",
                 f"non-monotone buildout horizon: end_year {e.end_year} "
                 f"precedes start_year {e.start_year}")
        _require(e.demand_scale > 0, "demand_scale",
                 f"non-positive demand_scale {e.demand_scale}")
        _require(e.gpu_gw >= 0 and e.compute_gw >= 0 and e.storage_gw >= 0,
                 "gpu_gw", f"negative per-class demand (gpu_gw={e.gpu_gw}, "
                 f"compute_gw={e.compute_gw}, storage_gw={e.storage_gw})")
        _require(e.gpu_gw + e.compute_gw + e.storage_gw > 0, "gpu_gw",
                 "zero total demand; nothing would ever arrive")
        for cid in (CLASS_GPU, CLASS_COMPUTE, CLASS_STORAGE):
            _require(cid in e.growth, "growth",
                     f"growth is missing class id {cid}")
            _require(e.growth[cid] > 0, "growth",
                     f"non-positive growth factor {e.growth[cid]} for "
                     f"class id {cid}")
        for fld, sc in (("gpu_scenario", e.gpu_scenario),
                        ("nongpu_scenario", e.nongpu_scenario)):
            _require(sc in proj.SCENARIOS, fld,
                     f"unknown scenario {sc!r}; have {list(proj.SCENARIOS)}")
        from .placement import MAX_POD_RACKS
        _require(1 <= e.pod_racks <= MAX_POD_RACKS, "pod_racks",
                 f"pod_racks {e.pod_racks} outside [1, MAX_POD_RACKS="
                 f"{MAX_POD_RACKS}]; the pod window would exceed the "
                 f"placement scan length")
        _require(e.quantum_racks >= 1, "quantum_racks",
                 f"non-positive quantum_racks {e.quantum_racks}")
        _require(0.0 <= e.la_fraction <= 1.0, "la_fraction",
                 f"la_fraction {e.la_fraction} outside [0, 1]")
        _require(e.shock_month < e.n_months, "shock_month",
                 f"shock_month {e.shock_month} is past the horizon "
                 f"({e.n_months} months)")
        _require(e.shock_multiplier >= 0, "shock_multiplier",
                 f"negative shock_multiplier {e.shock_multiplier}")
        _require(e.shock_ramp_months >= 0, "shock_ramp_months",
                 f"negative shock_ramp_months {e.shock_ramp_months}")
        _require(e.cohort_window_m >= 0, "cohort_window_m",
                 f"negative cohort_window_m {e.cohort_window_m}")
        _require(e.refresh_cycle_m >= 0, "refresh_cycle_m",
                 f"negative refresh_cycle_m {e.refresh_cycle_m}")
        if e.mix_end is not None:
            _require(len(e.mix_end) == 3, "mix_end",
                     f"mix_end needs (gpu, compute, storage) shares, got "
                     f"{len(e.mix_end)} entries")
            _require(all(s >= 0 for s in e.mix_end) and sum(e.mix_end) > 0,
                     "mix_end", f"mix_end shares {e.mix_end} must be "
                     f"non-negative and sum positive")
        return e

    def annual_targets_kw(self, class_id: int) -> np.ndarray:
        """Per-year arrival power targets [kW] for one hardware class.

        Baseline: the class's cumulative demand spread over the horizon
        with its compound `growth` weighting.  With `mix_end` set, the
        *combined* annual total is preserved and the per-year class split
        interpolates linearly from the baseline split at `start_year` to
        the normalized `mix_end` shares at `end_year`.
        """
        years = np.arange(self.start_year, self.end_year + 1)

        def base(cid):
            total_gw = {CLASS_GPU: self.gpu_gw,
                        CLASS_COMPUTE: self.compute_gw,
                        CLASS_STORAGE: self.storage_gw}[cid]
            w = self.growth[cid] ** np.arange(len(years))
            return total_gw * 1e6 * self.demand_scale * w / w.sum()

        if self.mix_end is None:
            return base(class_id)
        per_class = {c: base(c)
                     for c in (CLASS_GPU, CLASS_COMPUTE, CLASS_STORAGE)}
        tot = sum(per_class.values())                     # [Y] combined
        end = np.asarray(self.mix_end, float)
        end = end / end.sum()
        # 0 at start_year, 1 at end_year; a one-year horizon IS end_year
        f = np.linspace(0.0, 1.0, len(years)) if len(years) > 1 \
            else np.ones(1)
        share = ((1.0 - f) * per_class[class_id] / np.maximum(tot, 1e-12)
                 + f * end[class_id])
        return tot * share

    def monthly_multipliers(self) -> np.ndarray:
        """[n_months] demand-shock multiplier on the monthly budgets.

        All-ones without a shock (`shock_month < 0`); a step to
        `shock_multiplier` at `shock_month`, or a linear ramp over
        `shock_ramp_months` months reaching it.  A multiplier of exactly
        1.0 leaves every budget bit-identical to the baseline.
        """
        t = np.arange(self.n_months, dtype=float)
        if self.shock_month < 0:
            return np.ones_like(t)
        if self.shock_ramp_months > 0:
            frac = np.clip((t - self.shock_month) / self.shock_ramp_months,
                           0.0, 1.0)
        else:
            frac = (t >= self.shock_month).astype(float)
        return 1.0 + frac * (self.shock_multiplier - 1.0)

    def demand_multiplier(self) -> float:
        """Budget-weighted mean of `monthly_multipliers` — the factor by
        which a demand shock scales *cumulative* demand (1.0 without a
        shock).  Used by hall auto-sizing (`fleet._auto_halls`) so surge
        scenarios still get enough hall headroom."""
        if self.shock_month < 0:
            return 1.0
        mult = self.monthly_multipliers()
        num = den = 0.0
        for cid in (CLASS_GPU, CLASS_COMPUTE, CLASS_STORAGE):
            w = np.outer(self.annual_targets_kw(cid), SEASONALITY).ravel()
            num += float(w @ mult)
            den += float(w.sum())
        return num / max(den, 1e-12)


def _rack_kw_for(env: EnvelopeSpec, class_id: int, year: int,
                 rng: np.random.Generator) -> float:
    if class_id == CLASS_GPU:
        return proj.gpu_rack_kw(year, env.gpu_scenario,
                                pod_scale=env.pod_scale_arch or env.pod_racks > 1)
    if class_id == CLASS_COMPUTE:
        pmax, skus = proj.compute_rack_kw(year, env.nongpu_scenario), COMPUTE_SKUS
    else:
        pmax, skus = proj.storage_rack_kw(year, env.nongpu_scenario), STORAGE_SKUS
    alphas = np.array([a for a, _ in skus])
    probs = np.array([p for _, p in skus])
    return float(pmax * rng.choice(alphas, p=probs))     # Eq. 3


def _correlate_cohorts(t: Trace, window_m: int, seed: int) -> Trace:
    """Correlated-lifetime cohorts (`EnvelopeSpec.cohort_window_m`).

    Replaces the per-deployment N(μ,σ) lifetimes with a shared
    per-(class, window) decommission epoch: one lifetime is drawn per
    cohort (seeded by `(seed, class, cohort)`, so traces stay
    reproducible) relative to the window start, and every member's
    `lifetime_m` is set so `month + lifetime_m` lands on that epoch.
    The epoch is floored at the window *end*, so even windows wider
    than the lifetime draw keep the whole cohort on one shared epoch
    (late-window arrivals just live at least one month).
    """
    cohort = t.month // window_m
    life = np.asarray(t.lifetime_m).copy()
    for cid in np.unique(t.class_id):
        mu, sd = LIFETIME[int(cid)]
        in_class = t.class_id == cid
        for c in np.unique(cohort[in_class]):
            crng = np.random.default_rng([seed, int(cid), int(c), 0xC0C0])
            epoch = int(c) * window_m + max(
                window_m, 12, int(round(crng.normal(mu, sd) * 12)))
            sel = in_class & (cohort == c)
            life[sel] = np.maximum(1, epoch - t.month[sel])
    t.lifetime_m = life.astype(np.int32)
    return t


def _snap_refresh_waves(t: Trace, cycle_m: int) -> Trace:
    """Decommission-wave refresh cycles (`EnvelopeSpec.refresh_cycle_m`):
    every end-of-life month snaps *up* to the next multiple of the cycle,
    turning the smooth decommission stream into generation-turnover
    pulses (deployment months are untouched)."""
    decom = t.month + t.lifetime_m
    wave = -(-decom // cycle_m) * cycle_m          # ceil to next wave epoch
    t.lifetime_m = np.maximum(1, wave - t.month).astype(np.int32)
    return t


def generate_fleet_trace(env: EnvelopeSpec, seed: int = 0) -> Trace:
    """Multi-year deployment trace over the buildout horizon (§5.1).

    Spreads each class's annual targets (`env.annual_targets_kw`, kW)
    into monthly budgets with procurement seasonality and the envelope's
    demand-shock multipliers, then emits whole deployment events (GPU
    pods of `pod_racks`, non-GPU clusters of `quantum_racks`) until each
    budget is spent, carrying over-spend debt into the next month.
    Per-event rack power comes from the TDP projections (GPU) or the
    empirical SKU clusters (Eq. 3); lifetimes are N(μ,σ) draws
    (`LIFETIME`, months) unless the envelope's cohort/refresh knobs
    post-process them (see `_correlate_cohorts` / `_snap_refresh_waves`).

    All powers are kilowatts (`Trace.rack_kw` is per-rack kW; an event's
    power is `rack_kw * n_racks`).  `seed` fully determines the trace:
    the same `(env, seed)` pair is bit-for-bit reproducible, and
    scenario knobs at their neutral defaults (multiplier 1.0, window 0,
    cycle 0, `mix_end=None`) leave the draw sequence — hence the trace —
    identical to the paper baseline.  Returns the events sorted by
    arrival month (stable).
    """
    rng = np.random.default_rng(seed)
    years = np.arange(env.start_year, env.end_year + 1)
    mult = env.monthly_multipliers()
    recs = {f: [] for f in Trace.__dataclass_fields__}

    def emit(month, class_id, rack_kw, n_racks, is_pod, year):
        mu, sd = LIFETIME[class_id]
        life = max(12, int(round(rng.normal(mu, sd) * 12)))
        tier = TIER_LA if rng.random() < env.la_fraction else TIER_HA
        recs["month"].append(month)
        recs["class_id"].append(class_id)
        recs["rack_kw"].append(rack_kw)
        recs["n_racks"].append(n_racks)
        recs["is_gpu"].append(class_id == CLASS_GPU)
        recs["is_pod"].append(is_pod)
        recs["tier"].append(tier)
        recs["lifetime_m"].append(life)
        recs["harvest_frac"].append(HARVEST_FRAC[class_id])

    for class_id in (CLASS_GPU, CLASS_COMPUTE, CLASS_STORAGE):
        targets = env.annual_targets_kw(class_id)
        carry = 0.0          # over-spend debt carried into the next month
        for yi, year in enumerate(years):
            for mo in range(12):
                month = yi * 12 + mo
                budget = targets[yi] * SEASONALITY[mo] * mult[month] + carry
                spent = 0.0
                while spent < budget:
                    kw = _rack_kw_for(env, class_id, year, rng)
                    if class_id == CLASS_GPU:
                        n = env.pod_racks if env.pod_racks > 1 else 1
                        is_pod = env.pod_racks > 1
                    else:
                        n = env.quantum_racks
                        is_pod = False
                    emit(month, class_id, kw, n, is_pod, year)
                    spent += kw * n
                carry = budget - spent

    t = Trace(**{f: np.asarray(v) for f, v in recs.items()})
    t.month = t.month.astype(np.int32)
    t.class_id = t.class_id.astype(np.int32)
    t.rack_kw = t.rack_kw.astype(np.float32)
    t.n_racks = t.n_racks.astype(np.int32)
    t.tier = t.tier.astype(np.int32)
    t.lifetime_m = t.lifetime_m.astype(np.int32)
    t.harvest_frac = t.harvest_frac.astype(np.float32)
    if env.cohort_window_m > 0:
        t = _correlate_cohorts(t, env.cohort_window_m, seed)
    if env.refresh_cycle_m > 0:
        t = _snap_refresh_waves(t, env.refresh_cycle_m)
    return t.sorted_by_month()


@dataclass
class TraceBatch:
    """A batch of steady-state traces: every column is `[T, E]` (trial-major).

    Produced by `sample_mixed_traces` in one vectorized numpy RNG pass —
    the batched analogue of calling `sample_mixed_trace` once per trial.
    `trial(i)` recovers trial `i` as a plain 1-D `Trace`.
    """
    month: np.ndarray        # int32 [T, E]
    class_id: np.ndarray     # int32 [T, E]
    rack_kw: np.ndarray      # float32 [T, E]
    n_racks: np.ndarray      # int32 [T, E]
    is_gpu: np.ndarray       # bool [T, E]
    is_pod: np.ndarray       # bool [T, E]
    tier: np.ndarray         # int32 [T, E]
    lifetime_m: np.ndarray   # int32 [T, E]
    harvest_frac: np.ndarray  # float32 [T, E]

    def __len__(self):
        return self.month.shape[0]

    def trial(self, i: int) -> Trace:
        return Trace(**{f: getattr(self, f)[i]
                        for f in Trace.__dataclass_fields__})

    @property
    def n_pods(self) -> np.ndarray:
        """Per-trial pod-event count [T].  `sample_mixed_traces` emits
        pods first within every trial, so trial `t`'s pod events are
        exactly indices ``[0, n_pods[t])`` — the split-trace contract."""
        return self.is_pod.sum(axis=1).astype(np.int32)

    @property
    def max_pod_racks(self) -> int:
        """The batch's true largest pod size in racks (1 if pod-free) —
        the static rack-scan length the split-pods path needs."""
        pods = np.asarray(self.is_pod)
        return int(np.asarray(self.n_racks)[pods].max()) if pods.any() else 1


def sample_mixed_traces(n_trials: int, n_events: int, year: int = 2028,
                        scenario: str = proj.MED, seed: int = 0,
                        gpu_power_share: float = 0.6,
                        pod_racks: int = 1, quantum_racks: int = 10,
                        la_fraction: float = 0.0,
                        sku_kw_override: float | None = None,
                        single_sku_gpu: bool = False,
                        phase: int = 0) -> TraceBatch:
    """Batched `sample_mixed_trace`: `n_trials` steady-state traces in ONE
    vectorized numpy RNG pass (no per-trial / per-event Python loop).

    The single-hall Monte Carlo engine (`mc_sweep.mc_sweep`)
    consumes this directly; host-side trace synthesis used to dominate its
    wall time at small `n_events`.  Semantics match `sample_mixed_trace`
    (class mix calibrated from mean event power, SKU clusters per Eq. 3,
    N(μ,σ) lifetimes, LA tiers with probability `la_fraction`) with three
    deliberate differences:

    * the RNG is one `np.random.default_rng([seed, trial-batch salt])`
      stream drawing `[T, E]` grids, so a batch is bit-for-bit
      reproducible for equal arguments but individual trials are NOT
      bitwise-identical to per-trial `sample_mixed_trace` calls (the
      distributions are identical — equivalence is statistical);
    * the Fig. 6 single-SKU mode is a *generator argument*
      (`single_sku_gpu` + `sku_kw_override`) instead of post-hoc in-place
      mutation: `single_sku_gpu=True` emits only GPU-class events, and
      `sku_kw_override` replaces every GPU rack power;
    * with `pod_racks > 1` every trial's events are reordered **pods
      first** (stable, so relative order within pods and within clusters
      is preserved) — the same per-window contract the fleet trace keeps
      per month, which lets the split-pods scan run a pod window then a
      cluster window without reordering anything at placement time.
      `TraceBatch.n_pods` / `max_pod_racks` expose the window geometry.

    `phase` salts an independent stream per (seed, phase) pair — the MC
    engine draws fill traces at phase 0 and refill traces at phase 1, so
    a configuration seeded `s` never shares a stream with configuration
    `s+1` (phase 0 keeps the historical `[seed, salt]` stream).
    """
    salt = ([int(seed), 0x6D63] if phase == 0
            else [int(seed), int(phase), 0x6D63])      # 'mc' trial salt
    rng = np.random.default_rng(salt)
    T, E = int(n_trials), int(n_events)
    gpu_n = pod_racks if pod_racks > 1 else 1
    gpu_kw = proj.gpu_rack_kw(year, scenario, pod_scale=pod_racks > 1)

    if single_sku_gpu:
        cid = np.full((T, E), CLASS_GPU, np.int32)
    else:
        shares = {CLASS_GPU: gpu_power_share,
                  CLASS_COMPUTE: (1 - gpu_power_share) * 0.7,
                  CLASS_STORAGE: (1 - gpu_power_share) * 0.3}
        # power shares → event probabilities via mean event power, with the
        # same 64-draw calibration `sample_mixed_trace` uses (vectorized)
        mean_event_kw = {CLASS_GPU: gpu_kw * gpu_n}
        for cls, pmax_fn, skus in (
                (CLASS_COMPUTE, proj.compute_rack_kw, COMPUTE_SKUS),
                (CLASS_STORAGE, proj.storage_rack_kw, STORAGE_SKUS)):
            alphas = np.array([a for a, _ in skus])
            probs = np.array([p for _, p in skus])
            draws = pmax_fn(year, scenario) * rng.choice(alphas, size=64,
                                                         p=probs)
            mean_event_kw[cls] = draws.mean() * quantum_racks
        p = np.array([shares[c] / mean_event_kw[c]
                      for c in (CLASS_GPU, CLASS_COMPUTE, CLASS_STORAGE)])
        cid = rng.choice(np.array([CLASS_GPU, CLASS_COMPUTE, CLASS_STORAGE],
                                  np.int32), size=(T, E),
                         p=p / p.sum()).astype(np.int32)
    is_gpu = cid == CLASS_GPU

    # per-SKU rack power (Eq. 3), one choice grid per non-GPU class
    def sku_kw(pmax, skus):
        alphas = np.array([a for a, _ in skus])
        probs = np.array([p for _, p in skus])
        return pmax * rng.choice(alphas, size=(T, E), p=probs)

    rack_kw = np.where(
        is_gpu, gpu_kw,
        np.where(cid == CLASS_COMPUTE,
                 sku_kw(proj.compute_rack_kw(year, scenario), COMPUTE_SKUS),
                 sku_kw(proj.storage_rack_kw(year, scenario), STORAGE_SKUS)))
    if sku_kw_override is not None:
        rack_kw = np.where(is_gpu, float(sku_kw_override), rack_kw)

    tier = np.where(rng.random((T, E)) < la_fraction, TIER_LA, TIER_HA)
    mu = np.array([LIFETIME[c][0] for c in range(3)])[cid]
    sd = np.array([LIFETIME[c][1] for c in range(3)])[cid]
    lifetime_m = np.maximum(12, np.round(rng.normal(mu, sd) * 12.0))

    if pod_racks > 1:
        # pods-first per trial (stable — in-group order preserved): the
        # split-trace contract; a pure reorder, so per-event marginals
        # and the realized power mix are untouched
        order = np.argsort(~is_gpu, axis=1, kind="stable")
        take = lambda a: np.take_along_axis(a, order, axis=1)
        cid, rack_kw, tier, lifetime_m = map(
            take, (cid, rack_kw, tier, lifetime_m))
        is_gpu = cid == CLASS_GPU

    return TraceBatch(
        month=np.zeros((T, E), np.int32),
        class_id=cid,
        rack_kw=rack_kw.astype(np.float32),
        n_racks=np.where(is_gpu, gpu_n, quantum_racks).astype(np.int32),
        is_gpu=is_gpu,
        is_pod=is_gpu & (pod_racks > 1),
        tier=tier.astype(np.int32),
        lifetime_m=lifetime_m.astype(np.int32),
        harvest_frac=np.array([HARVEST_FRAC[c]
                               for c in range(3)])[cid].astype(np.float32),
    )


def sample_mixed_trace(n_events: int, year: int = 2028,
                       scenario: str = proj.MED, seed: int = 0,
                       gpu_power_share: float = 0.6,
                       pod_racks: int = 1, quantum_racks: int = 10,
                       la_fraction: float = 0.0) -> Trace:
    """Steady-state mixed-SKU stream for single-hall Monte Carlo (§4.4).

    Unlike `generate_fleet_trace` there is no buildout calendar: all
    `n_events` arrive at month 0 (the saturation simulator places them
    until the hall fills).  Event *class* probabilities are derived from
    the target power shares — GPU gets `gpu_power_share` of added power,
    the remainder splits 0.7/0.3 between general compute and storage —
    by dividing each share by the class's empirical mean event power
    (64 calibration draws per class), so the realized power mix matches
    the requested split.  `rack_kw` is per-rack kilowatts; an event's
    power is `rack_kw * n_racks` with `n_racks = pod_racks` for GPU pods
    (1 if rack-scale) and `quantum_racks` otherwise.  `seed` drives one
    `np.random.default_rng` stream through calibration and sampling, so
    equal `(n_events, year, scenario, seed, …)` calls are bit-for-bit
    reproducible; class ids are `resources.CLASS_*`, tiers
    `resources.TIER_HA/TIER_LA` (LA with probability `la_fraction`).
    """
    rng = np.random.default_rng(seed)
    env = EnvelopeSpec(gpu_scenario=scenario, nongpu_scenario=scenario,
                       pod_racks=pod_racks, quantum_racks=quantum_racks,
                       la_fraction=la_fraction)
    shares = {CLASS_GPU: gpu_power_share,
              CLASS_COMPUTE: (1 - gpu_power_share) * 0.7,
              CLASS_STORAGE: (1 - gpu_power_share) * 0.3}
    # convert power shares → event probabilities via mean event power
    mean_event_kw = {}
    for cid in shares:
        kws = [_rack_kw_for(env, cid, year, rng) for _ in range(64)]
        n = pod_racks if (cid == CLASS_GPU and pod_racks > 1) else (
            1 if cid == CLASS_GPU else quantum_racks)
        mean_event_kw[cid] = np.mean(kws) * n
    p = np.array([shares[c] / mean_event_kw[c]
                  for c in (CLASS_GPU, CLASS_COMPUTE, CLASS_STORAGE)])
    p = p / p.sum()

    recs = {f: [] for f in Trace.__dataclass_fields__}
    for i in range(n_events):
        cid = int(rng.choice([CLASS_GPU, CLASS_COMPUTE, CLASS_STORAGE], p=p))
        kw = _rack_kw_for(env, cid, year, rng)
        if cid == CLASS_GPU:
            n, is_pod = (pod_racks, pod_racks > 1) if pod_racks > 1 else (1, False)
        else:
            n, is_pod = quantum_racks, False
        mu, sd = LIFETIME[cid]
        recs["month"].append(0)
        recs["class_id"].append(cid)
        recs["rack_kw"].append(kw)
        recs["n_racks"].append(n)
        recs["is_gpu"].append(cid == CLASS_GPU)
        recs["is_pod"].append(is_pod)
        recs["tier"].append(TIER_LA if rng.random() < la_fraction else TIER_HA)
        recs["lifetime_m"].append(max(12, int(round(rng.normal(mu, sd) * 12))))
        recs["harvest_frac"].append(HARVEST_FRAC[cid])

    t = Trace(**{f: np.asarray(v) for f, v in recs.items()})
    t.month = t.month.astype(np.int32)
    t.class_id = t.class_id.astype(np.int32)
    t.rack_kw = t.rack_kw.astype(np.float32)
    t.n_racks = t.n_racks.astype(np.int32)
    t.tier = t.tier.astype(np.int32)
    t.lifetime_m = t.lifetime_m.astype(np.int32)
    t.harvest_frac = t.harvest_frac.astype(np.float32)
    return t

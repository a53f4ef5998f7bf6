"""Fleet-scale lifecycle simulator (paper §4.4, Fig. 8 pipeline), pod-free.

Places a multi-year arrival trace across a growing fleet of identical
halls: opens a new hall when no feasible placement exists, harvests racks
one year after deployment, and decommissions racks at end-of-life.

The counterpart of `repro.core.fleet` for traces without multi-row pods.
`repro` runs the lifecycle as one `lax.scan` over months with an inner
scan over each month's events, `vmap`ped over configurations; the port
runs the same two loops in Python over one batched device state, so each
event step places one event in every configuration with one
placement-score launch.  The month's placement results come back to the
host once per month: the registry of where each event landed, and the
decommission/harvest bookkeeping that reads it, live there (see
`placement.release_bulk`).

Not ported yet, each raising `NotImplementedError`: traces with pods
(`with_pods=True`, ROADMAP queue 1, items 4 and 6), the pre-split
`legacy_pod_cond=True` reference path (with the pods), and the streaming
quantiles of `exact_quantiles=False` (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import cost, placement as pl, prng
from .arrivals import EnvelopeSpec, Trace, generate_fleet_trace
from .hierarchy import DesignSpec, build_topology
from .placement import DEFAULT_POLICY, Deployment, HallState, Topology
from ..device import resolve_device

_PODS_TODO = ("multi-row pods (_place_pod and the split-trace pod window) "
              "are not ported yet (ROADMAP queue 1, items 4 and 6)")
_STREAMING_TODO = ("exact_quantiles=False (streaming histogram quantiles) is "
                   "not ported yet (ROADMAP queue 1, item 6)")


@dataclass
class FleetConfig:
    design: DesignSpec
    env: EnvelopeSpec = field(default_factory=EnvelopeSpec)
    policy: int = DEFAULT_POLICY
    harvest: bool = True
    seed: int = 0
    n_halls_max: int = 0          # 0 → auto-size from demand
    mature_months: int = 12       # halls older than this enter tail stats


@dataclass
class FleetResult:
    months: np.ndarray            # [M]
    halls_active: np.ndarray      # [M]
    deployed_mw: np.ndarray       # [M]
    p50_stranding: np.ndarray     # [M] over mature halls
    p90_stranding: np.ndarray     # [M]
    final_hall_stranding: np.ndarray   # [H_active]
    final_lineup_stranding: np.ndarray  # [X_active] (active halls)
    n_halls_built: int
    final_deployed_mw: float
    placed_fraction: float
    design: DesignSpec = None
    env: EnvelopeSpec = None

    @property
    def initial_dpm(self):
        return cost.initial_dollars_per_mw(self.design)

    @property
    def effective_dpm(self):
        return cost.effective_dollars_per_mw(
            self.design, self.n_halls_built, self.final_deployed_mw)

    @property
    def total_capex(self):
        return self.n_halls_built * cost.hall_capex(self.design)


def _auto_halls(design: DesignSpec, env: EnvelopeSpec) -> int:
    # demand_multiplier() rescales cumulative demand under shock scenarios
    total_mw = (env.gpu_gw + env.compute_gw + env.storage_gw) * 1e3 \
        * env.demand_scale * env.demand_multiplier()
    # decommissioning returns capacity; 45% slack covers stranding + churn
    return int(np.ceil(total_mw / (design.ha_capacity_kw / 1e3) * 1.45)) + 4


class FleetTrace(NamedTuple):
    """Trace columns of N configurations, each padded to E events."""
    month: torch.Tensor         # i32 [N, E]
    rack_kw: torch.Tensor       # f32 [N, E]
    n_racks: torch.Tensor       # i32 [N, E]
    is_gpu: torch.Tensor        # bool [N, E]
    is_pod: torch.Tensor        # bool [N, E]
    tier: torch.Tensor          # i32 [N, E]
    harvest_frac: torch.Tensor  # f32 [N, E]
    lifetime_m: torch.Tensor    # i32 [N, E]

    @staticmethod
    def from_traces(traces: Sequence[Trace], pad_to: int | None = None,
                    pad_month: int = 0) -> "FleetTrace":
        """Stack traces on the host, padding each to `pad_to` events
        (default: the longest) with never-arriving placeholders (month =
        `pad_month`, which must be ≥ the simulated horizon)."""
        E = max([pad_to or 0] + [len(t) for t in traces])

        def col(name, fill, dtype):
            rows = []
            for t in traces:
                a = np.asarray(getattr(t, name))
                rows.append(np.concatenate(
                    [a, np.full((E - len(a),), fill, a.dtype)]))
            return torch.as_tensor(np.stack(rows), dtype=dtype)

        return FleetTrace(
            month=col("month", pad_month, torch.int32),
            rack_kw=col("rack_kw", 0.0, torch.float32),
            n_racks=col("n_racks", 1, torch.int32),
            is_gpu=col("is_gpu", False, torch.bool),
            is_pod=col("is_pod", False, torch.bool),
            tier=col("tier", 0, torch.int32),
            harvest_frac=col("harvest_frac", 0.0, torch.float32),
            lifetime_m=col("lifetime_m", 10 ** 6, torch.int32),
        )


def _month_e_max(trace: Trace, months: int) -> int:
    """Largest per-month event count (the inner loop length)."""
    month = np.asarray(trace.month)
    starts = np.searchsorted(month, np.arange(months))
    ends = np.searchsorted(month, np.arange(months), side="right")
    return max(1, int((ends - starts).max())) if len(month) else 1


def _month_slices(trace: Trace, months: int, e_max: int | None = None,
                  modulo: int | None = None):
    """Per-month event-index windows [M, e_max] plus validity mask.
    `modulo` must equal the (padded) trace length."""
    month = np.asarray(trace.month)
    starts = np.searchsorted(month, np.arange(months))
    ends = np.searchsorted(month, np.arange(months), side="right")
    e_max = e_max or (max(1, int((ends - starts).max()))
                      if len(month) else 1)
    pos = starts[:, None] + np.arange(e_max)[None, :]       # [M, e_max]
    valid = pos < ends[:, None]
    E = modulo or max(1, len(trace))
    return (pos % E).astype(np.int32), valid


def _event_windows(trace: Trace, months: int, split_pods: bool,
                   e_max: int | None = None, modulo: int | None = None):
    """(idx, valid): each month's window over ALL its events, the
    pod-free path of `repro`'s `_event_windows`."""
    if split_pods:
        raise NotImplementedError(_PODS_TODO)
    return _month_slices(trace, months, e_max=e_max, modulo=modulo)


class SimOutputs(NamedTuple):
    """Outputs of N lifecycles.  The first nine fields are `repro`'s
    `SimOutputs` with a leading batch axis; the registry fields are the
    port's own, for parity checks of every placement decision."""
    halls_active: torch.Tensor            # [N, M] i64
    deployed_kw: torch.Tensor             # [N, M] f32
    p50_stranding: torch.Tensor           # [N, M] f32
    p90_stranding: torch.Tensor           # [N, M] f32
    final_hall_stranding: torch.Tensor    # [N, H] f32
    final_lineup_stranding: torch.Tensor  # [N, X] f32
    n_halls_built: torch.Tensor           # [N] i64
    final_deployed_kw: torch.Tensor       # [N] f32
    placed_fraction: torch.Tensor         # [N] f32
    act_month: torch.Tensor               # [N, H] i64: hall opening month
    reg_rows: torch.Tensor                # [N, E] i64 (host): row, -1 if
                                          # the event was not placed
    event_steps: int                      # placement steps run


def _masked_percentiles(x, mask, qs):
    """np.percentile('linear') over x[mask] along the last axis for each
    static q in `qs` (one shared sort); an all-False mask yields NaN."""
    inf = torch.full_like(x, float("inf"))
    s = torch.sort(torch.where(mask, x, inf), dim=-1).values
    nonempty = mask.any(dim=-1)
    top = (torch.clamp(mask.sum(dim=-1), min=1) - 1).float()
    out = []
    for q in qs:
        pos = q / 100.0 * top
        lo = torch.floor(pos).long()
        hi = torch.ceil(pos).long()
        frac = pos - lo.float()
        v = s.gather(-1, lo[..., None])[..., 0] * (1.0 - frac) + \
            s.gather(-1, hi[..., None])[..., 0] * frac
        out.append(torch.where(nonempty, v, torch.full_like(v, float("nan"))))
    return tuple(out)


def _mature_mask(am, m, mature_months):
    """Which halls enter month `m`'s tail stats: active halls older than
    `mature_months`, falling back to all active halls while none are."""
    mature = (am >= 0) & (am <= m - mature_months)
    return torch.where(mature.any(dim=-1, keepdim=True), mature, am >= 0)


_NEW_HALL_BIAS = 1e6   # keeps placements in existing halls when feasible


def simulate_lifecycle(jt: Topology, ft: FleetTrace, idx, valid, policy,
                       h_cap, n_real, *, harvest: bool, mature_months: int,
                       seeds=None, with_pods: bool = False,
                       legacy_pod_cond: bool = False,
                       exact_quantiles: bool = True,
                       interpret: bool = False) -> SimOutputs:
    """Run N monthly lifecycles on `jt`'s device.

    `idx`/`valid` ([N, M, e_max], host arrays) window each month's
    events; `policy` comes from `placement.policy_tensor`; `h_cap` ([N])
    caps hall opening per configuration; `n_real` ([N]) counts the real
    (unpadded) events; `seeds` ([N] ints) key the random policy's draws
    and are needed only where a configuration runs it: configuration n
    keys by ``PRNGKey(int32(seeds[n]) + 1)``, month m by ``fold_in(key,
    m)``, and the event in slot i of the month's window by ``fold_in(
    month key, i)``, drawing one score per row of the whole padded fleet,
    as `repro` does.  A month's draws are made in one batched pass before
    its event loop.  Each month runs decommission, harvest, then every
    event of its window with one biased attempt over halls `< n + 1`
    (`repro`'s pod-free path: the bias keeps a cluster in the existing
    halls whenever one of their rows fits, so one attempt equals
    try-then-open-a-hall), then hall activations.  Event steps where no
    configuration has a live event change nothing and are skipped.
    `interpret=True` scores rows with the plain version instead of the
    CUDA kernel."""
    if with_pods or legacy_pod_cond:
        raise NotImplementedError(_PODS_TODO)
    if not exact_quantiles:
        raise NotImplementedError(_STREAMING_TODO)
    dev = jt.row_cap.device
    host = torch.device("cpu")
    N, H = jt.hall_liq_cap.shape
    R = jt.row_cap.shape[1]
    random = (policy == pl.POLICY_RANDOM).cpu()
    keys = None
    if random.any():
        if seeds is None:
            raise ValueError("the random policy needs the configurations' "
                             "seeds")
        keys = prng.prng_key([int(s) + 1 for s in seeds], dev)
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
    valid = torch.as_tensor(np.asarray(valid), dtype=torch.bool)
    M, e_max = idx.shape[1], idx.shape[2]
    ft = FleetTrace(*(t.to(host) for t in ft))
    jt_host = Topology(*(t.to(host) for t in jt))

    # per-step deployments for every configuration, [M, e_max, N] on device
    flat_idx = idx.reshape(N, M * e_max)

    def steps(col):
        return col.gather(1, flat_idx).reshape(N, M, e_max) \
            .permute(1, 2, 0).contiguous().to(dev)

    step_kw, step_nr = steps(ft.rack_kw), steps(ft.n_racks)
    step_gpu, step_tier = steps(ft.is_gpu), steps(ft.tier)
    step_live = valid.permute(1, 2, 0).contiguous()
    step_live_dev = step_live.to(dev)

    state = pl.init_state(jt)
    # the registry, on the host: the row each event landed in, -1 while
    # unplaced (a pod-free event fills one row, with all its racks)
    reg_rows = torch.full((N, ft.month.shape[1]), -1, dtype=torch.int64)
    harvested = torch.zeros(reg_rows.shape, dtype=torch.bool)
    removed = harvested.clone()
    zero_frac = torch.zeros_like(ft.harvest_frac)

    row_hall = jt.row_hall
    hall_ids = torch.arange(H, device=dev)
    h_cap = torch.as_tensor(np.asarray(h_cap), dtype=torch.int64, device=dev)
    n_active = torch.ones((N,), dtype=torch.int64, device=dev)
    act_month = torch.full((N, H), -1, dtype=torch.int64, device=dev)
    act_month[:, 0] = 0
    hist_halls, hist_deployed, hist_strand, hist_act = [], [], [], []
    event_steps = 0

    def release(st, fraction):
        counts = torch.where(reg_rows >= 0, ft.n_racks.float(), 0.0)
        return pl.release_bulk(jt_host, st, reg_rows[..., None],
                               counts[..., None], ft.rack_kw, ft.is_gpu,
                               ft.tier, fraction)

    for m in range(M):
        # ---- 1. decommission expired racks ----
        placed = reg_rows >= 0
        expire = placed & ~removed & (ft.month + ft.lifetime_m <= m)
        if expire.any():
            frac = torch.where(harvested, ft.harvest_frac, zero_frac)
            state = release(state, torch.where(expire, 1.0 - frac, zero_frac))
        removed = removed | expire

        # ---- 2. harvest one-year-old racks ----
        if harvest:
            hv = placed & ~removed & ~harvested & (ft.month + 12 <= m)
            if hv.any():
                state = release(state, torch.where(hv, ft.harvest_frac,
                                                   zero_frac))
            harvested = harvested | hv

        # ---- 3. place this month's arrivals ----
        draws = (None if keys is None else
                 pl.random_draws(prng.fold_in(keys, m), random, e_max, R))
        ran, rows_m = [], []
        for i in range(e_max):
            if not bool(step_live[m, i].any()):
                continue
            dep = Deployment(step_kw[m, i], step_nr[m, i], step_gpu[m, i],
                             step_tier[m, i])
            n_try = torch.minimum(n_active + 1, h_cap)
            bias = torch.where(row_hall >= n_active[:, None], _NEW_HALL_BIAS,
                               0.0)
            state, ok, row = pl.place_in_row(
                jt, state, dep, dep.n_racks, policy,
                row_hall < n_try[:, None], score_bias=bias,
                live=step_live_dev[m, i],
                rand=None if draws is None else draws[i],
                interpret=interpret)
            hall = row_hall.gather(1, row.clamp(min=0)[:, None])[:, 0]
            n_new = torch.where(ok & (hall < n_active), n_active, n_try)
            n_active = torch.where(step_live_dev[m, i], n_new, n_active)
            ran.append(i)
            rows_m.append(row)
            event_steps += 1

        if ran:   # one copy to the host per month: the registry update
            rows_h = torch.stack(rows_m, 1).to(host)           # [N, S]
            n_i, s_i = torch.nonzero(valid[:, m, ran], as_tuple=True)
            reg_rows[n_i, idx[:, m, ran][n_i, s_i]] = rows_h[n_i, s_i]

        # ---- 4. hall activations and the month's stats ----
        act_month = torch.where(
            (act_month < 0) & (hall_ids[None, :] < n_active[:, None]), m,
            act_month)
        hist_halls.append(n_active)
        hist_deployed.append(pl.deployed_kw(state))
        hist_strand.append(pl.hall_stranding(jt, state))
        hist_act.append(act_month)

    # ---- exact p50/p90 over the [N, M, H] stranding history ----
    strand = torch.stack(hist_strand, 1)
    acts = torch.stack(hist_act, 1)
    months = torch.arange(M, device=dev)[None, :, None]
    p50, p90 = _masked_percentiles(
        strand, _mature_mask(acts, months, mature_months), (50.0, 90.0))

    n_real = torch.as_tensor(np.asarray(n_real), dtype=torch.float32)
    pf = (reg_rows >= 0).float().sum(dim=1) / torch.clamp(n_real, min=1.0)
    return SimOutputs(
        halls_active=torch.stack(hist_halls, 1),
        deployed_kw=torch.stack(hist_deployed, 1),
        p50_stranding=p50, p90_stranding=p90,
        final_hall_stranding=pl.hall_stranding(jt, state),
        final_lineup_stranding=pl.lineup_stranding(jt, state),
        n_halls_built=n_active, final_deployed_kw=pl.deployed_kw(state),
        placed_fraction=pf.to(dev), act_month=act_month,
        reg_rows=reg_rows, event_steps=event_steps)


def make_fleet_result(out, months: int, lineups_per_hall: int,
                      lineup_is_active: np.ndarray, design: DesignSpec,
                      env: EnvelopeSpec) -> FleetResult:
    """Host-side unpack of one configuration's outputs (numpy leaves)
    into the public `FleetResult` (shared by `run_fleet` and
    `SweepResult.result`)."""
    na = int(out.n_halls_built)
    hs = np.asarray(out.final_hall_stranding)
    lstr = np.asarray(out.final_lineup_stranding)
    active_lineups = np.arange(lstr.shape[0]) // lineups_per_hall < na
    active_mask = np.asarray(lineup_is_active) & active_lineups
    return FleetResult(
        months=np.arange(months),
        halls_active=np.asarray(out.halls_active),
        deployed_mw=np.asarray(out.deployed_kw) / 1e3,
        p50_stranding=np.asarray(out.p50_stranding),
        p90_stranding=np.asarray(out.p90_stranding),
        final_hall_stranding=hs[:na],
        final_lineup_stranding=lstr[active_mask],
        n_halls_built=na,
        final_deployed_mw=float(out.final_deployed_kw) / 1e3,
        placed_fraction=float(out.placed_fraction),
        design=design, env=env,
    )


def run_fleet(cfg: FleetConfig, trace: Trace | None = None,
              device="cuda", interpret: bool = False,
              exact_quantiles: bool = True) -> FleetResult:
    """Single-configuration lifecycle at the topology's exact shape (no
    sweep padding): `repro`'s `run_fleet` for pod-free traces.

    Args:
        cfg: design/envelope/policy/seed bundle (see `FleetConfig`).
        trace: optional pre-generated arrival trace; defaults to
            `generate_fleet_trace(cfg.env, cfg.seed)`.
        device: where the lifecycle runs (default ``"cuda"``).
        interpret: score rows with the plain version, not the kernel.
        exact_quantiles: only `True` is ported.
    """
    dev = resolve_device(device)
    design, env = cfg.design, cfg.env
    if trace is None:
        trace = generate_fleet_trace(env, cfg.seed)
    if bool(np.asarray(trace.is_pod).any()):
        raise NotImplementedError(_PODS_TODO)
    months = env.n_months
    H = cfg.n_halls_max or _auto_halls(design, env)
    topo = build_topology(design, H)
    jt = pl.topology([topo], dev)
    ft = FleetTrace.from_traces([trace])
    idx, valid = _event_windows(trace, months, False)
    out = simulate_lifecycle(
        jt, ft, idx[None], valid[None], pl.policy_tensor([cfg.policy], dev),
        [H], [len(trace)], harvest=cfg.harvest, seeds=[cfg.seed],
        mature_months=cfg.mature_months, exact_quantiles=exact_quantiles,
        interpret=interpret)
    one = type(out)(*(x[0].cpu().numpy() if torch.is_tensor(x) else x
                      for x in out))
    return make_fleet_result(one, months, topo.lineups_per_hall,
                             topo.lineup_is_active, design, env)

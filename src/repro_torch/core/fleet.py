"""Fleet-scale lifecycle simulator (paper §4.4, Fig. 8 pipeline).

Places a multi-year arrival trace across a growing fleet of identical
halls: opens a new hall when no feasible placement exists, harvests racks
one year after deployment, and decommissions racks at end-of-life.

The counterpart of `repro.core.fleet`.  `repro` runs the lifecycle as one
`lax.scan` over months with inner scans over each month's events,
`vmap`ped over configurations; the port runs the same loops in Python
over one batched device state, so each placement step places one event
(or one rack of a pod) in every configuration with one placement-score
launch.  The month's placement results come back to the host once per
month: the registry of where each event's racks landed, and the
decommission/harvest bookkeeping that reads it, live there (see
`placement.release_bulk`).

Traces with multi-row GPU pods run `repro`'s split-trace mode by default
(each month a pod window, then a cluster window) or, with
``legacy_pod_cond=True``, its per-event cond over all events.  The
monthly p50/p90 stranding is exact over the whole history, or with
``exact_quantiles=False`` a streaming histogram estimate of each month
(`quantiles.hist_masked_quantiles`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import cost, placement as pl, prng, quantiles as qt
from .arrivals import EnvelopeSpec, Trace, generate_fleet_trace
from .hierarchy import DesignSpec, build_topology
from .placement import DEFAULT_POLICY, MAX_POD_RACKS, Deployment, Topology
from ..device import resolve_device


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


def _month_e_max(trace: Trace, months: int,
                 select: np.ndarray | None = None) -> int:
    """Largest per-month event count (the inner loop length), optionally
    over the `select`-ed subset of events (the split-trace pod and
    cluster windows)."""
    month = np.asarray(trace.month)
    if select is not None:
        month = month[np.asarray(select)]
    starts = np.searchsorted(month, np.arange(months))
    ends = np.searchsorted(month, np.arange(months), side="right")
    return max(1, int((ends - starts).max())) if len(month) else 1


def _month_slices(trace: Trace, months: int, e_max: int | None = None,
                  modulo: int | None = None,
                  select: np.ndarray | None = None):
    """Per-month event-index windows [M, e_max] plus validity mask.
    `modulo` must equal the (padded) trace length.  With `select` (a
    boolean event mask) the windows cover only the selected events, their
    indices still into the full trace: the split-trace pod and cluster
    windows."""
    month = np.asarray(trace.month)
    eids = None
    if select is not None:
        eids = np.flatnonzero(np.asarray(select))
        month = month[eids]
    starts = np.searchsorted(month, np.arange(months))
    ends = np.searchsorted(month, np.arange(months), side="right")
    e_max = e_max or (max(1, int((ends - starts).max()))
                      if len(month) else 1)
    pos = starts[:, None] + np.arange(e_max)[None, :]       # [M, e_max]
    valid = pos < ends[:, None]
    E = modulo or max(1, len(trace))
    if eids is None:
        idx = pos % E
    elif len(eids):
        idx = np.where(valid, eids[pos % len(eids)], 0)
    else:
        idx = np.zeros_like(pos)
    return idx.astype(np.int32), valid, e_max


def _pod_scan_len(traces) -> int:
    """Rack-scan length of the split-trace pod path: the largest pod size
    across `traces`, capped at `MAX_POD_RACKS`."""
    n = 1
    for t in traces:
        pods = np.asarray(t.is_pod)
        if pods.any():
            n = max(n, int(np.asarray(t.n_racks)[pods].max()))
    return min(n, MAX_POD_RACKS)


def _event_windows(trace: Trace, months: int, split_pods: bool,
                   e_max: int | None = None, ep_max: int | None = None,
                   modulo: int | None = None):
    """(idx, valid, idx_pod, valid_pod) for `simulate_lifecycle`.

    `split_pods=True` partitions each month's window into pod events
    (placed first, the order generated traces have) and cluster events;
    otherwise the first window covers all events and the pod window is a
    1-wide all-invalid dummy.  The split keeps placement order and keys
    only when pods precede clusters within every month, as
    `generate_fleet_trace` emits them; a trace with a pod after a cluster
    of its month raises `ValueError` (sort it pods-first per month, or
    run with ``legacy_pod_cond=True``)."""
    if split_pods:
        pod = np.asarray(trace.is_pod)
        month = np.asarray(trace.month)
        same_month = month[1:] == month[:-1]
        if bool(np.any(same_month & pod[1:] & ~pod[:-1])):
            raise ValueError(
                "split-trace scan needs pod events to precede cluster "
                "events within each month (the generated-trace order); "
                "sort the trace pods-first per month or use "
                "legacy_pod_cond=True")
        idx, valid, _ = _month_slices(trace, months, e_max=e_max,
                                      modulo=modulo, select=~pod)
        idx_p, valid_p, _ = _month_slices(trace, months, e_max=ep_max,
                                          modulo=modulo, select=pod)
    else:
        idx, valid, _ = _month_slices(trace, months, e_max=e_max,
                                      modulo=modulo)
        idx_p = np.zeros((months, ep_max or 1), np.int32)
        valid_p = np.zeros((months, ep_max or 1), bool)
    return idx, valid, idx_p, valid_p


class SimOutputs(NamedTuple):
    """Outputs of N lifecycles.  The first nine fields are `repro`'s
    `SimOutputs` with a leading batch axis; the others are the port's
    own, for parity checks of every placement decision."""
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
    reg_rows: torch.Tensor                # [N, E, MAX_POD_RACKS] i64
                                          # (host): the rows an event's
                                          # racks landed in, -1 padded
    reg_counts: torch.Tensor              # [N, E, MAX_POD_RACKS] f32
                                          # (host): racks per row
    event_steps: int                      # placement steps run (launches)
    pod_steps: int                        # of which pod racks


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


def _slots(col, idx):
    """A host trace column ([N, E]) at each window slot (`idx` [N, M,
    e_max] event ids): [M, e_max, N]."""
    return col.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape) \
        .permute(1, 2, 0)


def _step_columns(ft: FleetTrace, idx, dev):
    """The deployment at each window slot, [M, e_max, N] on `dev`."""
    return Deployment(*(_slots(c, idx).contiguous().to(dev) for c in (
        ft.rack_kw, ft.n_racks, ft.is_gpu, ft.tier, ft.is_pod)))


def _attempt_retry(place, state, live, n_active, n_try, row_hall):
    """`repro`'s attempt in the open halls, then, for the live
    configurations where it failed, the retry that may open hall
    ``n_try - 1``: ``place(state, row_active, live) → (state', ok, rows,
    counts)``.  A failed attempt leaves a configuration's state as it
    was, so the retry runs on the attempt's state.  The retry runs only
    if some configuration needs it (one read of the card).  Returns
    (state', ok, rows, counts, n_active', tries), tries being 1 or 2."""
    st, ok, rows, counts = place(state, row_hall < n_active[:, None], live)
    retry = live & ~ok
    n_new = torch.where(ok, n_active, n_try)
    tries = 1
    if bool(retry.any()):
        st, ok2, rows2, counts2 = place(st, row_hall < n_try[:, None], retry)
        rows = torch.where(ok[:, None], rows, rows2)
        counts = torch.where(ok[:, None], counts, counts2)
        ok = ok | ok2
        tries = 2
    return st, ok, rows, counts, torch.where(live, n_new, n_active), tries


def simulate_lifecycle(jt: Topology, ft: FleetTrace, idx, valid, idx_pod,
                       valid_pod, policy, h_cap, n_real, *, harvest: bool,
                       mature_months: int, seeds=None,
                       with_pods: bool = False,
                       legacy_pod_cond: bool = False,
                       pod_scan_len: int = MAX_POD_RACKS,
                       hd_scan: int | None = None,
                       exact_quantiles: bool = True,
                       quantile_bins: int | None = None,
                       interpret: bool = False) -> SimOutputs:
    """Run N monthly lifecycles on `jt`'s device.

    `idx`/`valid` and `idx_pod`/`valid_pod` ([N, M, e_max] and [N, M,
    ep_max], host arrays) are `_event_windows`' cluster and pod windows;
    `policy` comes from `placement.policy_tensor`; `h_cap` ([N]) caps
    hall opening per configuration; `n_real` ([N]) counts the real
    (unpadded) events; `seeds` ([N] ints) key the random policy's draws
    and are needed only where a configuration runs it: configuration n
    keys by ``PRNGKey(int32(seeds[n]) + 1)``, month m by ``fold_in(key,
    m)``, the event in slot i of the month by ``fold_in(month key, i)``
    (a split month's cluster slots count on from its pod count), and
    rack r of a pod by ``fold_in(event key, r)``, each drawing one score
    per row of the whole padded fleet, as `repro` does.

    Each month runs decommission, harvest, the month's placements, then
    hall activations and the month's stats.  Placement follows `repro`'s
    three modes:

    * ``with_pods=False``: every event of the window with one biased
      attempt over halls ``< n + 1`` (the bias keeps a cluster in the
      open halls whenever one of their rows fits, so one attempt equals
      try-then-open-a-hall);
    * split trace (``with_pods=True``): the month's pods first, each an
      atomic `placement._place_pod` in the open halls, then a whole-pod
      retry that may open a hall, both on the same rack keys, over the
      HD-compacted view ``hd_index[:, :hd_scan]`` when `hd_scan` is
      given; then the clusters, biased as above.  `pod_scan_len` (≥ the
      largest pod) bounds the rack scan;
    * ``legacy_pod_cond=True``: every event of the window through
      `placement.place` (pod or cluster by the event), attempt then
      retry, the pod scan over all rows and up to `MAX_POD_RACKS` racks.

    Slots and racks where no configuration is live change nothing and
    are not run; each step run is one placement-score launch
    (`event_steps`, of which `pod_steps` placed pod racks).

    `exact_quantiles=True` takes the monthly p50/p90 over the whole
    ``[N, M, H]`` stranding history; `False` takes each month's
    `quantiles.hist_masked_quantiles` over its ``[N, H]`` cross-section
    (`quantile_bins` buckets, default `quantiles.DEFAULT_BINS`; error ≤
    one bucket) and keeps no history.  `interpret=True` scores rows with
    the plain version instead of the CUDA kernel."""
    dev = jt.row_cap.device
    host = torch.device("cpu")
    N, H = jt.hall_liq_cap.shape
    R = jt.row_cap.shape[1]
    split = with_pods and not legacy_pod_cond
    n_bins = quantile_bins or qt.DEFAULT_BINS
    random = (policy == pl.POLICY_RANDOM).cpu()
    keys = None
    if random.any():
        if seeds is None:
            raise ValueError("the random policy needs the configurations' "
                             "seeds")
        keys = prng.prng_key([int(s) + 1 for s in seeds], dev)
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
    valid = torch.as_tensor(np.asarray(valid), dtype=torch.bool)
    idx_pod = torch.as_tensor(np.asarray(idx_pod), dtype=torch.int64)
    valid_pod = torch.as_tensor(np.asarray(valid_pod), dtype=torch.bool)
    M, e_max, ep_max = idx.shape[1], idx.shape[2], idx_pod.shape[2]
    ft = FleetTrace(*(t.to(host) for t in ft))
    jt_host = Topology(*(t.to(host) for t in jt))

    # per-slot deployments for every configuration, [M, e_max, N] on the
    # device, and on the host which slots are live and their pods' sizes
    # (0 for a cluster): the rack steps a slot needs
    step = _step_columns(ft, idx, dev)
    step_live = valid.permute(1, 2, 0).contiguous()
    step_live_dev = step_live.to(dev)
    sizes = _slots(torch.where(ft.is_pod, ft.n_racks, 0), idx) * step_live
    if split:
        pstep = _step_columns(ft, idx_pod, dev)
        plive = valid_pod.permute(1, 2, 0).contiguous()
        plive_dev = plive.to(dev)
        psizes = _slots(ft.n_racks, idx_pod) * plive
        hd = None if hd_scan is None else pl.hd_subset(jt, hd_scan)

    state = pl.init_state(jt)
    # the registry, on the host: the rows each event's racks landed in
    # (-1 while unplaced) and the racks in each; a cluster fills one row,
    # so a pod-free run keeps one slot per event
    E = ft.month.shape[1]
    S = MAX_POD_RACKS if with_pods else 1
    reg_rows = torch.full((N, E, S), -1, dtype=torch.int64)
    reg_counts = torch.zeros((N, E, S), dtype=torch.float32)
    harvested = torch.zeros((N, E), dtype=torch.bool)
    removed = harvested.clone()
    zero_frac = torch.zeros_like(ft.harvest_frac)

    row_hall = jt.row_hall
    hall_ids = torch.arange(H, device=dev)
    h_cap = torch.as_tensor(np.asarray(h_cap), dtype=torch.int64, device=dev)
    n_active = torch.ones((N,), dtype=torch.int64, device=dev)
    act_month = torch.full((N, H), -1, dtype=torch.int64, device=dev)
    act_month[:, 0] = 0
    hist_halls, hist_deployed, hist_strand, hist_act = [], [], [], []
    hist_p50, hist_p90 = [], []
    event_steps = pod_steps = 0

    def release(st, fraction):
        return pl.release_bulk(jt_host, st, reg_rows, reg_counts,
                               ft.rack_kw, ft.is_gpu, ft.tier, fraction)

    for m in range(M):
        # ---- 1. decommission expired racks ----
        placed = reg_rows[..., 0] >= 0
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
        mkeys = None if keys is None else prng.fold_in(keys, m)
        # each step run: (event ids [N], live [N], and rows [N, 8] with
        # counts [N, 8], or a cluster's row [N] with None)
        done = []
        offset = None
        if split:
            for j in range(ep_max):
                live_h = plive[m, j]
                if not bool(live_h.any()):
                    continue
                racks = min(pod_scan_len, int(psizes[m, j].max()))
                rand = None if keys is None else pl.random_draws(
                    prng.fold_in(mkeys, j), random, racks, R)
                dep = Deployment(*(c[m, j] for c in pstep))

                def place_pod(st, active, live):
                    return pl._place_pod(jt, st, dep, policy, active,
                                         live=live, max_racks=racks,
                                         subset=hd, rand=rand,
                                         interpret=interpret)

                state, ok, rows, counts, n_active, tries = _attempt_retry(
                    place_pod, state, plive_dev[m, j], n_active,
                    torch.minimum(n_active + 1, h_cap), row_hall)
                done.append((idx_pod[:, m, j], live_h, rows, counts))
                event_steps += tries * racks
                pod_steps += tries * racks
            # cluster keys count on from each configuration's pod count
            offset = valid_pod[:, m].sum(dim=1)
        draws = (None if keys is None else
                 pl.random_draws(mkeys, random, e_max, R, offset=offset))
        for i in range(e_max):
            live_h = step_live[m, i]
            if not bool(live_h.any()):
                continue
            dep = Deployment(*(c[m, i] for c in step))
            n_try = torch.minimum(n_active + 1, h_cap)
            rand = None if draws is None else draws[i]
            if legacy_pod_cond and with_pods:
                racks = int(sizes[m, i].max())
                pod_rand = None if keys is None or not racks else \
                    pl.random_draws(prng.fold_in(mkeys, i), random, racks, R)

                def place_any(st, active, live):
                    return pl.place(jt, st, dep, policy, active, live=live,
                                    rand=rand, pod_rand=pod_rand,
                                    max_racks=racks, interpret=interpret)

                state, ok, rows, counts, n_active, tries = _attempt_retry(
                    place_any, state, step_live_dev[m, i], n_active, n_try,
                    row_hall)
                done.append((idx[:, m, i], live_h, rows, counts))
                event_steps += tries * (1 + racks)
                pod_steps += tries * racks
                continue
            bias = torch.where(row_hall >= n_active[:, None], _NEW_HALL_BIAS,
                               0.0)
            state, ok, row = pl.place_in_row(
                jt, state, dep, dep.n_racks, policy,
                row_hall < n_try[:, None], score_bias=bias,
                live=step_live_dev[m, i], rand=rand, interpret=interpret)
            hall = row_hall.gather(1, row.clamp(min=0)[:, None])[:, 0]
            n_new = torch.where(ok & (hall < n_active), n_active, n_try)
            n_active = torch.where(step_live_dev[m, i], n_new, n_active)
            done.append((idx[:, m, i], live_h, row, None))
            event_steps += 1

        if done:   # one copy to the host per month: the registry update
            for eids, live_h, rows, counts in _to_host(done):
                n_i = torch.nonzero(live_h)[:, 0]
                e_i = eids[n_i]
                if counts is None:    # a cluster: all its racks in one row
                    reg_rows[n_i, e_i, 0] = rows[n_i]
                    reg_counts[n_i, e_i, 0] = torch.where(
                        rows[n_i] >= 0, ft.n_racks[n_i, e_i].float(), 0.0)
                else:
                    reg_rows[n_i, e_i] = rows[n_i, :S]
                    reg_counts[n_i, e_i] = counts[n_i, :S]

        # ---- 4. hall activations and the month's stats ----
        act_month = torch.where(
            (act_month < 0) & (hall_ids[None, :] < n_active[:, None]), m,
            act_month)
        hist_halls.append(n_active)
        hist_deployed.append(pl.deployed_kw(state))
        strand = pl.hall_stranding(jt, state)
        if exact_quantiles:
            hist_strand.append(strand)
            hist_act.append(act_month)
        else:
            p50, p90 = qt.hist_masked_quantiles(
                strand, _mature_mask(act_month, m, mature_months),
                (50.0, 90.0), n_bins=n_bins)
            hist_p50.append(p50)
            hist_p90.append(p90)

    if exact_quantiles:
        # ---- exact p50/p90 over the [N, M, H] stranding history ----
        strand = torch.stack(hist_strand, 1)
        acts = torch.stack(hist_act, 1)
        months = torch.arange(M, device=dev)[None, :, None]
        p50, p90 = _masked_percentiles(
            strand, _mature_mask(acts, months, mature_months), (50.0, 90.0))
    else:
        p50, p90 = torch.stack(hist_p50, 1), torch.stack(hist_p90, 1)

    n_real = torch.as_tensor(np.asarray(n_real), dtype=torch.float32)
    placed = reg_rows[..., 0] >= 0
    pf = placed.float().sum(dim=1) / torch.clamp(n_real, min=1.0)
    pad = MAX_POD_RACKS - S
    return SimOutputs(
        halls_active=torch.stack(hist_halls, 1),
        deployed_kw=torch.stack(hist_deployed, 1),
        p50_stranding=p50, p90_stranding=p90,
        final_hall_stranding=pl.hall_stranding(jt, state),
        final_lineup_stranding=pl.lineup_stranding(jt, state),
        n_halls_built=n_active, final_deployed_kw=pl.deployed_kw(state),
        placed_fraction=pf.to(dev), act_month=act_month,
        reg_rows=torch.nn.functional.pad(reg_rows, (0, pad), value=-1),
        reg_counts=torch.nn.functional.pad(reg_counts, (0, pad)),
        event_steps=event_steps, pod_steps=pod_steps)


def _to_host(done):
    """The month's placement results on the host, in one copy of the
    stacked rows (and one of the pods' counts)."""
    rows = [r if r.dim() == 2 else r[:, None] for _, _, r, _ in done]
    width = max(r.shape[1] for r in rows)
    rows = torch.stack([torch.nn.functional.pad(r, (0, width - r.shape[1]),
                                                value=-1) for r in rows]) \
        .cpu()
    counted = [c for _, _, _, c in done if c is not None]
    counts = iter(torch.stack(counted).cpu()) if counted else iter(())
    for (eids, live_h, r, c), r_host in zip(done, rows):
        if c is None:
            yield eids, live_h, r_host[:, 0], None
        else:
            yield eids, live_h, r_host, next(counts)


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
              exact_quantiles: bool = True,
              quantile_bins: int | None = None,
              legacy_pod_cond: bool = False) -> FleetResult:
    """Single-configuration lifecycle at the topology's exact shape (no
    sweep padding): `repro`'s `run_fleet`.

    Args:
        cfg: design/envelope/policy/seed bundle (see `FleetConfig`).
        trace: optional pre-generated arrival trace; defaults to
            `generate_fleet_trace(cfg.env, cfg.seed)`.
        device: where the lifecycle runs (default ``"cuda"``).
        interpret: score rows with the plain version, not the kernel.
        exact_quantiles: `True` (default) takes p50/p90 stranding over
            the whole history; `False` the streaming histogram estimate
            (error ≤ `1 / quantile_bins`; see `simulate_lifecycle`).
        quantile_bins: the histogram's buckets (default
            `quantiles.DEFAULT_BINS`); ignored when exact.
        legacy_pod_cond: place a pod trace's events through the per-event
            cond instead of the split-trace windows (the same results).
    """
    dev = resolve_device(device)
    design, env = cfg.design, cfg.env
    if trace is None:
        trace = generate_fleet_trace(env, cfg.seed)
    months = env.n_months
    H = cfg.n_halls_max or _auto_halls(design, env)
    topo = build_topology(design, H)
    jt = pl.topology([topo], dev)
    ft = FleetTrace.from_traces([trace])
    with_pods = bool(np.asarray(trace.is_pod).any())
    windows = _event_windows(trace, months, with_pods and not legacy_pod_cond)
    out = simulate_lifecycle(
        jt, ft, *(w[None] for w in windows),
        pl.policy_tensor([cfg.policy], dev), [H], [len(trace)],
        harvest=cfg.harvest, seeds=[cfg.seed],
        mature_months=cfg.mature_months, with_pods=with_pods,
        legacy_pod_cond=legacy_pod_cond, pod_scan_len=_pod_scan_len([trace]),
        hd_scan=topo.n_hd_rows, exact_quantiles=exact_quantiles,
        quantile_bins=quantile_bins, interpret=interpret)
    one = type(out)(*(x[0].cpu().numpy() if torch.is_tensor(x) else x
                      for x in out))
    return make_fleet_result(one, months, topo.lineups_per_hall,
                             topo.lineup_is_active, design, env)

"""Hierarchical multi-resource placement, batched over configurations.

The counterpart of `repro.core.placement`.  Where `repro` writes one hall
state and `vmap`s it, the port writes every array with an explicit
leading batch axis N (one configuration each) and runs one placement
step for all N at once; the placement-score kernel scores all N·R rows
(or the N·K rows of a row subset) in one launch.

Feasibility (Eq. 26): a placement is admitted iff the row (power, air,
liquid, tiles), its feeding line-ups (power under redundancy) and the
hall (liquid plant) all retain capacity.  Policies (paper §4.2):
random, round-robin, min-waste and variance-minimisation.  The random
policy scores rows by the Threefry draws of `prng.uniform`, which its
callers compute ahead of their event loops and pass in.  A GPU pod
(`_place_pod`) lands rack by rack in one power domain and commits all
its racks or none; its row search may run on the HD-compacted row view
(`row_subset`), which is bitwise the full search.

Every float32 operation is the reference's, in its order, so chosen rows,
`ok` flags and state leaves agree with `repro` bitwise.  State updates
are functional (a placement returns new tensors) and conflict-free: no
scatter writes two different values to one address, so the card gives
the same bits as the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import prng
from .resources import LIQ, N_RES, POWER, TIER_HA, rack_demand
from ..kernels.placement_score.ops import score_rows

# Policy ids (paper §4.2), the reference's numbering.
POLICY_RANDOM, POLICY_ROUND_ROBIN, POLICY_MIN_WASTE, POLICY_VAR_MIN = 0, 1, 2, 3
POLICY_NAMES = ("random", "round_robin", "min_waste", "var_min")
DEFAULT_POLICY = POLICY_VAR_MIN

MAX_POD_RACKS = 8      # registry width of the reference (pods: 3–7 racks)
_BIG = 1e30
_LD_PREFERENCE = 100.0  # non-GPU racks prefer LD rows (paper §2.2)


class Topology(NamedTuple):
    """Batched counterpart of `repro`'s `JaxTopology`: every leaf carries a
    leading configuration axis N.  Line-ups of hall h are the contiguous
    block ``[h·X/H, (h+1)·X/H)``, as `build_topology` lays them out."""
    row_cap: torch.Tensor           # [N, R, N_RES] f32
    row_feeds: torch.Tensor         # [N, R, MAX_FEEDS] i32, -1 padded
    row_nfeeds: torch.Tensor        # [N, R] i32
    row_is_hd: torch.Tensor         # [N, R] bool
    row_domain: torch.Tensor        # [N, R] i64: global power domain
    row_hall: torch.Tensor          # [N, R] i64 (an index)
    hd_index: torch.Tensor          # [N, R] i64: HD row ids first
                                    # (ascending), then the rest
    lineup_cap: torch.Tensor        # [N, X] f32
    lineup_is_active: torch.Tensor  # [N, X] bool
    lineup_hall: torch.Tensor       # [N, X] i32
    hall_liq_cap: torch.Tensor      # [N, H] f32
    ha_frac: torch.Tensor           # [N] f32
    is_block: torch.Tensor          # [N] bool


class HallState(NamedTuple):
    """Batched counterpart of `repro`'s `HallState`."""
    row_load: torch.Tensor    # [N, R, N_RES] f32
    lineup_ha: torch.Tensor   # [N, X] f32: HA load (balanced shares)
    lineup_tot: torch.Tensor  # [N, X] f32: HA + LA load
    hall_liq: torch.Tensor    # [N, H] f32: liquid plant load (LPM)
    rr_cursor: torch.Tensor   # [N] i32: round-robin cursor


class Deployment(NamedTuple):
    """One arrival per configuration: a same-SKU cluster (one row) or a
    GPU pod (racks may span rows within one power domain)."""
    rack_kw: torch.Tensor   # [N] f32 per-rack power
    n_racks: torch.Tensor   # [N] i32
    is_gpu: torch.Tensor    # [N] bool
    tier: torch.Tensor      # [N] i32 (0 = HA, 1 = LA)
    is_pod: torch.Tensor    # [N] bool


def topology(topos: Sequence, device) -> Topology:
    """Stack host `HallTopology`s of one shape into a device `Topology`.
    `hd_index` is the stable ``argsort(~row_is_hd)``, as `repro` orders
    it: HD rows keep their ascending ids, so an argmin over the compacted
    HD view breaks ties as the full-row argmin does."""
    def stack(fn, dtype):
        return torch.as_tensor(np.stack([np.asarray(fn(t)) for t in topos]),
                               dtype=dtype, device=device)

    return check_hall_blocks(Topology(
        row_cap=stack(lambda t: t.row_cap, torch.float32),
        row_feeds=stack(lambda t: t.row_feeds, torch.int32),
        row_nfeeds=stack(lambda t: t.row_nfeeds, torch.int32),
        row_is_hd=stack(lambda t: t.row_is_hd, torch.bool),
        row_domain=stack(lambda t: t.row_domain, torch.int64),
        row_hall=stack(lambda t: t.row_hall, torch.int64),
        hd_index=stack(lambda t: np.argsort(~np.asarray(t.row_is_hd),
                                            kind="stable"), torch.int64),
        lineup_cap=stack(lambda t: t.lineup_cap, torch.float32),
        lineup_is_active=stack(lambda t: t.lineup_is_active, torch.bool),
        lineup_hall=stack(lambda t: t.lineup_hall, torch.int32),
        hall_liq_cap=stack(lambda t: t.hall_liq_cap, torch.float32),
        ha_frac=stack(lambda t: t.ha_frac, torch.float32),
        is_block=stack(lambda t: t.is_block, torch.bool),
    ))


def check_hall_blocks(jt: Topology) -> Topology:
    """Raise unless the line-ups of hall h are the contiguous block
    ``[h·X/H, (h+1)·X/H)`` in every configuration, as `build_topology`
    lays them out: the port's hall sums read them that way."""
    N, X = jt.lineup_hall.shape
    H = jt.hall_liq_cap.shape[1]
    if X % H == 0:
        blocks = torch.arange(H, dtype=jt.lineup_hall.dtype,
                              device=jt.lineup_hall.device)
        if torch.equal(jt.lineup_hall,
                       blocks.repeat_interleave(X // H).expand(N, X)):
            return jt
    raise ValueError("line-ups must be grouped by hall in contiguous blocks "
                     "of X/H, as build_topology lays them out")


def init_state(jt: Topology) -> HallState:
    """Empty state shaped after `jt`, on its device."""
    N, R, _ = jt.row_cap.shape
    kw = dict(dtype=torch.float32, device=jt.row_cap.device)
    return HallState(
        row_load=torch.zeros((N, R, N_RES), **kw),
        lineup_ha=torch.zeros(jt.lineup_cap.shape, **kw),
        lineup_tot=torch.zeros(jt.lineup_cap.shape, **kw),
        hall_liq=torch.zeros(jt.hall_liq_cap.shape, **kw),
        rr_cursor=torch.zeros((N,), dtype=torch.int32,
                              device=jt.row_cap.device),
    )


def policy_tensor(policies, device) -> torch.Tensor:
    """Per-configuration policy ids as a device tensor, checked on the
    host: an id outside [0, 4) raises `ValueError`."""
    ids = [int(p) for p in policies]
    for i, p in enumerate(ids):
        if not 0 <= p < len(POLICY_NAMES):
            raise ValueError(f"policies[{i}] = {p} outside "
                             f"[0, {len(POLICY_NAMES)}); have {POLICY_NAMES}")
    return torch.tensor(ids, dtype=torch.int64, device=device)


def random_draws(keys: torch.Tensor, random: torch.Tensor, n_steps: int,
                 n_rows: int, offset=None):
    """The random policy's scores for `n_steps` steps: ``[n_steps, N,
    n_rows]``, step i of configuration n being ``uniform(fold_in(
    keys[n], offset[n] + i), n_rows)``, as `repro` draws them per event
    (per pod rack, under the event's key).  `offset` ([N] ints, default
    0) continues the count where an earlier window of the same key left
    off.  Only the configurations marked in `random` ([N] bool, on the
    host) are drawn, in one batched pass; the others' rows stay 0, which
    their policies never read.  None when no configuration is random."""
    if not bool(random.any()):
        return None
    idx = torch.nonzero(random).flatten().to(keys.device)
    steps = torch.arange(n_steps, device=keys.device)[:, None]
    if offset is not None:
        steps = steps + torch.as_tensor(offset, device=keys.device)[idx]
    out = torch.zeros((n_steps, keys.shape[0], n_rows), dtype=torch.float32,
                      device=keys.device)
    out[:, idx] = prng.uniform(prng.fold_in(keys[idx][None], steps), n_rows)
    return out


def _bcast(mask, x):
    """Broadcast a per-configuration [N] mask against `x`'s trailing axes."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


def _tree_where(pred, a: HallState, b: HallState) -> HallState:
    return HallState(*(torch.where(_bcast(pred, x), x, y)
                       for x, y in zip(a, b)))


class _Demand(NamedTuple):
    """What one placement asks of a row, per configuration."""
    n: torch.Tensor   # [N] racks, float32
    P: torch.Tensor   # [N] power n·rack_kw
    d: torch.Tensor   # [N, N_RES] per-rack demand
    D: torch.Tensor   # [N, N_RES] n·d


def _demand(dep: Deployment, n_in_row) -> _Demand:
    n = n_in_row.float()
    d = rack_demand(dep.rack_kw, dep.is_gpu)
    return _Demand(n, n * dep.rack_kw, d, n[:, None] * d)


class RowSubset(NamedTuple):
    """A row subset searched in place of every row, as `repro`'s `rows`
    argument: `rows` ([N, K] full row ids), `jt` the topology with its
    row-axis leaves gathered at `rows` (made once per run: the subset is
    fixed), and `n_rows`, the full row count R."""
    rows: torch.Tensor
    jt: Topology
    n_rows: int


_ROW_LEAVES = ("row_cap", "row_feeds", "row_nfeeds", "row_is_hd",
               "row_domain", "row_hall")


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[n, rows[n]]`` for every configuration n: [N, R, ...] → [N, K,
    ...]."""
    idx = rows.reshape(rows.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(rows.shape + x.shape[2:]))


def row_subset(jt: Topology, rows: torch.Tensor) -> RowSubset:
    """The `RowSubset` of `jt` at `rows` ([N, K] row ids).  Every
    consumer computes per-row quantities elementwise, so the gathered
    view yields bitwise the values the full computation gives at those
    rows."""
    return RowSubset(rows, jt._replace(**{
        f: _take_rows(getattr(jt, f), rows) for f in _ROW_LEAVES}),
        jt.row_cap.shape[1])


def hd_subset(jt: Topology, hd_scan: int) -> RowSubset:
    """The HD-compacted row view ``hd_index[:, :hd_scan]`` that pod scans
    search.  GPU racks fit only HD rows (`_row_fits`), so with `hd_scan`
    ≥ every configuration's HD-row count the view holds every row a pod
    rack can take; a design with fewer HD rows fills it with LD or
    padding rows, which a GPU rack cannot take either."""
    return row_subset(jt, jt.hd_index[:, :hd_scan])


def _row_fits(jt: Topology, state: HallState, dep: Deployment,
              dem: _Demand) -> torch.Tensor:
    """Row/hall constraints outside the line-up power condition: the
    multi-resource row fit, the GPU → HD-row restriction and the hall
    liquid plant.  [N, R] bool."""
    fits_row = (state.row_load + dem.D[:, None, :]
                <= jt.row_cap + 1e-4).all(dim=-1)
    hd_ok = jt.row_is_hd | ~dep.is_gpu[:, None]
    liq = (state.hall_liq + dem.D[:, LIQ:LIQ + 1]).gather(1, jt.row_hall)
    liq_ok = liq <= jt.hall_liq_cap.gather(1, jt.row_hall) + 1e-4
    return fits_row & hd_ok & liq_ok


def _kernel_feas_scores(jt: Topology, state: HallState, dep: Deployment,
                        P, interpret: bool = False):
    """Line-up power feasibility AND row power fit, and the variance score
    (`BIG` at kernel-infeasible rows), from one placement-score launch."""
    return score_rows(jt.row_feeds, jt.row_nfeeds, jt.row_cap, state.row_load,
                      state.lineup_ha, state.lineup_tot, jt.lineup_cap, P,
                      jt.ha_frac, dep.tier == TIER_HA, jt.is_block,
                      interpret=interpret)


def row_scores(jt: Topology, state: HallState, dep: Deployment, n_in_row,
               policy, var, rand=None, subset: RowSubset | None = None
               ) -> torch.Tensor:
    """[N, R] placement score (lower is better) under each configuration's
    policy (`policy_tensor`).  `var` is the kernel's variance column; it is
    `BIG` at kernel-infeasible rows, which the caller's feasibility mask
    sends to `BIG` anyway.  `rand` ([N, R], `prng.uniform` of this step's
    keys) is the random policy's column: pass it whenever a configuration
    runs that policy, whose rows would otherwise score `var`.

    With `subset`, `jt`, `state.row_load`, `var` and `rand` are the
    subset's [N, K] views and the scores are the full-row scores at those
    rows: the round-robin distance keeps full row ids modulo the full R,
    and the caller gathers `rand` from the full-R draws, as `repro`
    does."""
    P = n_in_row.float() * dep.rack_kw
    cap = jt.row_cap[..., POWER]
    # structural preference: non-GPU racks go to LD rows when possible
    base = torch.where(jt.row_is_hd & ~dep.is_gpu[:, None], _LD_PREFERENCE,
                       0.0)
    if subset is None:
        R = jt.row_cap.shape[1]
        row_ids = torch.arange(R, device=cap.device)[None, :]
    else:
        R, row_ids = subset.n_rows, subset.rows
    rr = torch.remainder(row_ids - state.rr_cursor[:, None], R).float() / R
    waste = (cap - state.row_load[..., POWER] - P[:, None]) / \
        torch.clamp(cap, min=1.0)
    pol = policy[:, None]
    score = torch.where(pol == POLICY_ROUND_ROBIN, rr,
                        torch.where(pol == POLICY_MIN_WASTE, waste, var))
    if rand is not None:
        score = torch.where(pol == POLICY_RANDOM, rand, score)
    return base + score


def _apply_to_row(jt: Topology, state: HallState, dep: Deployment,
                  dem: _Demand, row) -> HallState:
    """The state after placing the racks of `dem` into `row` ([N] int64)
    in every configuration.  Each write hits one address per
    configuration once, except a row's feed slots, whose duplicates
    (padding slots point at the first feed) carry the same value, so the
    result does not depend on the order of the writes."""
    ar = torch.arange(row.shape[0], device=row.device)
    row_load = state.row_load.clone()
    row_load[ar, row] = state.row_load[ar, row] + dem.n[:, None] * dem.d

    feeds = jt.row_feeds[ar, row].long()                        # [N, F]
    slot = torch.where(feeds >= 0, feeds, feeds[:, :1].clamp(min=0))
    nf = torch.clamp(jt.row_nfeeds[ar, row], min=1).float()
    share = (dem.P / nf)[:, None].expand_as(slot)
    ha_share = torch.where((dep.tier == TIER_HA)[:, None], share, 0.0)
    lineup_ha = state.lineup_ha.scatter(
        1, slot, state.lineup_ha.gather(1, slot) + ha_share)
    lineup_tot = state.lineup_tot.scatter(
        1, slot, state.lineup_tot.gather(1, slot) + share)

    hall = jt.row_hall[ar, row]
    hall_liq = state.hall_liq.clone()
    hall_liq[ar, hall] = state.hall_liq[ar, hall] + dem.n * dem.d[:, LIQ]
    return HallState(row_load, lineup_ha, lineup_tot, hall_liq,
                     (row + 1).to(torch.int32))


def place_in_row(jt: Topology, state: HallState, dep: Deployment, n_in_row,
                 policy, row_active, score_bias=None, live=None, rand=None,
                 subset: RowSubset | None = None, interpret: bool = False):
    """Place `n_in_row` racks ([N]) into the best feasible active row of
    every configuration.  Returns (state', ok [N], row [N], -1 where not
    ok).

    `score_bias` ([N, R], finite, large relative to policy scores)
    expresses structural preferences among feasible rows, such as the
    fleet's keep-to-existing-halls rule.  `live` ([N] bool, default all)
    marks the configurations that place at all this step: the others keep
    their state and report ok = False, as the reference's masked scan
    steps do.  `rand` ([N, R]) is the random policy's draws (see
    `row_scores`).  One placement-score launch computes the line-up power
    condition and the variance score for all N·R rows.

    `subset` (a `RowSubset`) restricts the search to its rows:
    feasibility, scores, `row_active`, `score_bias` and `rand` are taken
    at the subset and the winning slot maps back to its full row id; the
    launch then covers N·K rows.  When the subset holds every feasible
    row (the HD-compacted pod scan: GPU racks are HD-only) the result is
    bitwise the full search's.

    Ties between equal scores go to the lowest row index, as
    `jnp.argmin` breaks them (`torch.argmin` returns the first minimum);
    a subset ascending within its feasible rows keeps that order."""
    view, st = jt, state
    if subset is not None:
        view = subset.jt
        st = state._replace(row_load=_take_rows(state.row_load, subset.rows))
        row_active = row_active.gather(1, subset.rows)
        if score_bias is not None:
            score_bias = score_bias.gather(1, subset.rows)
        if rand is not None:
            rand = rand.gather(1, subset.rows)
    dem = _demand(dep, n_in_row)
    kfeas, var = _kernel_feas_scores(view, st, dep, dem.P, interpret)
    feas = _row_fits(view, st, dep, dem) & kfeas & row_active
    score = row_scores(view, st, dep, n_in_row, policy, var, rand, subset)
    if score_bias is not None:
        score = score + score_bias
    slot = torch.argmin(torch.where(feas, score, _BIG), dim=1)
    ok = feas.gather(1, slot[:, None])[:, 0]
    if live is not None:
        ok = ok & live
    row = slot if subset is None else \
        subset.rows.gather(1, slot[:, None])[:, 0]
    new_state = _apply_to_row(jt, state, dep, dem, row)
    return _tree_where(ok, new_state, state), ok, torch.where(ok, row, -1)


def place_cluster_in_row(jt: Topology, state: HallState, dep: Deployment,
                         policy, row_active, score_bias=None, live=None,
                         rand=None, interpret: bool = False):
    """`place_in_row` for a whole single-row cluster, with the result in
    the reference's `[N, MAX_POD_RACKS]` rows/counts registry convention.
    Returns (state', ok, rows, counts, row)."""
    st, ok, row = place_in_row(jt, state, dep, dep.n_racks, policy,
                               row_active, score_bias=score_bias, live=live,
                               rand=rand, interpret=interpret)
    N = row.shape[0]
    rows = torch.full((N, MAX_POD_RACKS), -1, dtype=torch.int64,
                      device=row.device)
    rows[:, 0] = row
    counts = torch.zeros((N, MAX_POD_RACKS), dtype=torch.float32,
                         device=row.device)
    counts[:, 0] = torch.where(ok, dep.n_racks.float(), 0.0)
    return st, ok, rows, counts, row


def _place_pod(jt: Topology, state: HallState, dep: Deployment, policy,
               row_active, live=None, max_racks: int = MAX_POD_RACKS,
               subset: RowSubset | None = None, rand=None,
               interpret: bool = False):
    """Place a GPU pod of `dep.n_racks` racks in every live configuration,
    rack by rack, all racks in one power domain (cross-row cables, paper
    §4.1), committed atomically.  Returns (state', ok [N], rows [N,
    MAX_POD_RACKS], counts [N, MAX_POD_RACKS]): the row of each rack and
    1.0 per landed rack where the pod landed whole, else -1 and 0 and the
    entry state.

    Rack i is one `place_in_row` of one rack over the whole batch, live
    where ``i < n_racks`` and `live`: a configuration's steps past its
    own pod size neither commit nor clear its `ok`.  The first rack that
    lands fixes the domain (`row_domain` of its full row id); later racks
    search only that domain.  `max_racks` (on the host) must be ≥ every
    live configuration's `n_racks`; rack steps past it would change
    nothing and are not run.  `subset` is the rack search's row view
    (`hd_subset`), `rand` the racks' draws, ``[≥ max_racks, N, R]``, rack
    i of configuration n keyed by ``fold_in(event key, i)``."""
    N = dep.n_racks.shape[0]
    dev = dep.n_racks.device
    live = torch.ones(N, dtype=torch.bool, device=dev) if live is None \
        else live
    one = torch.ones(N, dtype=torch.int32, device=dev)
    all_ok = torch.ones(N, dtype=torch.bool, device=dev)
    dom = torch.full((N,), -1, dtype=torch.int64, device=dev)
    rows = torch.full((N, MAX_POD_RACKS), -1, dtype=torch.int64, device=dev)
    st = state
    for i in range(min(max_racks, MAX_POD_RACKS)):
        live_i = live & (dep.n_racks > i)
        active = row_active & ((dom < 0)[:, None]
                               | (jt.row_domain == dom[:, None]))
        st, ok, row = place_in_row(
            jt, st, dep, one, policy, active, live=live_i,
            rand=None if rand is None else rand[i], subset=subset,
            interpret=interpret)
        all_ok = all_ok & (ok | ~live_i)
        landed = jt.row_domain.gather(1, row.clamp(min=0)[:, None])[:, 0]
        dom = torch.where(ok & (dom < 0), landed, dom)
        rows[:, i] = row
    ok = all_ok & live
    counts = torch.where((rows >= 0) & ok[:, None], 1.0, 0.0)
    rows = torch.where(ok[:, None], rows, -1)
    return _tree_where(ok, st, state), ok, rows, counts


def place(jt: Topology, state: HallState, dep: Deployment, policy,
          row_active, live=None, rand=None, pod_rand=None,
          max_racks: int = MAX_POD_RACKS, interpret: bool = False):
    """Place one arrival per configuration, cluster or pod: `repro`'s
    ``lax.cond(is_pod, …)``, which `vmap` evaluates on both sides and
    selects by each configuration's `is_pod`.  Here the cluster branch
    places the live non-pod configurations and the pod branch (a full-row
    `_place_pod`, `max_racks` rack steps on the host; 0 when no live
    configuration holds a pod) the live pods; the two sets are disjoint,
    so one runs after the other on one state.  `rand` is the event's
    draws ([N, R]), `pod_rand` its racks' (see `_place_pod`).

    Returns (state', ok, rows [N, MAX_POD_RACKS], counts [N,
    MAX_POD_RACKS]), the registry that harvesting and decommissioning
    read."""
    N = dep.n_racks.shape[0]
    if live is None:
        live = torch.ones(N, dtype=torch.bool, device=dep.n_racks.device)
    st, ok, rows, counts, _ = place_cluster_in_row(
        jt, state, dep, policy, row_active, live=live & ~dep.is_pod,
        rand=rand, interpret=interpret)
    if max_racks > 0:
        st, ok_p, rows_p, counts_p = _place_pod(
            jt, st, dep, policy, row_active, live=live & dep.is_pod,
            max_racks=max_racks, rand=pod_rand, interpret=interpret)
        pod = dep.is_pod[:, None]
        ok = torch.where(dep.is_pod, ok_p, ok)
        rows = torch.where(pod, rows_p, rows)
        counts = torch.where(pod, counts_p, counts)
    return st, ok, rows, counts


def release_bulk(jt: Topology, state: HallState, rows, counts, rack_kw,
                 is_gpu, tier, fraction) -> HallState:
    """Release `fraction` of the demand recorded by a batch of placement
    registries (harvest: fraction < 1; decommission: fraction = 1).

    rows/counts: [N, ..., S] registries as `place_cluster_in_row` returns
    them (row -1 where nothing landed); rack_kw/is_gpu/tier/fraction:
    per-event [N, ...].

    The segment sums are taken on the host, whatever device the state is
    on: `index_add_` there adds in index order, the order of the
    reference's `segment_sum`, where the card's adds with atomics in no
    fixed order.  Tensors already on the CPU are not copied, so a caller
    that keeps its registry and a host copy of `jt` there (as the
    lifecycle does) sends only the sums to the card, where each state
    leaf takes one subtraction."""
    host = torch.device("cpu")
    rows, counts, rack_kw, is_gpu, tier, fraction = (
        t.to(host) for t in (rows, counts, rack_kw, is_gpu, tier, fraction))
    row_feeds, row_nfeeds, row_hall = (
        t.to(host) for t in (jt.row_feeds, jt.row_nfeeds, jt.row_hall))
    N, R = row_nfeeds.shape
    X = jt.lineup_cap.shape[1]
    H = jt.hall_liq_cap.shape[1]

    flat = rows.reshape(N, -1)
    n = (counts * fraction[..., None]).reshape(N, -1)
    d = rack_demand(rack_kw, is_gpu)                            # [N, ..., 4]
    d = d[..., None, :].expand(counts.shape + (N_RES,)).reshape(N, -1, N_RES)
    ha = (tier == TIER_HA)[..., None].expand(counts.shape).reshape(N, -1)
    valid = flat >= 0
    seg = torch.where(valid, flat, 0).long() + \
        torch.arange(N)[:, None] * R                             # [N, F]
    rel = torch.where(valid[..., None], n[..., None] * d,
                      torch.zeros_like(d))                       # [N, F, 4]

    def segment_sum(values, index, size):
        return torch.zeros((size,) + values.shape[1:],
                           dtype=values.dtype).index_add_(0, index, values)

    seg = seg.reshape(-1)
    row_rel = segment_sum(rel.reshape(-1, N_RES), seg, N * R).view(N, R, N_RES)
    row_rel_ha = segment_sum((rel[..., POWER] * ha).reshape(-1), seg,
                             N * R).view(N, R)

    # distribute row power release back over feeds (balanced shares)
    nf = torch.clamp(row_nfeeds, min=1).float()
    feeds_valid = row_feeds >= 0
    lineup = (torch.where(feeds_valid, row_feeds, 0).long()
              + torch.arange(N)[:, None, None] * X).reshape(-1)
    zero = torch.zeros(row_feeds.shape, dtype=torch.float32)
    per_feed_tot = torch.where(feeds_valid, (row_rel[..., POWER] / nf)[..., None],
                               zero)
    per_feed_ha = torch.where(feeds_valid, (row_rel_ha / nf)[..., None], zero)
    lineup_tot_rel = segment_sum(per_feed_tot.reshape(-1), lineup, N * X)
    lineup_ha_rel = segment_sum(per_feed_ha.reshape(-1), lineup, N * X)
    hall = (row_hall + torch.arange(N)[:, None] * H).reshape(-1)
    hall_rel = segment_sum(row_rel[..., LIQ].reshape(-1), hall, N * H)

    dev = state.row_load.device
    return HallState(
        state.row_load - row_rel.to(dev),
        state.lineup_ha - lineup_ha_rel.view(N, X).to(dev),
        state.lineup_tot - lineup_tot_rel.view(N, X).to(dev),
        state.hall_liq - hall_rel.view(N, H).to(dev),
        state.rr_cursor)


def remove_from_row(jt: Topology, state: HallState, rack_kw, is_gpu, tier,
                    row, n_racks=1, fraction=1.0) -> HallState:
    """Release `fraction` of `n_racks` racks' demand from `row` ([N]
    valid row ids) in every configuration (harvest / decommission, paper
    §4.1): `repro`'s `remove_from_row`, batched.  `rack_kw`, `is_gpu`
    and `tier` are [N]; `n_racks` and `fraction` are scalars or [N].
    Like `_apply_to_row`, each write hits one address per configuration,
    or a row's feed slots with equal values."""
    N = row.shape[0]
    dev = row.device
    n = (torch.as_tensor(n_racks, dtype=torch.float32, device=dev)
         * torch.as_tensor(fraction, dtype=torch.float32, device=dev)
         ).expand(N)
    d = rack_demand(rack_kw, is_gpu)                            # [N, 4]
    P = n * rack_kw
    ar = torch.arange(N, device=dev)
    row_load = state.row_load.clone()
    row_load[ar, row] = state.row_load[ar, row] + (-n)[:, None] * d

    feeds = jt.row_feeds[ar, row].long()                        # [N, F]
    slot = torch.where(feeds >= 0, feeds, feeds[:, :1].clamp(min=0))
    nf = torch.clamp(jt.row_nfeeds[ar, row], min=1).float()
    share = (P / nf)[:, None].expand_as(slot)
    is_ha = torch.as_tensor(tier, device=dev) == TIER_HA
    ha_share = torch.where(is_ha[:, None], share, 0.0)
    lineup_ha = state.lineup_ha.scatter(
        1, slot, state.lineup_ha.gather(1, slot) + (-ha_share))
    lineup_tot = state.lineup_tot.scatter(
        1, slot, state.lineup_tot.gather(1, slot) + (-share))

    hall = jt.row_hall[ar, row]
    hall_liq = state.hall_liq.clone()
    hall_liq[ar, hall] = state.hall_liq[ar, hall] + (-n) * d[:, LIQ]
    return HallState(row_load, lineup_ha, lineup_tot, hall_liq,
                     state.rr_cursor)


# ---------------------------------------------------------------------------
# Stranding metrics (paper §4.3).
# ---------------------------------------------------------------------------

def lineup_stranding(jt: Topology, state: HallState) -> torch.Tensor:
    """[N, X] unused fraction of effective HA capacity per line-up."""
    eff = jt.ha_frac[:, None] * jt.lineup_cap
    frac = (eff - state.lineup_ha) / torch.clamp(eff, min=1.0)
    return torch.where(jt.lineup_is_active, torch.clamp(frac, 0.0, 1.0),
                       torch.zeros_like(frac))


def _hall_sums(x: torch.Tensor, n_halls: int) -> torch.Tensor:
    """[N, X] → [N, H] sums over each hall's contiguous line-up block,
    added in line-up order: the reference's `segment_sum` order, the same
    on every device."""
    blocks = x.reshape(x.shape[0], n_halls, -1)
    acc = blocks[..., 0]
    for j in range(1, blocks.shape[-1]):
        acc = acc + blocks[..., j]
    return acc


def hall_stranding(jt: Topology, state: HallState) -> torch.Tensor:
    """[N, H] unused fraction of effective HA capacity per hall."""
    H = jt.hall_liq_cap.shape[1]
    active = jt.lineup_is_active.float()
    eff_h = _hall_sums(jt.ha_frac[:, None] * jt.lineup_cap * active, H)
    load_h = _hall_sums(state.lineup_ha * active, H)
    return torch.clamp((eff_h - load_h) / torch.clamp(eff_h, min=1.0),
                       0.0, 1.0)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order (zero-padded to a
    power of two, then halved), so the card and the CPU give the same
    bits.  XLA's float32 reduction order is its own, so sums over rows
    agree with `repro` to float32 rounding, not bitwise."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def deployed_kw(state: HallState) -> torch.Tensor:
    """[N] deployed power (sum of row power loads)."""
    return tree_sum(state.row_load[..., POWER])

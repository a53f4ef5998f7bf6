"""Single-hall Monte Carlo simulator (paper §4.4).

Each trial instantiates one hall, places arrivals until SATURATION_FAILS
consecutive placements fail, applies harvesting, then resumes placement
until another SATURATION_FAILS consecutive failures.

The counterpart of `repro.core.singlehall`.  `repro` vmaps trials and
scans each phase's events; the port flattens a batch of trials (the
configuration × trial grid of `mc_sweep`) into one leading axis N of one
batched `HallState`, so every placement step (an event, or one rack of a
pod) is one placement-score launch over all N·R rows (N·K on the
HD-compacted pod view).  A saturated trial is frozen (`live=False`) and
places nothing more.

Random-policy trials score rows by the Threefry draws `repro` takes:
``ka, kb = split(key)``, event i of a phase keys by ``fold_in(ka, i)``
(``kb`` for the refill) and rack r of a pod by ``fold_in(event key,
r)``.  A phase's event draws are made in one batched pass before its
event loop, a pod's rack draws before its racks.

Traces with pods run in either of `repro`'s modes: the split-trace pod
window then cluster window, or the legacy per-event cond.  The batched
front end is `repro_torch.core.mc_sweep`; `monte_carlo` here is its
one-configuration wrapper.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import placement as pl, prng
from .arrivals import TraceBatch
from .hierarchy import DesignSpec
from .placement import DEFAULT_POLICY, Deployment, HallState, Topology

SATURATION_FAILS = 100


class TraceArrays(NamedTuple):
    """Trace columns of a trial batch on the device, event-major: [E, N]."""
    rack_kw: torch.Tensor        # f32
    n_racks: torch.Tensor        # i32
    is_gpu: torch.Tensor         # bool
    tier: torch.Tensor           # i32
    harvest_frac: torch.Tensor   # f32
    is_pod: torch.Tensor         # bool

    @staticmethod
    def from_batches(batches: Sequence[TraceBatch], device) -> "TraceArrays":
        """Stack the [T, E] columns of B trace batches into [E, B·T],
        configuration-major (trial t of batch b is column b·T + t)."""
        def col(name, dtype):
            a = np.concatenate([np.asarray(getattr(b, name)) for b in batches])
            return torch.as_tensor(np.ascontiguousarray(a.T), dtype=dtype,
                                   device=device)

        return TraceArrays(col("rack_kw", torch.float32),
                           col("n_racks", torch.int32),
                           col("is_gpu", torch.bool), col("tier", torch.int32),
                           col("harvest_frac", torch.float32),
                           col("is_pod", torch.bool))

    def event(self, i: int) -> Deployment:
        return Deployment(self.rack_kw[i], self.n_racks[i], self.is_gpu[i],
                          self.tier[i], self.is_pod[i])


class TrialResult(NamedTuple):
    state: HallState
    placed: torch.Tensor      # [N, E] bool
    rows: torch.Tensor        # [N, E, MAX_POD_RACKS] i64, -1 where unplaced
    counts: torch.Tensor      # [N, E, MAX_POD_RACKS] f32
    saturated: torch.Tensor   # [N] bool: the phase ended in saturation
    steps: int = 0            # placement steps run (kernel launches)
    pod_steps: int = 0        # of which pod racks


def _fill_phase(jt: Topology, state: HallState, trace: TraceArrays, policy,
                key, random, with_pods: bool = False,
                split_pods: bool = False, pod_window: int = 0,
                cluster_start: int = 0,
                pod_scan_len: int = pl.MAX_POD_RACKS,
                hd: pl.RowSubset | None = None,
                interpret: bool = False) -> TrialResult:
    """Place the trace until saturation, in every trial of the batch.
    `key` ([N, 2]) keys the phase's draws for the trials marked in
    `random` ([N] bool, on the host).  Where an event is not placed its
    rows are -1 and its counts 0.  `repro`'s three modes, which place
    alike on the same trace:

    * ``with_pods=False``: every event through `place_cluster_in_row`;
    * ``with_pods=True, split_pods=False``: every event through
      `placement.place` (pod or cluster by the event), pods over all rows;
    * ``split_pods=True``: a pods-first trace (`sample_mixed_traces`
      emits it so) runs a pod window over events ``[0, pod_window)``,
      live while ``i < n_pods``, each a `_place_pod` of at most
      `pod_scan_len` racks over the row view `hd`, then a cluster window
      over ``[cluster_start, E)``, live while ``i >= n_pods``.
      `pod_window` ≥ every trial's pod count and `cluster_start` ≤ it;
      the saturation streak moves only on a trial's live steps.

    Steps where no trial of the batch is live, and pod racks past the
    largest live pod, change nothing and are not run."""
    E = trace.rack_kw.shape[0]
    N, R = jt.row_cap.shape[:2]
    dev = jt.row_cap.device
    all_rows = torch.ones((N, R), dtype=torch.bool, device=dev)
    draws = pl.random_draws(key, random, E, R)
    streak = torch.zeros((N,), dtype=torch.int32, device=dev)
    steps = pod_steps = 0
    if with_pods:    # one copy per phase: which events are pods, and sizes
        pods_h = trace.is_pod.cpu()
        sizes_h = torch.where(pods_h, trace.n_racks.cpu(), 0)

    def rack_draws(i, racks):
        return None if draws is None else pl.random_draws(
            prng.fold_in(key, i), random, racks, R)

    if not (with_pods and split_pods):
        placed, rows, counts = [], [], []
        for i in range(E):
            live = streak < SATURATION_FAILS
            dep = trace.event(i)
            rand = None if draws is None else draws[i]
            if with_pods:
                racks = int(sizes_h[i].max())
                state, ok, rows_i, counts_i = pl.place(
                    jt, state, dep, policy, all_rows, live=live, rand=rand,
                    pod_rand=rack_draws(i, racks) if racks else None,
                    max_racks=racks, interpret=interpret)
                steps += 1 + racks
                pod_steps += racks
            else:
                state, ok, rows_i, counts_i, _ = pl.place_cluster_in_row(
                    jt, state, dep, policy, all_rows, live=live, rand=rand,
                    interpret=interpret)
                steps += 1
            streak = torch.where(ok, 0, streak + 1)
            placed.append(ok)
            rows.append(rows_i)
            counts.append(counts_i)
        return TrialResult(state, torch.stack(placed, 1),
                           torch.stack(rows, 1), torch.stack(counts, 1),
                           streak >= SATURATION_FAILS, steps, pod_steps)

    n_pods_h = pods_h.sum(dim=0)                                  # [N]
    n_pods = n_pods_h.to(dev)
    ran = {}        # event id → (ok, rows, counts) of each window step run
    for i in range(pod_window):
        if not bool((n_pods_h > i).any()):
            continue
        racks = min(pod_scan_len, int(sizes_h[i].max()))
        live_of = n_pods > i
        state, ok, rows_i, counts_i = pl._place_pod(
            jt, state, trace.event(i), policy, all_rows,
            live=live_of & (streak < SATURATION_FAILS), max_racks=racks,
            subset=hd, rand=rack_draws(i, racks), interpret=interpret)
        streak = torch.where(live_of, torch.where(ok, 0, streak + 1), streak)
        ran[i] = (ok, rows_i, counts_i)
        steps += racks
        pod_steps += racks

    for i in range(cluster_start, E):
        if not bool((n_pods_h <= i).any()):
            continue
        live_of = n_pods <= i
        state, ok, rows_i, counts_i, _ = pl.place_cluster_in_row(
            jt, state, trace.event(i), policy, all_rows,
            live=live_of & (streak < SATURATION_FAILS),
            rand=None if draws is None else draws[i], interpret=interpret)
        streak = torch.where(live_of, torch.where(ok, 0, streak + 1), streak)
        if i in ran:   # the windows are live-disjoint: keep what placed
            p_ok, p_rows, p_counts = ran[i]
            rows_i = torch.where(ok[:, None], rows_i, p_rows)
            counts_i = torch.where(ok[:, None], counts_i, p_counts)
            ok = ok | p_ok
        ran[i] = (ok, rows_i, counts_i)
        steps += 1

    S = pl.MAX_POD_RACKS
    placed = torch.zeros((N, E), dtype=torch.bool, device=dev)
    rows = torch.full((N, E, S), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros((N, E, S), dtype=torch.float32, device=dev)
    if ran:
        ids = torch.tensor(sorted(ran), device=dev)
        placed[:, ids] = torch.stack([ran[i][0] for i in sorted(ran)], 1)
        rows[:, ids] = torch.stack([ran[i][1] for i in sorted(ran)], 1)
        counts[:, ids] = torch.stack([ran[i][2] for i in sorted(ran)], 1)
    return TrialResult(state, placed, rows, counts,
                       streak >= SATURATION_FAILS, steps, pod_steps)


def _apply_harvest(jt: Topology, res: TrialResult,
                   trace: TraceArrays) -> HallState:
    """Harvest every placed rack by its class ceiling (paper §5.2)."""
    frac = torch.where(res.placed, trace.harvest_frac.T, 0.0)
    return pl.release_bulk(jt, res.state, res.rows, res.counts,
                           trace.rack_kw.T, trace.is_gpu.T, trace.tier.T,
                           frac)


def run_trial(jt: Topology, topo_init: HallState, trace_a: TraceArrays,
              trace_b: TraceArrays, policy, key, harvest: bool = True,
              with_pods: bool = False, split_pods: bool = False,
              pod_windows: tuple = (0, 0), cluster_starts: tuple = (0, 0),
              pod_scan_len: int = pl.MAX_POD_RACKS,
              hd_scan: int | None = None, interpret: bool = False):
    """N MC trials at once: fill → harvest → refill.  `policy` ([N]) comes
    from `placement.policy_tensor`, `key` ([N, 2]) is each trial's key.
    `with_pods`, `split_pods`, the (fill, refill) `pod_windows` and
    `cluster_starts`, `pod_scan_len` and `hd_scan` (the HD-compacted
    pod view's length) select the placement mode (see `_fill_phase`).
    Returns the final state and the two phase results.  `interpret=True`
    scores rows with the plain version instead of the CUDA kernel."""
    random = (policy == pl.POLICY_RANDOM).cpu()
    ka, kb = prng.split(key).unbind(1)
    hd = None if hd_scan is None else pl.hd_subset(jt, hd_scan)
    mode = dict(with_pods=with_pods, split_pods=split_pods,
                pod_scan_len=pod_scan_len, hd=hd, interpret=interpret)
    res_a = _fill_phase(jt, topo_init, trace_a, policy, ka, random,
                        pod_window=pod_windows[0],
                        cluster_start=cluster_starts[0], **mode)
    state = _apply_harvest(jt, res_a, trace_a) if harvest else res_a.state
    res_b = _fill_phase(jt, state, trace_b, policy, kb, random,
                        pod_window=pod_windows[1],
                        cluster_start=cluster_starts[1], **mode)
    return res_b.state, res_a, res_b


def monte_carlo(design: DesignSpec, n_trials: int = 32, n_events: int = 600,
                policy: int = DEFAULT_POLICY, seed: int = 0,
                year: int = 2028, scenario: str = "med",
                gpu_power_share: float = 0.6, pod_racks: int = 1,
                quantum_racks: int = 10, harvest: bool = True,
                sku_kw_override: float | None = None,
                single_sku_gpu: bool = False,
                legacy_pod_cond: bool = False, device="cuda",
                interpret: bool = False):
    """Run `n_trials` single-hall MC trials.  Returns the dict of metrics
    of `MCResult.result`: the one-configuration `mc_sweep` call."""
    from .mc_sweep import MCAxes, mc_sweep   # deferred: avoids import cycle
    axes = MCAxes.zip(designs=[design], sku_kw=[sku_kw_override],
                      policies=[policy], seeds=[seed])
    res = mc_sweep(axes, n_trials=n_trials, n_events=n_events, year=year,
                   scenario=scenario, gpu_power_share=gpu_power_share,
                   pod_racks=pod_racks, quantum_racks=quantum_racks,
                   harvest=harvest, single_sku_gpu=single_sku_gpu,
                   legacy_pod_cond=legacy_pod_cond, device=device,
                   interpret=interpret)
    return res.result(0)

"""Single-hall Monte Carlo simulator (paper §4.4), pod-free.

Each trial instantiates one hall, places arrivals until SATURATION_FAILS
consecutive placements fail, applies harvesting, then resumes placement
until another SATURATION_FAILS consecutive failures.

The counterpart of `repro.core.singlehall`.  `repro` vmaps trials and
scans each phase's events; the port flattens a batch of trials (the
configuration × trial grid of `mc_sweep`) into one leading axis N of one
batched `HallState`, so every event step is one `place_cluster_in_row`:
one placement-score launch over all N·R rows.  Every event step runs, as
`repro`'s scan does; a saturated trial is frozen (`live=False`) and
places nothing more.

Random-policy trials score rows by the Threefry draws `repro` takes:
``ka, kb = split(key)``, and event i of a phase keys by ``fold_in(ka,
i)`` (``kb`` for the refill).  A phase's draws are made in one batched
pass before its event loop.

Not ported: traces with multi-row pods, in either of `repro`'s modes
(the split-trace pod window and the legacy per-event cond; ROADMAP
queue 1, items 4 and 6).  The batched front end is
`repro_torch.core.mc_sweep`; `monte_carlo` here is its one-configuration
wrapper.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import placement as pl, prng
from .arrivals import TraceBatch
from .fleet import _PODS_TODO
from .hierarchy import DesignSpec
from .placement import DEFAULT_POLICY, Deployment, HallState, Topology

SATURATION_FAILS = 100


class TraceArrays(NamedTuple):
    """Trace columns of a pod-free trial batch on the device, event-major:
    [E, N]."""
    rack_kw: torch.Tensor        # f32
    n_racks: torch.Tensor        # i32
    is_gpu: torch.Tensor         # bool
    tier: torch.Tensor           # i32
    harvest_frac: torch.Tensor   # f32

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
                           col("harvest_frac", torch.float32))

    def event(self, i: int) -> Deployment:
        return Deployment(self.rack_kw[i], self.n_racks[i], self.is_gpu[i],
                          self.tier[i])


class TrialResult(NamedTuple):
    state: HallState
    placed: torch.Tensor      # [N, E] bool
    rows: torch.Tensor        # [N, E, MAX_POD_RACKS] i64, -1 where unplaced
    counts: torch.Tensor      # [N, E, MAX_POD_RACKS] f32
    saturated: torch.Tensor   # [N] bool: the phase ended in saturation


def _fill_phase(jt: Topology, state: HallState, trace: TraceArrays, policy,
                key, random, with_pods: bool = False,
                interpret: bool = False) -> TrialResult:
    """Place the trace until saturation, in every trial of the batch:
    `repro`'s ``with_pods=False`` branch.  `key` ([N, 2]) keys the phase's
    draws for the trials marked in `random` ([N] bool, on the host).
    Where an event is not placed its rows are -1 and its counts 0."""
    if with_pods:
        raise NotImplementedError(_PODS_TODO)
    E = trace.rack_kw.shape[0]
    N, R = jt.row_cap.shape[:2]
    dev = jt.row_cap.device
    all_rows = torch.ones((N, R), dtype=torch.bool, device=dev)
    draws = pl.random_draws(key, random, E, R)
    streak = torch.zeros((N,), dtype=torch.int32, device=dev)
    placed, rows, counts = [], [], []
    for i in range(E):
        state, ok, rows_i, counts_i, _ = pl.place_cluster_in_row(
            jt, state, trace.event(i), policy, all_rows,
            live=streak < SATURATION_FAILS,
            rand=None if draws is None else draws[i], interpret=interpret)
        streak = torch.where(ok, 0, streak + 1)
        placed.append(ok)
        rows.append(rows_i)
        counts.append(counts_i)
    return TrialResult(state, torch.stack(placed, 1), torch.stack(rows, 1),
                       torch.stack(counts, 1), streak >= SATURATION_FAILS)


def _apply_harvest(jt: Topology, res: TrialResult,
                   trace: TraceArrays) -> HallState:
    """Harvest every placed rack by its class ceiling (paper §5.2)."""
    frac = torch.where(res.placed, trace.harvest_frac.T, 0.0)
    return pl.release_bulk(jt, res.state, res.rows, res.counts,
                           trace.rack_kw.T, trace.is_gpu.T, trace.tier.T,
                           frac)


def run_trial(jt: Topology, topo_init: HallState, trace_a: TraceArrays,
              trace_b: TraceArrays, policy, key, harvest: bool = True,
              with_pods: bool = False, interpret: bool = False):
    """N MC trials at once: fill → harvest → refill.  `policy` ([N]) comes
    from `placement.policy_tensor`, `key` ([N, 2]) is each trial's key.
    Returns the final state and the two phase results.  `interpret=True`
    scores rows with the plain version instead of the CUDA kernel."""
    random = (policy == pl.POLICY_RANDOM).cpu()
    ka, kb = prng.split(key).unbind(1)
    res_a = _fill_phase(jt, topo_init, trace_a, policy, ka, random,
                        with_pods, interpret)
    state = _apply_harvest(jt, res_a, trace_a) if harvest else res_a.state
    res_b = _fill_phase(jt, state, trace_b, policy, kb, random, with_pods,
                        interpret)
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

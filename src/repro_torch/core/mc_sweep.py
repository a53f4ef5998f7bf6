"""Batched single-hall Monte Carlo engine (paper §4.4, Figs. 5–7).

The counterpart of `repro.core.mc_sweep`.  The paper's single-hall
results are grids: stranding CDFs per design (Fig. 5), a 21-point
single-SKU kW sweep per design (Fig. 6), a policy comparison (Fig. 7).
Trial traces come from one vectorized numpy pass per configuration and
phase (`arrivals.sample_mixed_traces`, byte-identical to `repro`'s), and
`singlehall.run_trial` runs the whole (configuration × trial) grid as one
batch of N = B·T trials on one device, topologies padded to common
shapes as `sweep.SweepAxes` pads them:

    axes = MCAxes.product(designs=[get_design("4N/3"), get_design("3+1")],
                          sku_kw=np.arange(200, 2501, 115))
    res = mc_sweep(axes, n_trials=4, n_events=300,
                   harvest=False, single_sku_gpu=True)   # on the card
    res.deployed_kw[i].mean(), res.result(i) ...

Each placement step launches the placement-score kernel once, over all
N·R rows.  Pod traces (``pod_racks > 1``) run the split-pods path (a pod
window over the HD-compacted rows, then a cluster window) or, with
``legacy_pod_cond=True``, the per-event cond; both place alike.
`resilience.resilient_mc_sweep` runs the same batch in checkpointed,
fault-isolated chunks of configurations, and `sharded_mc_sweep` splits
it over a device list (flat slabs of trials, or configuration × trial
blocks), every output bitwise `mc_sweep`'s.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import arrivals, cost, placement as pl, prng, projections as proj
from . import throughput as tp
from .hierarchy import (DesignSpec, HallTopology, SweepValidationError,
                        build_topology)
from .placement import DEFAULT_POLICY, POLICY_NAMES, Topology
from .singlehall import TraceArrays, run_trial
from .sweep import _broadcast
from ..device import device_name, resolve_device
from ..sharding import axes as shax, dispatch


@dataclass
class MCAxes:
    """The single-hall configuration batch `mc_sweep` runs.

    Four aligned per-configuration lists of equal length ``B``:
    configuration ``i`` is ``(designs[i], sku_kw[i], policies[i],
    seeds[i])``, where `sku_kw` is the optional Fig. 6 GPU SKU-kW
    override (None = empirical SKU mix).  Length-1 lists broadcast, and
    `tags` rides along for reporting, as `sweep.SweepAxes.tags` does.

    Trial count, event count, year/scenario and the other trace-stream
    parameters are call-level arguments of `mc_sweep`, shared by the
    whole grid.
    """
    designs: List[DesignSpec]
    sku_kw: List[Optional[float]] = field(default_factory=lambda: [None])
    policies: List[int] = field(default_factory=lambda: [DEFAULT_POLICY])
    seeds: List[int] = field(default_factory=lambda: [0])
    tags: List[str] = field(default_factory=lambda: [""])

    def __len__(self):
        return len(self.designs)

    def __post_init__(self):
        B = max(len(self.designs), len(self.sku_kw), len(self.policies),
                len(self.seeds), len(self.tags))
        self.designs = _broadcast(self.designs, B, "designs")
        self.sku_kw = [None if k is None else float(k)
                       for k in _broadcast(self.sku_kw, B, "sku_kw")]
        self.policies = [int(p) for p in _broadcast(self.policies, B,
                                                    "policies")]
        self.seeds = [int(s) for s in _broadcast(self.seeds, B, "seeds")]
        self.tags = [str(t) for t in _broadcast(self.tags, B, "tags")]

    @staticmethod
    def zip(designs, sku_kw=(None,), policies=(DEFAULT_POLICY,), seeds=(0,),
            tags=("",)) -> "MCAxes":
        """Aligned per-configuration sequences (length-1 broadcasts)."""
        return MCAxes(list(designs), list(sku_kw), list(policies),
                      list(seeds), list(tags))

    @staticmethod
    def product(designs: Sequence[DesignSpec],
                sku_kw: Sequence[Optional[float]] = (None,),
                policies: Sequence[int] = (DEFAULT_POLICY,),
                seeds: Sequence[int] = (0,),
                tags: Sequence[str] | None = None) -> "MCAxes":
        """Full grid, designs-major ordering (seeds vary fastest).
        `tags` (aligned with `designs`, length-1 broadcasts) labels each
        design and follows it through the cross product."""
        tags = _broadcast(tags, len(designs), "tags") \
            if tags is not None else [""] * len(designs)
        combos = list(itertools.product(zip(designs, tags), sku_kw,
                                        policies, seeds))
        return MCAxes([c[0][0] for c in combos], [c[1] for c in combos],
                      [c[2] for c in combos], [c[3] for c in combos],
                      [c[0][1] for c in combos])

    def validate(self) -> "MCAxes":
        """Raise `SweepValidationError` before any device work."""
        if len(self) == 0:
            raise SweepValidationError(
                "designs", "empty MC sweep: zero configurations")
        seen: set = set()
        for d in self.designs:
            if id(d) not in seen:
                seen.add(id(d))
                d.validate()
        for i, kw in enumerate(self.sku_kw):
            if kw is not None and kw <= 0:
                raise SweepValidationError(
                    "sku_kw", f"sku_kw[{i}] = {kw}: non-positive rack "
                    f"power override")
        for i, p in enumerate(self.policies):
            if not 0 <= p < len(POLICY_NAMES):
                raise SweepValidationError(
                    "policies", f"policies[{i}] = {p} outside "
                    f"[0, {len(POLICY_NAMES)}); have {POLICY_NAMES}")
        return self


@dataclass
class MCResult:
    """Per-configuration MC metrics, leading axes = (config, trial)."""
    axes: MCAxes
    lineup_stranding: np.ndarray   # [B, T, X_pad] (use result(i) to strip)
    hall_stranding: np.ndarray     # [B, T]
    deployed_kw: np.ndarray        # [B, T] float32
    saturated: np.ndarray          # [B, T] refill phase ended saturated
    placed_a: np.ndarray           # [B, T, E]
    placed_b: np.ndarray           # [B, T, E_b]
    ha_capacity_kw: np.ndarray     # [B]
    # --- metric stage (per-trial $/performance; see `sweep.SweepResult`) ---
    provisioned_mw: np.ndarray = None   # [B] hall nameplate
    model_names: List[str] = field(default_factory=list)   # [Mdl]
    delivered_tps: np.ndarray = None         # [B, T, Mdl]
    tps_per_provisioned_w: np.ndarray = None  # [B, T, Mdl]
    dollars_per_tps: np.ndarray = None       # [B, T, Mdl]
    # --- the port's own: run facts ---
    rows_a: np.ndarray = None      # [B, T, E, 8] rows each event's racks
                                   # landed in (-1 padded)
    counts_a: np.ndarray = None    # [B, T, E, 8] racks in each row
    rows_b: np.ndarray = None      # [B, T, E_b, 8], the refill's
    counts_b: np.ndarray = None    # [B, T, E_b, 8]
    event_steps: int = 0           # placement steps run (kernel launches)
    pod_steps: int = 0             # of which pod racks
    device: str = ""               # where the trials ran

    def __len__(self):
        return len(self.axes)

    @property
    def n_trials(self) -> int:
        return self.deployed_kw.shape[1]

    @property
    def tags(self) -> List[str]:
        return self.axes.tags

    def result(self, i: int) -> dict:
        """Configuration `i` as the `singlehall.monte_carlo` metrics dict
        (line-up padding stripped to the design's own line-up count)."""
        X = self.axes.designs[i].n_lineups
        return {
            "lineup_stranding": self.lineup_stranding[i, :, :X],  # [T, X]
            "hall_stranding": self.hall_stranding[i],             # [T]
            "deployed_kw": self.deployed_kw[i],                   # [T]
            "ha_capacity_kw": float(self.ha_capacity_kw[i]),
            "saturated": self.saturated[i],
            "placed_a": self.placed_a[i],
            "placed_b": self.placed_b[i],
        }


# Request-keyed staging cache: (design, padded shape) → host topology.
# DesignSpec is a frozen dataclass, so it hashes by value; repeated
# `monte_carlo` calls build each topology once.
_TOPO_CACHE: Dict[tuple, HallTopology] = {}


def _staged_topology(design: DesignSpec, rows_per_hall: int,
                     lineups_per_hall: int) -> HallTopology:
    key = (design, rows_per_hall, lineups_per_hall)
    if key not in _TOPO_CACHE:
        _TOPO_CACHE[key] = build_topology(design, 1,
                                          rows_per_hall=rows_per_hall,
                                          lineups_per_hall=lineups_per_hall)
    return _TOPO_CACHE[key]


def _pod_geometry(batches) -> Tuple[int, int]:
    """(max, min) per-trial pod count over a list of `TraceBatch`es: the
    pod-window length and cluster-window start of the split-pods path.
    Raises `ValueError` unless pods precede clusters in every trial, as
    `fleet._event_windows` requires per month."""
    counts = np.concatenate([b.n_pods.ravel() for b in batches])
    for b in batches:
        ip = np.asarray(b.is_pod)
        if np.any(ip[:, 1:] & ~ip[:, :-1]):
            raise ValueError(
                "split-pods scan needs pod events to precede cluster "
                "events within each trial (the generated-trace order); "
                "use legacy_pod_cond=True for unordered traces")
    return int(counts.max()), int(counts.min())


def _mc_prepare(axes: MCAxes, n_trials: int, n_events: int, year: int,
                scenario: str, gpu_power_share: float, pod_racks: int,
                quantum_racks: int, la_fraction: float,
                single_sku_gpu: bool, refill_events: int | None, device,
                legacy_pod_cond: bool = False):
    """Host-side staging: the padded topologies repeated per trial, the
    fill and refill traces, each trial's key and policy, all flattened to
    one (configuration × trial) axis N = B·T on `device`, and the
    placement mode's keywords for `run_trial` (`with_pods`; on the
    split-pods path the windows, bucketed to 4 as `repro` buckets them,
    pod window up and cluster start down, `pod_scan_len` and `hd_scan`).
    Returns ((jt, ta, tb, keys, policy), mode).

    Refill traces draw from the phase-1 stream of the configuration's own
    seed (`sample_mixed_traces(phase=1)`), fill traces from phase 0; trial
    t of a configuration seeded s keys by ``split(PRNGKey(s), T)[t]``."""
    axes.validate()
    T = int(n_trials)
    R_pad = max(d.n_rows for d in axes.designs)
    X_pad = max(d.n_lineups for d in axes.designs)
    staged = [_staged_topology(d, R_pad, X_pad) for d in axes.designs]
    jt = pl.topology(staged, device)
    jt = Topology(*(x.repeat_interleave(T, dim=0) for x in jt))

    E_b = refill_events or max(200, n_events // 3)
    share = 1.0 if single_sku_gpu else gpu_power_share
    gen = functools.partial(
        arrivals.sample_mixed_traces, year=year, scenario=scenario,
        gpu_power_share=share, pod_racks=pod_racks,
        quantum_racks=quantum_racks, la_fraction=la_fraction,
        single_sku_gpu=single_sku_gpu)
    tas = [gen(T, n_events, seed=s, sku_kw_override=kw)
           for s, kw in zip(axes.seeds, axes.sku_kw)]
    tbs = [gen(T, E_b, seed=s, phase=1, sku_kw_override=kw)
           for s, kw in zip(axes.seeds, axes.sku_kw)]
    with_pods = any(bool(t.is_pod.any()) for t in tas + tbs)
    mode = dict(with_pods=with_pods)
    if with_pods and not legacy_pod_cond:
        wa, sa = _pod_geometry(tas)
        wb, sb = _pod_geometry(tbs)

        def bucket(n, E):
            return min(-(-n // 4) * 4, E)

        mode.update(
            split_pods=True,
            pod_windows=(bucket(wa, n_events), bucket(wb, E_b)),
            cluster_starts=(sa // 4 * 4, sb // 4 * 4),
            pod_scan_len=min(max(t.max_pod_racks for t in tas + tbs),
                             pl.MAX_POD_RACKS),
            hd_scan=max(t.n_hd_rows for t in staged))
    keys = prng.split(prng.prng_key(axes.seeds, device), T).reshape(-1, 2)
    policy = pl.policy_tensor([p for p in axes.policies for _ in range(T)],
                              device)
    return (jt, TraceArrays.from_batches(tas, device),
            TraceArrays.from_batches(tbs, device), keys, policy), mode


class MCOutputs(NamedTuple):
    """Host outputs of configurations ``[lo, hi)``, each ``[hi − lo, T,
    …]``: `mc_sweep`'s six result arrays, then the trials' registries,
    then the placement steps run (kernel launches) and the pod racks
    among them."""
    lineup_stranding: np.ndarray   # [n, T, X_pad] f32
    hall_stranding: np.ndarray     # [n, T] f32
    deployed_kw: np.ndarray        # [n, T] f32
    saturated: np.ndarray          # [n, T] bool
    placed_a: np.ndarray           # [n, T, E] bool
    placed_b: np.ndarray           # [n, T, E_b] bool
    rows_a: np.ndarray             # [n, T, E, MAX_POD_RACKS] i64
    counts_a: np.ndarray           # [n, T, E, MAX_POD_RACKS] f32
    rows_b: np.ndarray             # [n, T, E_b, MAX_POD_RACKS] i64
    counts_b: np.ndarray           # [n, T, E_b, MAX_POD_RACKS] f32
    event_steps: int
    pod_steps: int


def _mc_evaluate_trials(args, mode: dict, trials, *, harvest: bool,
                        interpret: bool = False, device=None) -> MCOutputs:
    """`singlehall.run_trial` over an index set of a `_mc_prepare`
    batch's flat (configuration × trial) axis: `trials`, a slice or an
    index tensor, selects the topology, keys and policy (axis 0) and the
    event-major traces (axis 1), run under the whole batch's placement
    `mode` (on `device` when given; else where `_mc_prepare` staged
    them).  The outputs are flat, ``[n, …]``, on the host.  Every caller
    runs this one evaluator: `mc_sweep` and the resilient executor over
    configuration ranges (`_mc_evaluate`), `sharded_mc_sweep` over its
    slabs and blocks."""
    def take(x, axis=0):
        x = x[trials] if axis == 0 else x[:, trials].contiguous()
        return x if device is None else x.to(device)

    jt, ta, tb, keys, policy = args
    jt = Topology(*(take(x) for x in jt))
    ta, tb = (TraceArrays(*(take(x, 1) for x in t)) for t in (ta, tb))
    state, res_a, res_b = run_trial(jt, pl.init_state(jt), ta, tb,
                                    take(policy), take(keys),
                                    harvest=harvest, interpret=interpret,
                                    **mode)
    out = (pl.lineup_stranding(jt, state), pl.hall_stranding(jt, state)[:, 0],
           pl.deployed_kw(state), res_b.saturated, res_a.placed,
           res_b.placed, res_a.rows, res_a.counts, res_b.rows, res_b.counts)
    return MCOutputs(*(x.cpu().numpy() for x in out),
                     event_steps=res_a.steps + res_b.steps,
                     pod_steps=res_a.pod_steps + res_b.pod_steps)


def _mc_evaluate(args, mode: dict, n_trials: int, lo: int, hi: int, *,
                 harvest: bool, interpret: bool = False) -> MCOutputs:
    """`_mc_evaluate_trials` over configurations ``[lo, hi)`` (trials
    ``[lo·T, hi·T)``), the outputs shaped ``[hi − lo, T, …]``.
    `mc_sweep` runs ``[0, B)``; the resilient executor
    (`resilience.resilient_mc_sweep`) any chunk of it, with the same bits
    in every row."""
    T = n_trials
    out = _mc_evaluate_trials(args, mode, slice(lo * T, hi * T),
                              harvest=harvest, interpret=interpret)
    return out._replace(**{f: getattr(out, f).reshape(
        (hi - lo, T) + getattr(out, f).shape[1:])
        for f in MCOutputs._fields[:10]})


def _mc_finalize(out, axes: MCAxes, models=None, year: int = 2028,
                 scenario: str = proj.MED, gpu_share: float = 1.0,
                 pod_racks: int = 1) -> MCResult:
    """Host-side unpack plus the metric stage, in `repro`'s float32 for
    deployed power and delivered tokens/s."""
    lineup_str, hall_str, deployed, saturated, placed_a, placed_b = out
    provisioned = np.array([d.ha_capacity_kw / 1e3 for d in axes.designs])
    models = (tp.MODEL_SUITE if models is None
              else tuple(tp.resolve_model(m) for m in models))
    if models:
        # one serving deployment for the whole call (year/scenario/pod size
        # are call-level), so the metric stage is a single [1, Mdl] grid
        dep = tp.serving_deployment(year, scenario, pod_racks)
        tpw = np.asarray(tp.tps_per_watt_grid(models, [dep]))[0]  # [Mdl]
        capex = np.array([cost.hall_capex(d) for d in axes.designs])
        delivered = (deployed * 1e3 * gpu_share)[..., None] * tpw
        with np.errstate(divide="ignore", invalid="ignore"):
            tps_per_pw = delivered / (provisioned[:, None, None] * 1e6)
            dpt = np.where(delivered > 0,
                           capex[:, None, None] / delivered, np.nan)
    else:
        B, T = deployed.shape
        delivered = np.zeros((B, T, 0))
        tps_per_pw, dpt = delivered.copy(), delivered.copy()
    return MCResult(
        axes=axes,
        lineup_stranding=lineup_str,
        hall_stranding=hall_str,
        deployed_kw=deployed,
        saturated=saturated,
        placed_a=placed_a,
        placed_b=placed_b,
        ha_capacity_kw=np.array([d.ha_capacity_kw for d in axes.designs]),
        provisioned_mw=provisioned,
        model_names=[m.name for m in models],
        delivered_tps=delivered,
        tps_per_provisioned_w=tps_per_pw,
        dollars_per_tps=dpt,
    )


def mc_sweep(axes: MCAxes, n_trials: int = 32, n_events: int = 600,
             year: int = 2028, scenario: str = proj.MED,
             gpu_power_share: float = 0.6, pod_racks: int = 1,
             quantum_racks: int = 10, la_fraction: float = 0.0,
             harvest: bool = True, single_sku_gpu: bool = False,
             refill_events: int | None = None,
             legacy_pod_cond: bool = False, models=None, device="cuda",
             interpret: bool = False) -> MCResult:
    """Evaluate every single-hall MC configuration in `axes` as one batch
    of ``len(axes) · n_trials`` trials.

    Topologies are padded to the batch's common (rows, line-ups) shape;
    padding rows have zero capacity and padded line-ups are inactive, so
    real-row results are unchanged and `result(i)` strips the padding.
    A pod-free run takes ``n_events + refill_events`` placement steps,
    each one placement-score launch; a pod adds one step per rack
    (`event_steps` counts them all, `pod_steps` the pods').

    Args:
        axes: the configuration batch (see `MCAxes`).
        n_trials / n_events: trials per configuration, fill-phase events.
        year / scenario: SKU-projection operating point (all configs).
        gpu_power_share / pod_racks / quantum_racks / la_fraction: trace
            mix parameters (`arrivals.sample_mixed_traces`); pod traces
            (``pod_racks > 1``) run the split-pods path.
        harvest: apply the §5.2 harvest between fill and refill.
        single_sku_gpu: Fig. 6 mode: GPU-only events at each
            configuration's `sku_kw` override.
        refill_events: refill-phase event count (default
            ``max(200, n_events // 3)``).
        legacy_pod_cond: place a pod trace's events through the
            per-event cond instead of the split-pods windows (the same
            results; the reference path of `mc_pod_speedup`).
        models: Table 2 models (objects or names) for the per-trial
            $/performance columns (default `throughput.MODEL_SUITE`;
            `()` skips the stage).
        device: where the trials run (default ``"cuda"``; the CPU only
            when asked for).
        interpret: score rows with the kernel's plain version instead of
            launching the CUDA kernel.
    """
    dev = resolve_device(device)
    args, mode = _mc_prepare(
        axes, n_trials, n_events, year, scenario, gpu_power_share,
        pod_racks, quantum_racks, la_fraction, single_sku_gpu,
        refill_events, dev, legacy_pod_cond)
    out = _mc_evaluate(args, mode, int(n_trials), 0, len(axes),
                       harvest=harvest, interpret=interpret)
    res = _mc_finalize(out[:6], axes, models=models, year=year,
                       scenario=scenario,
                       gpu_share=1.0 if single_sku_gpu else gpu_power_share,
                       pod_racks=pod_racks)
    res.rows_a, res.counts_a, res.rows_b, res.counts_b = out[6:10]
    res.event_steps, res.pod_steps = out.event_steps, out.pod_steps
    res.device = device_name(dev)
    return res


def sharded_mc_sweep(axes: MCAxes, n_trials: int = 32, n_events: int = 600,
                     year: int = 2028, scenario: str = proj.MED,
                     gpu_power_share: float = 0.6, pod_racks: int = 1,
                     quantum_racks: int = 10, la_fraction: float = 0.0,
                     harvest: bool = True, single_sku_gpu: bool = False,
                     refill_events: int | None = None,
                     legacy_pod_cond: bool = False, devices=None,
                     models=None, interpret: bool = False,
                     mesh_shape: Tuple[int, int] | None = None) -> MCResult:
    """`mc_sweep`, with the (config × trial) grid split over devices.

    The batch is prepared once on the host (`_mc_prepare`, its axis the
    flat N = B·T), and each device runs its part through
    `_mc_evaluate_trials` (in turn: `sharding.dispatch.run_slabs`),
    under the whole batch's placement mode, so every output is bitwise
    `mc_sweep`'s.  Two placements on the (config × trial) mesh of
    `sharding.axes.sweep_mesh` (devices default: every visible card):

    * default (`mesh_shape=None` or a trial extent of 1): contiguous
      slabs of the flat trial axis, product-sharded over the mesh
      (`sharding.axes.batch_slabs`), which balances the load even when
      B is smaller than the device count;
    * ``mesh_shape=(dc, dt)`` with ``dt > 1``: device (i, j) runs
      configuration block i × trial block j (`sharding.axes.grid_blocks`),
      chosen from the flat axis by index.

    The outputs go back to ``[B, T, …]``; `event_steps` and `pod_steps`
    sum over the devices' runs (each runs every step), so they count
    the kernel's launches.  `repro`'s padding replicas are not needed
    here: exactly B·T trials run.  One device, or one trial in all, is
    `mc_sweep`.  An error on any device propagates.
    """
    kw = dict(n_trials=n_trials, n_events=n_events, year=year,
              scenario=scenario, gpu_power_share=gpu_power_share,
              pod_racks=pod_racks, quantum_racks=quantum_racks,
              la_fraction=la_fraction, harvest=harvest,
              single_sku_gpu=single_sku_gpu, refill_events=refill_events,
              legacy_pod_cond=legacy_pod_cond, models=models,
              interpret=interpret)
    devs = shax.local_devices(devices)
    B, T = len(axes), int(n_trials)
    if len(devs) <= 1 or B * T == 1:
        return mc_sweep(axes, device=devs[0], **kw)
    mesh = shax.sweep_mesh(devs, mesh_shape)
    dispatch.build_kernel(axes, devs, interpret)
    args, mode = _mc_prepare(
        axes, n_trials, n_events, year, scenario, gpu_power_share,
        pod_racks, quantum_racks, la_fraction, single_sku_gpu,
        refill_events, torch.device("cpu"), legacy_pod_cond)
    if mesh.devices.shape[1] > 1:
        parts = [(d, (torch.arange(*b)[:, None] * T
                      + torch.arange(*t)).reshape(-1))
                 for d, b, t in shax.grid_blocks(mesh, B, T)
                 if b[0] < b[1] and t[0] < t[1]]
    else:
        parts = [(d, slice(a, b)) for d, a, b in
                 shax.batch_slabs(mesh, 0, B * T) if a < b]
    outs = dispatch.run_slabs([(d, functools.partial(
        _mc_evaluate_trials, args, mode, idx, harvest=harvest,
        interpret=interpret, device=d)) for d, idx in parts])
    flat = []
    for f in range(10):
        first = outs[0][f]
        full = np.empty((B * T,) + first.shape[1:], first.dtype)
        for (_, idx), o in zip(parts, outs):
            full[idx if isinstance(idx, slice) else idx.numpy()] = o[f]
        flat.append(full.reshape((B, T) + first.shape[1:]))
    res = _mc_finalize(flat[:6], axes, models=models, year=year,
                       scenario=scenario,
                       gpu_share=1.0 if single_sku_gpu else gpu_power_share,
                       pod_racks=pod_racks)
    res.rows_a, res.counts_a, res.rows_b, res.counts_b = flat[6:10]
    res.event_steps = sum(o.event_steps for o in outs)
    res.pod_steps = sum(o.pod_steps for o in outs)
    res.device = dispatch.devices_name(devs)
    return res

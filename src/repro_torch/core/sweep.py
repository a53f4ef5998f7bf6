"""Batched fleet-sweep engine (paper §5–6 evaluation methodology).

The counterpart of `repro.core.sweep`.  Every configuration's topology
is padded to a common shape, traces are padded to a common event count,
and `fleet.simulate_lifecycle` runs the whole `SweepAxes` batch on one
device as one batched state (grids with GPU pods through the split-trace
windows, or the per-event cond with ``legacy_pod_cond=True``):

    axes = SweepAxes.product(designs=[get_design("4N/3"), get_design("3+1")],
                             envs=[EnvelopeSpec(gpu_scenario=s)
                                   for s in ("med", "high")])
    res = sweep(axes)                      # on the card; device="cpu" too
    res.p90_stranding[i, -1], res.effective_dpm[i], res.result(i) ...

`resilience.resilient_sweep` runs the same batch in checkpointed,
fault-isolated chunks.  `sharded_sweep` streams it in chunks, each cut
into slabs over a device list (several cards, or one card more than
once), every row bitwise `sweep`'s.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, Sequence

import numpy as np
import torch

from . import cost, placement as pl, throughput as tp
from .arrivals import EnvelopeSpec, Trace, generate_fleet_trace
from .fleet import (FleetResult, FleetTrace, _auto_halls, _event_windows,
                    _month_e_max, _pod_scan_len, make_fleet_result,
                    simulate_lifecycle)
from .hierarchy import DesignSpec, SweepValidationError, build_topology
from .placement import DEFAULT_POLICY, POLICY_NAMES
from ..device import device_name, resolve_device
from ..sharding import axes as shax, dispatch


def _broadcast(seq, B, name):
    seq = list(seq)
    if len(seq) == 1:
        seq = seq * B
    if len(seq) != B:
        raise SweepValidationError(
            name, f"has length {len(seq)}, expected {B} (the batch size) "
            f"or 1 (broadcast)")
    return seq


@dataclass
class SweepAxes:
    """The configuration batch: four aligned per-configuration lists of
    equal length ``B`` (length-1 lists broadcast), configuration ``i``
    being ``(designs[i], envs[i], policies[i], seeds[i])``.  Build with
    `SweepAxes.zip` (aligned sequences) or `SweepAxes.product` (full cross
    product, designs-major, seeds fastest).  `tags` are free-form
    per-configuration labels carried along for reporting."""
    designs: List[DesignSpec]
    envs: List[EnvelopeSpec]
    policies: List[int]
    seeds: List[int]
    tags: List[str] = field(default_factory=lambda: [""])

    def __len__(self):
        return len(self.designs)

    def __post_init__(self):
        B = max(len(self.designs), len(self.envs), len(self.policies),
                len(self.seeds), len(self.tags))
        self.designs = _broadcast(self.designs, B, "designs")
        self.envs = _broadcast(self.envs, B, "envs")
        self.policies = [int(p) for p in _broadcast(self.policies, B,
                                                    "policies")]
        self.seeds = [int(s) for s in _broadcast(self.seeds, B, "seeds")]
        self.tags = [str(t) for t in _broadcast(self.tags, B, "tags")]

    @staticmethod
    def zip(designs, envs, policies=(DEFAULT_POLICY,), seeds=(0,),
            tags=("",)) -> "SweepAxes":
        """Aligned per-configuration sequences (length-1 broadcasts)."""
        return SweepAxes(list(designs), list(envs), list(policies),
                         list(seeds), list(tags))

    @staticmethod
    def product(designs: Sequence[DesignSpec], envs: Sequence[EnvelopeSpec],
                policies: Sequence[int] = (DEFAULT_POLICY,),
                seeds: Sequence[int] = (0,),
                env_tags: Sequence[str] | None = None) -> "SweepAxes":
        """Full grid, designs-major ordering; `env_tags` (aligned with
        `envs`) label each envelope through the cross product."""
        env_tags = list(env_tags) if env_tags is not None else [""] * len(envs)
        if len(env_tags) != len(envs):
            raise ValueError(f"env_tags has length {len(env_tags)}, "
                             f"expected {len(envs)}")
        combos = list(itertools.product(designs, zip(envs, env_tags),
                                        policies, seeds))
        return SweepAxes([c[0] for c in combos], [c[1][0] for c in combos],
                         [c[2] for c in combos], [c[3] for c in combos],
                         [c[1][1] for c in combos])

    def validate(self) -> "SweepAxes":
        """Raise `SweepValidationError` before any device work: on an
        invalid design, envelope, policy id or mixed horizons."""
        if len(self) == 0:
            raise SweepValidationError(
                "designs", "empty sweep: zero configurations")
        seen: set = set()
        for d in self.designs:
            if id(d) not in seen:
                seen.add(id(d))
                d.validate()
        for e in self.envs:
            if id(e) not in seen:
                seen.add(id(e))
                e.validate()
        for i, p in enumerate(self.policies):
            if not 0 <= p < len(POLICY_NAMES):
                raise SweepValidationError(
                    "policies", f"policies[{i}] = {p} outside "
                    f"[0, {len(POLICY_NAMES)}); have {POLICY_NAMES}")
        horizons = {(e.start_year, e.end_year) for e in self.envs}
        if len(horizons) > 1:
            raise SweepValidationError(
                "envs", f"envelopes span different horizons: "
                f"{sorted(horizons)}; the lifecycle needs one common "
                f"month count")
        return self


@dataclass
class SweepResult:
    """Per-configuration metrics, leading axis = configuration."""
    axes: SweepAxes
    months: np.ndarray             # [M]
    halls_active: np.ndarray       # [B, M]
    deployed_mw: np.ndarray        # [B, M]
    p50_stranding: np.ndarray      # [B, M]
    p90_stranding: np.ndarray      # [B, M]
    final_hall_stranding: np.ndarray    # [B, H_max] (use n_halls_built)
    final_lineup_stranding: np.ndarray  # [B, X_tot]
    lineup_is_active: np.ndarray   # [B, X_tot]
    lineups_per_hall: int          # common padded per-hall line-up count
    n_halls_built: np.ndarray      # [B] int
    final_deployed_mw: np.ndarray  # [B]
    placed_fraction: np.ndarray    # [B]
    initial_dpm: np.ndarray        # [B] $/MW at commissioning
    effective_dpm: np.ndarray      # [B] lifecycle-effective $/MW
    total_capex: np.ndarray        # [B] $
    # --- metric stage (paper §5.4/§6.6: $/performance, not installed MW) ---
    provisioned_mw: np.ndarray = None   # [B] halls built × HA nameplate
    model_names: List[str] = field(default_factory=list)   # [Mdl]
    delivered_tps: np.ndarray = None         # [B, Mdl] fleet tokens/s
    tps_per_provisioned_w: np.ndarray = None  # [B, Mdl] tokens/s per built W
    dollars_per_tps: np.ndarray = None       # [B, Mdl] capex / delivered TPS
    # --- the port's own: registry and run facts ---
    act_month: np.ndarray = None   # [B, H_max] hall opening month (-1)
    reg_rows: np.ndarray = None    # [B, E_max, 8] rows each event's racks
                                   # landed in (-1 padded)
    reg_counts: np.ndarray = None  # [B, E_max, 8] racks in each row
    event_steps: int = 0           # placement steps run (kernel launches)
    pod_steps: int = 0             # of which pod racks
    device: str = ""               # where the lifecycle ran

    def __len__(self):
        return len(self.axes)

    @property
    def tags(self) -> List[str]:
        """Per-configuration labels (see `SweepAxes.tags`)."""
        return self.axes.tags

    def result(self, i: int) -> FleetResult:
        """Unpack configuration `i` into a sequential-style FleetResult."""
        out = SimpleNamespace(
            halls_active=self.halls_active[i],
            deployed_kw=self.deployed_mw[i] * 1e3,
            p50_stranding=self.p50_stranding[i],
            p90_stranding=self.p90_stranding[i],
            final_hall_stranding=self.final_hall_stranding[i],
            final_lineup_stranding=self.final_lineup_stranding[i],
            n_halls_built=self.n_halls_built[i],
            final_deployed_kw=self.final_deployed_mw[i] * 1e3,
            placed_fraction=self.placed_fraction[i])
        return make_fleet_result(out, len(self.months),
                                 self.lineups_per_hall,
                                 self.lineup_is_active[i],
                                 self.axes.designs[i], self.axes.envs[i])


def _prepare(axes: SweepAxes, n_halls_max: int,
             traces: Sequence[Trace] | None, device,
             legacy_pod_cond: bool = False):
    """Host-side batch assembly: pads every configuration to common
    shapes, bucketed as `repro` buckets them (hall cap to 4, trace events
    to 64, per-month cluster windows to 4; rows/line-ups per hall to the
    largest design).  Pod grids on the split-trace path add a pod window
    per month, as long as the largest monthly pod count (not bucketed),
    the rack-scan length `pod_scan_len` (the largest pod) and `hd_scan`
    (the largest HD-row count, the compacted pod view).  Returns a
    namespace of (jt, ft, windows (idx, valid, idx_pod, valid_pod),
    policy, h_caps, n_real, seeds, months, topos, X_pad, with_pods,
    legacy_pod_cond, pod_scan_len, hd_scan), every per-configuration
    field with the configuration on axis 0 (see `_evaluate`)."""
    axes.validate()
    B = len(axes)
    months = axes.envs[0].n_months

    if traces is None:
        traces = [generate_fleet_trace(e, s)
                  for e, s in zip(axes.envs, axes.seeds)]
    if len(traces) != B:
        raise SweepValidationError(
            "traces", f"need one trace per configuration: got "
            f"{len(traces)} traces for {B} configurations")

    def bucket(n, q):
        return int(np.ceil(max(n, 1) / q) * q)

    h_caps = [n_halls_max or _auto_halls(d, e)
              for d, e in zip(axes.designs, axes.envs)]
    H_max = bucket(max(h_caps), 4)
    R_pad = max(d.n_rows for d in axes.designs)
    X_pad = max(d.n_lineups for d in axes.designs)
    topos = [build_topology(d, H_max, rows_per_hall=R_pad,
                            lineups_per_hall=X_pad) for d in axes.designs]
    jt = pl.topology(topos, device)

    E_max = bucket(max(len(t) for t in traces), 64)
    ft = FleetTrace.from_traces(traces, pad_to=E_max, pad_month=months)
    with_pods = any(bool(np.asarray(t.is_pod).any()) for t in traces)
    split = with_pods and not legacy_pod_cond
    pod_sel = [np.asarray(t.is_pod) for t in traces]
    e_max = bucket(max(_month_e_max(t, months, select=~p if split else None)
                       for t, p in zip(traces, pod_sel)), 4)
    ep_max = (max(_month_e_max(t, months, select=p)
                  for t, p in zip(traces, pod_sel)) if split else 1)
    windows = [_event_windows(t, months, split, e_max=e_max, ep_max=ep_max,
                              modulo=E_max) for t in traces]
    return SimpleNamespace(
        jt=jt, ft=ft, windows=[np.stack(w) for w in zip(*windows)],
        policy=pl.policy_tensor(axes.policies, device), h_caps=h_caps,
        n_real=[len(t) for t in traces], seeds=axes.seeds, months=months,
        topos=topos, X_pad=X_pad, with_pods=with_pods,
        legacy_pod_cond=legacy_pod_cond, pod_scan_len=_pod_scan_len(traces),
        hd_scan=max(t.n_hd_rows for t in topos))


def _evaluate(prep, lo: int, hi: int, *, harvest: bool, mature_months: int,
              exact_quantiles: bool = True, quantile_bins: int | None = None,
              interpret: bool = False, device=None):
    """`fleet.simulate_lifecycle` over configurations ``[lo, hi)`` of a
    prepared batch: the topology, traces, windows, policies, hall caps,
    event counts and seeds sliced on axis 0, the padded shapes and the
    placement mode the whole batch's.  `sweep` runs ``[0, B)``; the
    resilient executor (`resilience.resilient_sweep`) any chunk of it,
    and `sharded_sweep` any slab, with the same bits in every row.
    `device` moves the slab's topology and policies there first (default:
    they stay where `_prepare` staged them)."""
    def take(x):
        x = x[lo:hi]
        return x if device is None else x.to(device)

    return simulate_lifecycle(
        type(prep.jt)(*(take(x) for x in prep.jt)),
        type(prep.ft)(*(x[lo:hi] for x in prep.ft)),
        *(w[lo:hi] for w in prep.windows), take(prep.policy),
        prep.h_caps[lo:hi], prep.n_real[lo:hi],
        harvest=harvest, mature_months=mature_months,
        seeds=prep.seeds[lo:hi], with_pods=prep.with_pods,
        legacy_pod_cond=prep.legacy_pod_cond,
        pod_scan_len=prep.pod_scan_len, hd_scan=prep.hd_scan,
        exact_quantiles=exact_quantiles, quantile_bins=quantile_bins,
        interpret=interpret)


def _host_outputs(out):
    """A slab's `SimOutputs` with every tensor brought to the host."""
    return type(out)(*(v.cpu().numpy() if torch.is_tensor(v) else v
                       for v in out))


def serving_tpw_rows(envs: Sequence[EnvelopeSpec],
                     models: Sequence[tp.MoEModel],
                     metric_year: int | None = None) -> np.ndarray:
    """[B, Mdl] serving tokens/s-per-watt rows for a batch of envelopes.

    Each envelope implies one serving deployment (`tp.serving_deployment`
    at `metric_year`, default its `end_year`, at its placement quantum);
    rows are gathered from one `tps_per_watt_grid` over the unique set."""
    keys = [(int(metric_year or e.end_year), e.gpu_scenario,
             max(int(e.pod_racks), 1),
             bool(e.pod_scale_arch or e.pod_racks > 1)) for e in envs]
    uniq = sorted(set(keys))
    deps = [tp.serving_deployment(*k) for k in uniq]
    grid = np.asarray(tp.tps_per_watt_grid(models, deps))
    row = {k: grid[i] for i, k in enumerate(uniq)}
    return np.stack([row[k] for k in keys])


def gpu_power_share(env: EnvelopeSpec) -> float:
    """Fraction of deployed MW that is GPU serving capacity (the rest is
    general compute / storage and delivers no tokens)."""
    total = env.gpu_gw + env.compute_gw + env.storage_gw
    return env.gpu_gw / total if total > 0 else 0.0


def _metric_stage(axes: SweepAxes, models, metric_year,
                  deployed_mw: np.ndarray, provisioned_mw: np.ndarray,
                  capex: np.ndarray):
    """Batched throughput/cost columns over final deployed capacity:
    (model_names, delivered_tps, tps_per_provisioned_w, dollars_per_tps),
    each [B, Mdl].  NaN marks undefined ratios, never inf."""
    models = (tp.MODEL_SUITE if models is None
              else tuple(tp.resolve_model(m) for m in models))
    B = len(axes)
    if not models:
        empty = np.zeros((B, 0))
        return [], empty, empty.copy(), empty.copy()
    tpw = serving_tpw_rows(axes.envs, models, metric_year)
    share = np.array([gpu_power_share(e) for e in axes.envs])
    delivered = tpw * (deployed_mw * 1e6 * share)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        tps_per_pw = np.where(provisioned_mw[:, None] > 0,
                              delivered / (provisioned_mw[:, None] * 1e6),
                              np.nan)
        dpt = np.where(delivered > 0, capex[:, None] / delivered, np.nan)
    return [m.name for m in models], delivered, tps_per_pw, dpt


def _finalize(out, axes: SweepAxes, months: int, topos, X_pad: int,
              models=None, metric_year: int | None = None,
              device: str = "") -> SweepResult:
    """Host-side unpack of the batched outputs plus the cost model and
    the metric stage into a `SweepResult`."""
    host = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in out._asdict().items()}
    n_built = host["n_halls_built"].astype(int)
    deployed_mw = host["final_deployed_kw"] / 1e3
    initial = np.array([cost.initial_dollars_per_mw(d)
                        for d in axes.designs])
    effective = np.array([
        cost.effective_dollars_per_mw(d, int(n), float(mw))
        for d, n, mw in zip(axes.designs, n_built, deployed_mw)])
    capex = np.array([int(n) * cost.hall_capex(d)
                      for d, n in zip(axes.designs, n_built)])
    provisioned = np.array([int(n) * d.ha_capacity_kw / 1e3
                            for d, n in zip(axes.designs, n_built)])
    names, delivered, tps_per_pw, dpt = _metric_stage(
        axes, models, metric_year, deployed_mw, provisioned, capex)
    return SweepResult(
        axes=axes,
        months=np.arange(months),
        halls_active=host["halls_active"],
        deployed_mw=host["deployed_kw"] / 1e3,
        p50_stranding=host["p50_stranding"],
        p90_stranding=host["p90_stranding"],
        final_hall_stranding=host["final_hall_stranding"],
        final_lineup_stranding=host["final_lineup_stranding"],
        lineup_is_active=np.stack([np.asarray(t.lineup_is_active)
                                   for t in topos]),
        lineups_per_hall=X_pad,
        n_halls_built=n_built,
        final_deployed_mw=deployed_mw,
        placed_fraction=host["placed_fraction"],
        initial_dpm=initial,
        effective_dpm=effective,
        total_capex=capex,
        provisioned_mw=provisioned,
        model_names=names,
        delivered_tps=delivered,
        tps_per_provisioned_w=tps_per_pw,
        dollars_per_tps=dpt,
        act_month=host["act_month"],
        reg_rows=host["reg_rows"],
        reg_counts=host["reg_counts"],
        event_steps=host["event_steps"],
        pod_steps=host["pod_steps"],
        device=device,
    )


def sweep(axes: SweepAxes, harvest: bool = True, mature_months: int = 12,
          n_halls_max: int = 0, traces: Sequence[Trace] | None = None,
          legacy_pod_cond: bool = False, models=None,
          metric_year: int | None = None, device="cuda",
          interpret: bool = False, exact_quantiles: bool = True,
          quantile_bins: int | None = None) -> SweepResult:
    """Evaluate every configuration in `axes` as one batched lifecycle.

    All envelopes must share one buildout horizon.  Padding is inert:
    padded rows have zero capacity (never feasible), padded line-ups are
    inactive, and padded trace events arrive after the horizon.
    `result(i)` recovers the `FleetResult` of configuration `i`.  Pod
    traces run the split-trace windows: each month's pods through the
    attempt/retry pod path, then its clusters through the biased attempt
    (see `fleet.simulate_lifecycle`).

    Args:
        axes: the configuration batch (see `SweepAxes`).
        harvest: harvest one-year-old racks (static across the batch).
        mature_months: hall age before it enters tail stranding stats.
        n_halls_max: hall cap; 0 auto-sizes per configuration.
        traces: optional pre-generated per-configuration arrival traces
            (defaults to `generate_fleet_trace(envs[i], seeds[i])`).
        legacy_pod_cond: place every event through the per-event cond
            and retry instead of the split-trace windows (the reference
            path of `pod_sweep_speedup`; the same results).
        models: Table 2 models (objects or names) for the $/performance
            metric stage (default `throughput.MODEL_SUITE`; `()` skips
            the stage).
        metric_year: serving-deployment year for the metric stage
            (default: each envelope's `end_year`).
        device: where the lifecycle runs (default ``"cuda"``; the CPU
            only when asked for).
        interpret: score rows with the kernel's plain version instead of
            launching the CUDA kernel.
        exact_quantiles: `True` (default) takes the exact p50/p90 over
            each configuration's ``[M, H]`` stranding history; `False`
            the streaming histogram estimate of each month (error ≤
            ``1 / quantile_bins``), with no history kept.
        quantile_bins: the histogram's buckets (default
            `quantiles.DEFAULT_BINS` = 512); ignored when exact.
    """
    dev = resolve_device(device)
    prep = _prepare(axes, n_halls_max, traces, dev, legacy_pod_cond)
    out = _evaluate(prep, 0, len(axes), harvest=harvest,
                    mature_months=mature_months,
                    exact_quantiles=exact_quantiles,
                    quantile_bins=quantile_bins, interpret=interpret)
    return _finalize(out, axes, prep.months, prep.topos, prep.X_pad,
                     models=models, metric_year=metric_year,
                     device=device_name(dev))


def sharded_sweep(axes: SweepAxes, harvest: bool = True,
                  mature_months: int = 12, n_halls_max: int = 0,
                  traces: Sequence[Trace] | None = None, devices=None,
                  models=None, metric_year: int | None = None,
                  legacy_pod_cond: bool = False, interpret: bool = False,
                  exact_quantiles: bool = True,
                  quantile_bins: int | None = None,
                  mesh_shape: tuple[int, int] | None = None,
                  chunk_size: int | None = None) -> SweepResult:
    """`sweep`, with the configuration batch streamed in chunks and each
    chunk split over a device mesh.

    The batch is prepared once on the host (`_prepare`), so the whole
    batch's padded shapes hold for every slab and every row is bitwise
    `sweep`'s.  It is cut into chunks of `chunk_size` configurations
    (rounded up to a multiple of the device count; default: the whole
    batch), each chunk into slabs over the (config × trial) mesh of
    `sharding.axes.sweep_mesh` (the flat configuration axis
    product-sharded over both mesh axes, so any ``(dc, dt)`` with
    ``dc·dt = D`` gives the same slabs on the same devices).  Each slab
    moves to its device, runs through `_evaluate` (the slabs in turn on
    the calling thread: `sharding.dispatch.run_slabs`) and comes back to
    the host; then the outputs are joined and `_finalize`d once.  Device
    memory holds one chunk's slabs and their lifecycle state, flat in the
    grid's size: this is how `giant_grid` sweeps 10⁴ configurations.
    `event_steps` and `pod_steps` sum over the slabs (each slab runs the
    steps one of its configurations is live in), so they still count the
    kernel's launches.

    `repro` pads a remainder grid with replicas of configuration 0 (a
    static-shape need of its compiled program) and drops them; the port
    has no such need and runs exactly ``B`` configurations.  With one
    device and no `chunk_size`, or one configuration, this is `sweep`.
    An error in any slab propagates; nothing falls back to the CPU.

    Args: as `sweep`, plus
        devices: the device list (default: every visible card; it may
            name a device more than once, e.g. ``["cpu"] * 4``).
        mesh_shape: (config, trial) mesh extents; must multiply out to
            the device count (default ``(D, 1)``).
        chunk_size: configurations per chunk (default: the whole batch).
    """
    devs = shax.local_devices(devices)
    if (len(devs) <= 1 and chunk_size is None) or len(axes) == 1:
        return sweep(axes, harvest=harvest, mature_months=mature_months,
                     n_halls_max=n_halls_max, traces=traces,
                     legacy_pod_cond=legacy_pod_cond, models=models,
                     metric_year=metric_year, device=devs[0],
                     interpret=interpret, exact_quantiles=exact_quantiles,
                     quantile_bins=quantile_bins)
    mesh = shax.sweep_mesh(devs, mesh_shape)
    dispatch.build_kernel(axes, devs, interpret)
    prep = _prepare(axes, n_halls_max, traces, torch.device("cpu"),
                    legacy_pod_cond)
    B, D = len(axes), len(devs)
    C = B if chunk_size is None else max(-(-int(chunk_size) // D) * D, D)
    knobs = dict(harvest=harvest, mature_months=mature_months,
                 exact_quantiles=exact_quantiles,
                 quantile_bins=quantile_bins, interpret=interpret)

    def slab(dev, lo, hi):
        return lambda: _host_outputs(_evaluate(prep, lo, hi, device=dev,
                                               **knobs))

    outs = []
    for lo in range(0, B, C):
        slabs = shax.batch_slabs(mesh, lo, min(lo + C, B))
        outs += dispatch.run_slabs([(s[0], slab(*s)) for s in slabs
                                    if s[1] < s[2]])
    out = type(outs[0])(
        *(np.concatenate(xs) for xs in zip(*(o[:-2] for o in outs))),
        event_steps=sum(o.event_steps for o in outs),
        pod_steps=sum(o.pod_steps for o in outs))
    return _finalize(out, axes, prep.months, prep.topos, prep.X_pad,
                     models=models, metric_year=metric_year,
                     device=dispatch.devices_name(devs))

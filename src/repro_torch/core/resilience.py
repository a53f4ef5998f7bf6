"""Resilient sweep execution: checkpoint/resume, fault isolation,
validation — the counterpart of `repro.core.resilience`.

A giant grid is minutes of card time; a crash, an OOM, or one
pathological configuration would lose the whole grid.  This module
wraps the sweep engines with three guarantees:

* **Durable per-chunk checkpointing** — the batch is prepared ONCE
  (`sweep._prepare` / `mc_sweep._mc_prepare`), sliced into fixed chunks
  of configurations, and each chunk's host slab is committed through the
  atomic `checkpoint.Checkpointer` (write-temp → `os.replace` → fsynced
  COMMIT marker, sha256-checksummed payload).  A run manifest pins the
  input fingerprint (the prepared tensors' bytes + statics + device type
  + code salt + chunk grid); an interrupted run re-prepares, matches the
  fingerprint, loads the committed chunks and computes only the rest.
  Every chunk is a slice of the same prepared batch run by the same
  range evaluator that `sweep` / `mc_sweep` run over the whole batch
  (`sweep._evaluate`, `mc_sweep._mc_evaluate`), so the resumed result is
  **bitwise identical** to an uninterrupted run.

* **Chunk-level fault isolation** — a failing chunk is retried on an
  exponential `runtime.fault.Backoff` schedule, then bisected so only
  the genuinely poisoned configurations are quarantined: their rows
  become NaN-sentinel results (ints −1, bools False) and the structured
  `RunReport.quarantined` lists them; every other row is bitwise
  unchanged.  NaN appearing in fields that are never legitimately NaN
  (`final_deployed_kw` / `placed_fraction`; MC `deployed_kw`) is treated
  the same way.  OOM (`torch.cuda.OutOfMemoryError`, a message naming
  "CUDA out of memory", any `MemoryError`, or injected) halves the
  dispatch size — stickily, so later chunks stream at the size that fits
  — while the checkpoint grid keeps the original chunk boundaries.

* **Validated inputs** — `axes.validate()` runs before any device work
  (`SweepValidationError` with the offending field).

The placement-score kernel is built before the first chunk runs, so a
missing `nvcc` or a compile error raises instead of being isolated as a
crash of every configuration.  Evaluation errors are isolated whatever
they are (the executor's contract); a sticky CUDA error (an illegal
address) spoils every later launch of the process and has no handling
of its own here.

`FaultPlan` is the deterministic fault-injection harness the tests and
the smoke run drive: fail chunk k's first j attempts, inject OOM at a
chosen halving depth, poison configurations (every evaluation of a range
containing one crashes), inject NaN rows, or crash the process right
after a chosen chunk commits.

    res = resilient_sweep(axes, chunk_size=128, checkpoint_dir="ckpt/")
    res.report.quarantined, res.report.chunks_resumed, ...
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer
from ..device import device_name, resolve_device
from ..runtime.fault import Backoff
from . import placement as pl
from .fleet import SimOutputs
from .mc_sweep import (MCAxes, MCOutputs, MCResult, _mc_evaluate,
                       _mc_finalize, _mc_prepare)
from .sweep import SweepAxes, SweepResult, _evaluate, _finalize, _prepare
from ..sharding.dispatch import build_kernel

# Version salt folded into the run fingerprint: bump on any change to
# the executor or the engines that affects numerics or slab layout, so
# stale checkpoints can never be resumed into a differently-coded run.
SALT = "resilience-torch-v1"
RUN_MANIFEST = "run_manifest.json"

# The slabs: every per-configuration output, so a resumed result still
# carries every placement decision; the step counts are run facts.
SWEEP_FIELDS = tuple(f for f in SimOutputs._fields
                     if f not in ("event_steps", "pod_steps"))
MC_FIELDS = tuple(f for f in MCOutputs._fields
                  if f not in ("event_steps", "pod_steps"))
# Quarantine metadata rides inside each chunk's slab dict as plain
# arrays (string-free), so resume reconstructs the report.
_Q_KEYS = ("__q_idx", "__q_reason", "__q_attempts")

REASON_CRASH, REASON_OOM, REASON_NAN = 1, 2, 3
REASONS = {REASON_CRASH: "crash", REASON_OOM: "oom", REASON_NAN: "nan-output"}
_REASON_CODES = {v: k for k, v in REASONS.items()}


# ---------------------------------------------------------------------------
# fault-injection harness
# ---------------------------------------------------------------------------

class SimulatedOOM(MemoryError):
    """Injected out-of-memory failure (stands in for a CUDA OOM)."""


class InjectedFault(RuntimeError):
    """Injected transient/poison evaluation failure."""


class InjectedCrash(RuntimeError):
    """Injected process death after a chunk commit (kill-and-resume
    tests); escapes `resilient_sweep` by design."""


class ResumeMismatchError(RuntimeError):
    """The checkpoint directory belongs to a different run (fingerprint
    mismatch): different axes/traces/statics/device/chunk grid or code
    salt.  Clear the directory (or point at a fresh one) to proceed."""


@dataclass
class FaultPlan:
    """Deterministic fault injection for the resilient executor.

    fail:  chunk → n: the chunk's first n full-range attempts raise
           `InjectedFault` (exercises retry/backoff; attempt n+1 wins).
    oom:   chunk → depth: evaluations of any range in that chunk wider
           than `chunk_len // 2**depth` raise `SimulatedOOM`, forcing
           exactly `depth` dispatch-size halvings.
    poison: global config indices; EVERY evaluation of a range
           containing one raises, driving bisection down to quarantine
           exactly those indices.
    nan:   global config indices whose output rows are overwritten with
           NaN after a successful evaluation (quarantined as
           "nan-output" after bisection).
    crash_after: chunk index; `InjectedCrash` is raised right after that
           chunk commits (the kill in kill-and-resume).
    """
    fail: Dict[int, int] = field(default_factory=dict)
    oom: Dict[int, int] = field(default_factory=dict)
    poison: Tuple[int, ...] = ()
    nan: Tuple[int, ...] = ()
    crash_after: Optional[int] = None
    _fail_seen: Dict[int, int] = field(default_factory=dict)

    def before_eval(self, chunk: int, lo: int, hi: int,
                    chunk_lo: int, chunk_hi: int) -> None:
        if lo == chunk_lo and hi == chunk_hi:
            seen = self._fail_seen.get(chunk, 0)
            if seen < self.fail.get(chunk, 0):
                self._fail_seen[chunk] = seen + 1
                raise InjectedFault(
                    f"injected failure: chunk {chunk} attempt {seen + 1}")
        depth = self.oom.get(chunk, 0)
        if depth and hi - lo > (chunk_hi - chunk_lo) // (1 << depth):
            raise SimulatedOOM(
                f"injected OOM: chunk {chunk} range [{lo}, {hi})")
        bad = [p for p in self.poison if lo <= p < hi]
        if bad:
            raise InjectedFault(
                f"poisoned configuration(s) {bad} in range [{lo}, {hi})")

    def after_eval(self, lo: int, hi: int, slab: Dict[str, np.ndarray]):
        rows = [p - lo for p in self.nan if lo <= p < hi]
        if rows:
            slab = dict(slab)
            for name, arr in slab.items():
                if np.issubdtype(arr.dtype, np.floating):
                    arr = arr.copy()
                    arr[rows] = np.nan
                    slab[name] = arr
        return slab

    def after_commit(self, chunk: int) -> None:
        if self.crash_after is not None and chunk == self.crash_after:
            raise InjectedCrash(
                f"injected crash after committing chunk {chunk}")


# ---------------------------------------------------------------------------
# run report
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuarantinedConfig:
    """One quarantined configuration (NaN-sentinel row in the result)."""
    index: int           # global configuration index
    reason: str          # "crash" | "oom" | "nan-output"
    error: str           # exception text ("" when reloaded from disk)
    attempts: int        # evaluation attempts spent on this config


@dataclass
class RunReport:
    """What the resilient executor did (attached as `result.report`)."""
    n_configs: int
    chunk_size: int
    n_chunks: int
    fingerprint: str
    chunks_computed: int = 0
    chunks_resumed: int = 0
    retries: int = 0
    oom_halvings: int = 0
    quarantined: List[QuarantinedConfig] = field(default_factory=list)

    def quarantined_indices(self) -> Tuple[int, ...]:
        return tuple(sorted(q.index for q in self.quarantined))


# ---------------------------------------------------------------------------
# fingerprint + manifest
# ---------------------------------------------------------------------------

def _host_bytes(x) -> Tuple[str, tuple, bytes]:
    """(dtype, shape, bytes) of a tensor, array or list on the host."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        return str(t.dtype), tuple(t.shape), t.numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(x))
    return str(a.dtype), a.shape, a.tobytes()


def _fingerprint(arrays: Sequence, statics: dict, B: int,
                 chunk_size: int) -> str:
    """sha256 over the prepared input batch (`arrays`, in the caller's
    fixed order, each with its dtype and shape), the static knobs, the
    chunk grid and the code salt — everything the per-chunk slabs depend
    on.  Matching fingerprints ⇒ committed chunks are verbatim slices of
    the run being resumed."""
    h = hashlib.sha256()
    h.update(SALT.encode())
    h.update(f"B={B};chunk={chunk_size}".encode())
    h.update(repr(sorted(statics.items(), key=lambda kv: kv[0])).encode())
    for x in arrays:
        dtype, shape, raw = _host_bytes(x)
        h.update(dtype.encode())
        h.update(str(shape).encode())
        h.update(raw)
    return h.hexdigest()


def _clear_chunks(directory: str) -> None:
    for name in os.listdir(directory):
        if name.startswith("step_"):
            shutil.rmtree(os.path.join(directory, name),
                          ignore_errors=True)


def _open_run(directory: str, fingerprint: str, B: int, chunk_size: int,
              n_chunks: int) -> bool:
    """Create or match the run manifest.  Returns True when committed
    chunks may be resumed (valid manifest, same fingerprint).  A
    corrupt/alien manifest discards any existing chunks and starts
    fresh; a well-formed manifest for a *different* run raises
    `ResumeMismatchError` instead of silently clobbering it."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, RUN_MANIFEST)
    if os.path.exists(path):
        try:
            with open(path) as f:
                m = json.load(f)
            ok = isinstance(m, dict) and isinstance(m.get("fingerprint"), str)
        except (json.JSONDecodeError, OSError):
            m, ok = None, False
        if ok:
            if m["fingerprint"] == fingerprint:
                return True
            raise ResumeMismatchError(
                f"{directory} holds a different run (fingerprint "
                f"{m['fingerprint'][:12]}… ≠ {fingerprint[:12]}…); clear "
                f"it or use a fresh checkpoint_dir")
        _clear_chunks(directory)        # torn manifest ⇒ chunks unprovable
    elif any(n.startswith("step_") for n in os.listdir(directory)):
        _clear_chunks(directory)        # chunks without a manifest
    meta = {"fingerprint": fingerprint, "salt": SALT, "n_configs": B,
            "chunk_size": chunk_size, "n_chunks": n_chunks}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)               # atomic manifest publish
    return False


# ---------------------------------------------------------------------------
# chunk executor
# ---------------------------------------------------------------------------

def _is_oom(e: BaseException) -> bool:
    """A CUDA OOM is a `RuntimeError` subclass, not a `MemoryError`."""
    return (isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError))
            or "CUDA out of memory" in str(e))


def _free_device_memory() -> None:
    """Hand the failed dispatch's cached blocks back before the halved
    one: collect what its frames still held, then empty the cache."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class _ChunkExecutor:
    """Evaluate `B` configurations in chunks with checkpointing, retry,
    bisection quarantine, and OOM halving.  `raw_eval(lo, hi)` returns
    the outputs of configurations `[lo, hi)` of the globally prepared
    batch, a NamedTuple whose `fields` form the slab dict; `spec` maps
    each field to its per-configuration (trailing shape, dtype); NaN in
    a `detect` field marks a poisoned row."""

    def __init__(self, raw_eval: Callable, fields: Sequence[str],
                 spec: Dict[str, Tuple[tuple, np.dtype]],
                 detect: Sequence[str], B: int, chunk_size: int,
                 checkpoint_dir: Optional[str], plan: Optional[FaultPlan],
                 backoff: Optional[Backoff]):
        self.raw_eval = raw_eval
        self.fields = tuple(fields)
        self.spec = spec
        self.detect = tuple(detect)
        self.B = B
        self.chunk = max(1, min(int(chunk_size), B))
        self.n_chunks = -(-B // self.chunk)
        self.plan = plan if plan is not None else FaultPlan()
        self.backoff = backoff if backoff is not None else Backoff()
        self.eval_size = self.chunk     # sticky OOM-halved dispatch width
        self.ckpt = (Checkpointer(checkpoint_dir, keep=10 ** 9)
                     if checkpoint_dir else None)

    # ---- slab helpers ----
    def _to_slab(self, out) -> Dict[str, np.ndarray]:
        return {f: (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
                for f, x in ((f, getattr(out, f)) for f in self.fields)}

    def _nan_slab(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """Sentinel slab for quarantined rows: floats NaN, ints −1,
        bools False.  Shapes and dtypes come from `spec` (nothing is
        evaluated)."""
        slab = {}
        for f in self.fields:
            shape, dt = self.spec[f]
            if np.issubdtype(dt, np.floating):
                fill = np.nan
            elif dt == np.bool_:
                fill = False
            else:
                fill = -1
            slab[f] = np.full((hi - lo,) + tuple(shape), fill, dt)
        return slab

    def _concat(self, slabs: Sequence[Dict[str, np.ndarray]]):
        return {f: np.concatenate([s[f] for s in slabs])
                for f in self.fields}

    def _bad_rows(self, slab: Dict[str, np.ndarray]) -> np.ndarray:
        """Rows whose never-NaN fields came back NaN (poisoned output).
        Only `detect` fields are scanned — quantile/metric columns carry
        legitimate NaN sentinels."""
        bad = None
        for f in self.detect:
            v = np.isnan(slab[f])
            v = v.reshape(v.shape[0], -1).any(axis=1) if v.ndim > 1 else v
            bad = v if bad is None else (bad | v)
        return bad

    # ---- fault-isolated evaluation ----
    def _quarantine(self, report: RunReport, idx: int, reason: int,
                    error: str, attempts: int):
        report.quarantined.append(QuarantinedConfig(
            index=idx, reason=REASONS[reason], error=error,
            attempts=attempts))

    def _halves(self, report: RunReport, chunk: int, lo: int, hi: int,
                chunk_lo: int, chunk_hi: int, retries: int):
        mid = (lo + hi) // 2
        return self._concat([
            self._eval_range(report, chunk, lo, mid, chunk_lo, chunk_hi,
                             retries),
            self._eval_range(report, chunk, mid, hi, chunk_lo, chunk_hi,
                             retries)])

    def _eval_range(self, report: RunReport, chunk: int, lo: int, hi: int,
                    chunk_lo: int, chunk_hi: int, retries: int):
        """Evaluate `[lo, hi)` with retry → bisection → quarantine.  The
        OOM branch leaves the `except` clause before dispatching its
        halves, so the failed attempt's frames (and the device memory
        they hold) are gone by then."""
        attempt = 0
        while True:
            try:
                self.plan.before_eval(chunk, lo, hi, chunk_lo, chunk_hi)
                slab = self._to_slab(self.raw_eval(lo, hi))
                slab = self.plan.after_eval(lo, hi, slab)
                bad = self._bad_rows(slab)
                if not bad.any():
                    return slab
                if hi - lo == 1:
                    self._quarantine(report, lo, REASON_NAN,
                                     "NaN in non-NaN output field",
                                     attempt + 1)
                    return self._nan_slab(lo, hi)
                # NaN output is deterministic — bisect without retries
                return self._halves(report, chunk, lo, hi, chunk_lo,
                                    chunk_hi, 0)
            except InjectedCrash:
                raise
            except Exception as e:      # noqa: BLE001 — isolate anything
                if _is_oom(e):
                    report.oom_halvings += 1
                    self.eval_size = max(self.eval_size // 2, 1)
                    if hi - lo == 1:
                        self._quarantine(report, lo, REASON_OOM, str(e),
                                         attempt + 1)
                        return self._nan_slab(lo, hi)
                    oom = True
                else:
                    oom = False
                    if attempt < retries:
                        self.backoff.sleep(attempt)
                        attempt += 1
                        report.retries += 1
                        continue
                    if hi - lo == 1:
                        self._quarantine(report, lo, REASON_CRASH, str(e),
                                         attempt + 1)
                        return self._nan_slab(lo, hi)
            if oom:
                _free_device_memory()
                return self._halves(report, chunk, lo, hi, chunk_lo,
                                    chunk_hi, retries)
            # retries exhausted on a multi-config range: bisect to
            # isolate the poisoned configuration(s); halves get no
            # further retries (the transient budget is spent)
            return self._halves(report, chunk, lo, hi, chunk_lo, chunk_hi, 0)

    def _eval_chunk(self, report: RunReport, c: int, lo: int, hi: int):
        """One chunk, streamed at the (possibly OOM-halved) dispatch
        width."""
        parts, pos = [], lo
        while pos < hi:
            end = min(pos + self.eval_size, hi)
            parts.append(self._eval_range(
                report, c, pos, end, lo, hi,
                retries=self.backoff.max_retries))
            pos = end
        return parts[0] if len(parts) == 1 else self._concat(parts)

    # ---- the run ----
    def run(self, fingerprint: str = ""):
        """Returns `(slab, report)` with `slab` the concatenated
        `[B, …]` field dict; `fingerprint` (needed with a checkpoint
        directory) pins the run manifest."""
        report = RunReport(n_configs=self.B, chunk_size=self.chunk,
                           n_chunks=self.n_chunks, fingerprint="")
        resume_ok, done = False, set()
        if self.ckpt is not None:
            report.fingerprint = fingerprint
            resume_ok = _open_run(self.ckpt.dir, fingerprint, self.B,
                                  self.chunk, self.n_chunks)
            if resume_ok:
                done = set(self.ckpt.all_steps())

        slabs = []
        for c in range(self.n_chunks):
            lo, hi = c * self.chunk, min((c + 1) * self.chunk, self.B)
            slab = None
            if resume_ok and c in done:
                try:
                    leaves, _meta = self.ckpt.load(step=c, verify=True)
                    slab = dict(zip(sorted(self.fields + _Q_KEYS), leaves))
                    for q_i, q_r, q_a in zip(slab["__q_idx"],
                                             slab["__q_reason"],
                                             slab["__q_attempts"]):
                        self._quarantine(report, int(q_i), int(q_r), "",
                                         int(q_a))
                    report.chunks_resumed += 1
                except Exception:   # ChecksumError/torn read ⇒ recompute
                    slab = None
            if slab is None:
                n_q = len(report.quarantined)
                slab = self._eval_chunk(report, c, lo, hi)
                report.chunks_computed += 1
                new_q = report.quarantined[n_q:]
                slab["__q_idx"] = np.asarray(
                    [q.index for q in new_q], np.int64)
                slab["__q_reason"] = np.asarray(
                    [_REASON_CODES[q.reason] for q in new_q], np.int8)
                slab["__q_attempts"] = np.asarray(
                    [q.attempts for q in new_q], np.int32)
                if self.ckpt is not None:
                    self.ckpt.save(c, slab, blocking=True)
                self.plan.after_commit(c)
            slabs.append(slab)
        return self._concat(slabs), report


# ---------------------------------------------------------------------------
# front doors
# ---------------------------------------------------------------------------

def _mask_rows(report: RunReport, *arrays: np.ndarray) -> None:
    """NaN the derived float columns of quarantined rows (the raw slab
    already carries sentinels; `_finalize` recomputes per-design cost
    columns that must not survive for quarantined configurations)."""
    idx = list(report.quarantined_indices())
    if not idx:
        return
    for a in arrays:
        if a is not None and np.issubdtype(np.asarray(a).dtype,
                                           np.floating):
            a[idx] = np.nan


class _Counter:
    """Sums the placement steps of every range evaluated in this process
    (a resumed chunk adds 0; bisection and retries add theirs)."""

    def __init__(self, evaluate: Callable):
        self.evaluate = evaluate
        self.event_steps = self.pod_steps = 0

    def __call__(self, lo: int, hi: int):
        out = self.evaluate(lo, hi)
        self.event_steps += out.event_steps
        self.pod_steps += out.pod_steps
        return out


def _sweep_spec(prep) -> Dict[str, Tuple[tuple, np.dtype]]:
    """Per-configuration (trailing shape, dtype) of each slab field, read
    off the prepared batch's padded shapes."""
    M = prep.months
    H = prep.jt.hall_liq_cap.shape[1]
    X = prep.jt.lineup_cap.shape[1]
    E = prep.ft.month.shape[1]
    S = pl.MAX_POD_RACKS
    f32, i64 = np.dtype(np.float32), np.dtype(np.int64)
    return dict(
        halls_active=((M,), i64), deployed_kw=((M,), f32),
        p50_stranding=((M,), f32), p90_stranding=((M,), f32),
        final_hall_stranding=((H,), f32), final_lineup_stranding=((X,), f32),
        n_halls_built=((), i64), final_deployed_kw=((), f32),
        placed_fraction=((), f32), act_month=((H,), i64),
        reg_rows=((E, S), i64), reg_counts=((E, S), f32))


def _mc_spec(args, n_trials: int) -> Dict[str, Tuple[tuple, np.dtype]]:
    """Per-configuration (trailing shape, dtype) of each MC slab field."""
    jt, ta, tb = args[:3]
    T, X = n_trials, jt.lineup_cap.shape[1]
    E, E_b = ta.rack_kw.shape[0], tb.rack_kw.shape[0]
    S = pl.MAX_POD_RACKS
    f32, i64, b = (np.dtype(np.float32), np.dtype(np.int64),
                   np.dtype(np.bool_))
    return dict(
        lineup_stranding=((T, X), f32), hall_stranding=((T,), f32),
        deployed_kw=((T,), f32), saturated=((T,), b),
        placed_a=((T, E), b), placed_b=((T, E_b), b),
        rows_a=((T, E, S), i64), counts_a=((T, E, S), f32),
        rows_b=((T, E_b, S), i64), counts_b=((T, E_b, S), f32))


def resilient_sweep(axes: SweepAxes, chunk_size: int | None = None,
                    checkpoint_dir: str | None = None,
                    fault_plan: FaultPlan | None = None,
                    backoff: Backoff | None = None,
                    harvest: bool = True, mature_months: int = 12,
                    n_halls_max: int = 0, traces=None,
                    legacy_pod_cond: bool = False, models=None,
                    metric_year: int | None = None, device="cuda",
                    interpret: bool = False,
                    exact_quantiles: bool = True,
                    quantile_bins: int | None = None) -> SweepResult:
    """`sweep.sweep` behind the resilient chunk executor.

    The batch is prepared once, evaluated chunk-by-chunk through
    `sweep._evaluate` (slices of one prepared batch ⇒ bitwise identity
    with the one-shot result regardless of chunk boundaries, resumes, or
    bisection descents), and optionally checkpointed per chunk.  Returns
    a `SweepResult` whose `report` is the `RunReport`; quarantined
    configurations carry NaN-sentinel rows.  `event_steps` / `pod_steps`
    are the sums over the ranges this process evaluated (a resumed chunk
    adds 0): a chunked run counts more steps than the one-shot run, since
    each chunk runs every event slot one of its configurations is live
    in.

    Args beyond `sweep.sweep` (whose arguments, `device="cuda"` and
    `interpret` included, keep their meaning):
        chunk_size: configurations per checkpointed chunk (default: the
            whole batch as one chunk).
        checkpoint_dir: directory for the run manifest + per-chunk
            checkpoints; None disables durability (isolation/validation
            still apply).  Resuming into a directory whose manifest
            fingerprint does not match raises `ResumeMismatchError`.
        fault_plan: deterministic fault injection (tests, smoke run).
        backoff: retry schedule for failing chunks (default
            `runtime.fault.Backoff()`).
    """
    dev = resolve_device(device)
    build_kernel(axes, [dev], interpret)
    prep = _prepare(axes, n_halls_max, traces, dev, legacy_pod_cond)
    knobs = dict(harvest=harvest, mature_months=mature_months,
                 exact_quantiles=exact_quantiles,
                 quantile_bins=quantile_bins, interpret=interpret)
    B = len(axes)
    chunk = chunk_size if chunk_size is not None else B

    counter = _Counter(lambda lo, hi: _evaluate(prep, lo, hi, **knobs))
    ex = _ChunkExecutor(counter, SWEEP_FIELDS, _sweep_spec(prep),
                        detect=("final_deployed_kw", "placed_fraction"),
                        B=B, chunk_size=chunk,
                        checkpoint_dir=checkpoint_dir, plan=fault_plan,
                        backoff=backoff)
    fingerprint = ""
    if checkpoint_dir:
        statics = dict(knobs, with_pods=prep.with_pods,
                       legacy_pod_cond=prep.legacy_pod_cond,
                       pod_scan_len=prep.pod_scan_len, hd_scan=prep.hd_scan,
                       device=dev.type)
        fingerprint = _fingerprint(
            [*prep.jt, *prep.ft, *prep.windows, prep.policy, prep.h_caps,
             prep.n_real, prep.seeds], statics, B, ex.chunk)
    slab, report = ex.run(fingerprint)
    out = SimOutputs(**{f: slab[f] for f in SWEEP_FIELDS},
                     event_steps=counter.event_steps,
                     pod_steps=counter.pod_steps)
    res = _finalize(out, axes, prep.months, prep.topos, prep.X_pad,
                    models=models, metric_year=metric_year,
                    device=device_name(dev))
    _mask_rows(report, res.initial_dpm, res.effective_dpm,
               res.total_capex, res.provisioned_mw, res.delivered_tps,
               res.tps_per_provisioned_w, res.dollars_per_tps)
    res.report = report
    return res


def resilient_mc_sweep(axes: MCAxes, chunk_size: int | None = None,
                       checkpoint_dir: str | None = None,
                       fault_plan: FaultPlan | None = None,
                       backoff: Backoff | None = None,
                       n_trials: int = 32, n_events: int = 600,
                       year: int = 2028, scenario: str = "med",
                       gpu_power_share: float = 0.6, pod_racks: int = 1,
                       quantum_racks: int = 10, la_fraction: float = 0.0,
                       harvest: bool = True, single_sku_gpu: bool = False,
                       refill_events: int | None = None,
                       legacy_pod_cond: bool = False, models=None,
                       device="cuda", interpret: bool = False) -> MCResult:
    """`mc_sweep.mc_sweep` behind the resilient chunk executor (see
    `resilient_sweep`; chunks slice the configuration axis, trials ride
    inside their configuration, and the placement mode is the whole
    batch's).  The slabs hold `mc_sweep`'s six outputs and the trials'
    registries (`rows_a`, `counts_a`, `rows_b`, `counts_b`)."""
    dev = resolve_device(device)
    build_kernel(axes, [dev], interpret)
    T = int(n_trials)
    args, mode = _mc_prepare(axes, n_trials, n_events, year, scenario,
                             gpu_power_share, pod_racks, quantum_racks,
                             la_fraction, single_sku_gpu, refill_events,
                             dev, legacy_pod_cond)
    B = len(axes)
    chunk = chunk_size if chunk_size is not None else B

    counter = _Counter(lambda lo, hi: _mc_evaluate(
        args, mode, T, lo, hi, harvest=harvest, interpret=interpret))
    ex = _ChunkExecutor(counter, MC_FIELDS, _mc_spec(args, T),
                        detect=("deployed_kw",), B=B, chunk_size=chunk,
                        checkpoint_dir=checkpoint_dir, plan=fault_plan,
                        backoff=backoff)
    fingerprint = ""
    if checkpoint_dir:
        jt, ta, tb, keys, policy = args
        statics = dict(mode, harvest=harvest, interpret=interpret,
                       n_trials=T, device=dev.type)
        fingerprint = _fingerprint([*jt, *ta, *tb, keys, policy], statics,
                                   B, ex.chunk)
    slab, report = ex.run(fingerprint)
    res = _mc_finalize(tuple(slab[f] for f in MC_FIELDS[:6]), axes,
                       models=models, year=year, scenario=scenario,
                       gpu_share=1.0 if single_sku_gpu else gpu_power_share,
                       pod_racks=pod_racks)
    res.rows_a, res.counts_a, res.rows_b, res.counts_b = (
        slab[f] for f in MC_FIELDS[6:])
    res.event_steps, res.pod_steps = counter.event_steps, counter.pod_steps
    res.device = device_name(dev)
    _mask_rows(report, res.ha_capacity_kw, res.provisioned_mw,
               res.delivered_tps, res.tps_per_provisioned_w,
               res.dollars_per_tps)
    res.report = report
    return res

"""Parity of the port's resilient execution (`repro_torch.core.resilience`)
with `repro.core.resilience`, on `tests/test_resilience.py`'s grids.

The contract within the port is *bitwise*: the batch is prepared once and
every chunk, retry and bisection range is a slice of it run by the same
range evaluator `sweep` / `mc_sweep` run over the whole batch
(`sweep._evaluate`, `mc_sweep._mc_evaluate`), so a chunked, resumed or
quarantine-bisected run reproduces the port's one-shot arrays exactly,
registries included.  Against `repro` the port is held to
`tests/test_torch_sweep.py`'s standard (decisions bitwise, float columns
rtol 1e-6: XLA sums rows in its own order), and its `RunReport` counters
and quarantine records to equality under the same `FaultPlan`s.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import arrivals as r_arr  # noqa: E402
from repro.core import hierarchy as r_hier  # noqa: E402
from repro.core import mc_sweep as r_mc  # noqa: E402
from repro.core import resilience as r_res  # noqa: E402
from repro.core import sweep as r_sweep  # noqa: E402
from repro.runtime import fault as r_fault  # noqa: E402
from repro_torch.checkpoint.checkpointer import LEAVES  # noqa: E402
from repro_torch.core import arrivals as t_arr  # noqa: E402
from repro_torch.core import hierarchy as t_hier  # noqa: E402
from repro_torch.core import mc_sweep as t_mc  # noqa: E402
from repro_torch.core import placement as t_pl  # noqa: E402
from repro_torch.core import resilience as t_res  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.core.hierarchy import SweepValidationError  # noqa: E402
from repro_torch.runtime import fault as t_fault  # noqa: E402
from repro_torch.sharding import dispatch as t_dispatch  # noqa: E402

SCALE = 0.004
CPU = dict(device="cpu")

# every per-configuration field of a port SweepResult: the slab's fields
# (in result units) and the host-side columns derived from them
SLAB_FIELDS = ("halls_active", "deployed_mw", "p50_stranding",
               "p90_stranding", "final_hall_stranding",
               "final_lineup_stranding", "n_halls_built",
               "final_deployed_mw", "placed_fraction", "act_month",
               "reg_rows", "reg_counts")
DERIVED = ("initial_dpm", "effective_dpm", "total_capex", "provisioned_mw",
           "delivered_tps", "tps_per_provisioned_w", "dollars_per_tps")
ALL_FIELDS = SLAB_FIELDS + DERIVED
# against repro (test_torch_sweep.py's split)
DECISIONS = ("halls_active", "n_halls_built", "placed_fraction",
             "final_hall_stranding")
FLOATS = ("deployed_mw", "final_deployed_mw", "p50_stranding",
          "p90_stranding", "final_lineup_stranding") + DERIVED

MC_FIELDS = ("lineup_stranding", "hall_stranding", "deployed_kw",
             "saturated", "placed_a", "placed_b", "rows_a", "counts_a",
             "rows_b", "counts_b", "ha_capacity_kw", "provisioned_mw",
             "delivered_tps", "tps_per_provisioned_w", "dollars_per_tps")
MC_KW = dict(n_trials=2, n_events=80, year=2030, scenario="high")


def sweep_axes(hier, arr, sweep_mod):
    """8 configurations (2 designs × 2 envelopes × 2 seeds), so a chunk
    size of 3 leaves a ragged last chunk."""
    envs = [arr.EnvelopeSpec(demand_scale=SCALE, gpu_scenario=sc,
                             end_year=2028) for sc in ("med", "high")]
    return sweep_mod.SweepAxes.product(
        designs=[hier.get_design("4N/3"), hier.get_design("3+1")],
        envs=envs, seeds=(0, 1))


def mc_axes(hier, mc):
    return mc.MCAxes.zip(
        designs=[hier.get_design(n) for n in ("4N/3", "3+1", "10N/8")],
        seeds=[11, 12, 13])


def assert_bitwise(res, ref, fields, rows=None):
    """Whole arrays (or only the leading-axis `rows`) bitwise equal,
    shapes and dtypes included."""
    for f in fields:
        a, b = np.asarray(getattr(res, f)), np.asarray(getattr(ref, f))
        if rows is not None:
            a, b = a[rows], b[rows]
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f


def report_of(r):
    """The report as comparable plain data (the error text is free)."""
    return dict(n_configs=r.n_configs, chunk_size=r.chunk_size,
                n_chunks=r.n_chunks, chunks_computed=r.chunks_computed,
                chunks_resumed=r.chunks_resumed, retries=r.retries,
                oom_halvings=r.oom_halvings,
                quarantined=[(q.index, q.reason, q.attempts)
                             for q in r.quarantined])


@pytest.fixture(scope="module")
def axes8():
    return sweep_axes(t_hier, t_arr, t_sweep)


@pytest.fixture(scope="module")
def base8(axes8):
    """The port's uninterrupted one-shot result."""
    return t_sweep.sweep(axes8, **CPU)


@pytest.fixture(scope="module")
def ref8():
    return r_sweep.sweep(sweep_axes(r_hier, r_arr, r_sweep))


# ---------------------------------------------------------------------------
# the range evaluator
# ---------------------------------------------------------------------------

def test_front_doors_share_the_range_evaluators(axes8, monkeypatch):
    """`sweep` runs `_evaluate` once over the whole batch, and the
    resilient executor runs that same function."""
    assert t_res._evaluate is t_sweep._evaluate
    assert t_res._mc_evaluate is t_mc._mc_evaluate
    calls = []
    real = t_sweep._evaluate

    def spy(prep, lo, hi, **kw):
        calls.append((lo, hi))
        return real(prep, lo, hi, **kw)

    monkeypatch.setattr(t_sweep, "_evaluate", spy)
    t_sweep.sweep(axes8, models=(), **CPU)
    assert calls == [(0, len(axes8))]


@pytest.mark.parametrize("kind", ["fleet", "pod_fleet", "mc", "pod_mc"])
def test_sentinel_spec_matches_an_evaluated_slab(kind):
    """`_nan_slab`'s shapes and dtypes, read off the prepared batch, are
    those of a real evaluation of the same range."""
    if kind in ("fleet", "pod_fleet"):
        axes = sweep_axes(t_hier, t_arr, t_sweep)
        if kind == "pod_fleet":
            axes = t_sweep.SweepAxes.zip(
                designs=[t_hier.get_design("10N/8")] * 2,
                envs=[t_arr.EnvelopeSpec(
                    demand_scale=SCALE, gpu_scenario="high", end_year=2028,
                    pod_racks=5, pod_scale_arch=True)], seeds=[0, 1])
        prep = t_sweep._prepare(axes, 0, None, torch.device("cpu"))
        out = t_sweep._evaluate(prep, 1, 2, harvest=True, mature_months=12)
        spec, fields = t_res._sweep_spec(prep), t_res.SWEEP_FIELDS
    else:
        axes = mc_axes(t_hier, t_mc)
        kw = dict(MC_KW, pod_racks=5 if kind == "pod_mc" else 1)
        args, mode = t_mc._mc_prepare(
            axes, kw["n_trials"], kw["n_events"], kw["year"],
            kw["scenario"], 0.6, kw["pod_racks"], 10, 0.0, False, None,
            torch.device("cpu"))
        out = t_mc._mc_evaluate(args, mode, 2, 1, 2, harvest=True)
        spec, fields = t_res._mc_spec(args, 2), t_res.MC_FIELDS
    ex = t_res._ChunkExecutor(None, fields, spec, (), 3, 3, None, None,
                              None)
    real, nan = ex._to_slab(out), ex._nan_slab(1, 2)
    assert sorted(real) == sorted(nan) == sorted(fields)
    for f in fields:
        assert real[f].shape == nan[f].shape, f
        assert real[f].dtype == nan[f].dtype, f


# ---------------------------------------------------------------------------
# resilient_sweep ≡ sweep in the port (no faults)
# ---------------------------------------------------------------------------

class TestChunked:
    @pytest.mark.parametrize("chunk", [1, 3, 8])
    def test_chunked_bitwise_equals_one_shot(self, axes8, base8, chunk):
        res = t_res.resilient_sweep(axes8, chunk_size=chunk, **CPU)
        assert_bitwise(res, base8, ALL_FIELDS)
        r = res.report
        assert r.n_configs == 8 and r.chunk_size == chunk
        assert r.n_chunks == -(-8 // chunk) == r.chunks_computed
        assert r.chunks_resumed == 0 and not r.quarantined
        # every chunk runs each event slot one of its configurations is
        # live in: a chunked count is at least the one-shot count
        assert res.event_steps >= base8.event_steps
        assert res.device == "cpu"

    def test_default_chunk_is_whole_batch(self, axes8, base8):
        res = t_res.resilient_sweep(axes8, **CPU)
        assert res.report.n_chunks == 1
        assert res.event_steps == base8.event_steps
        assert_bitwise(res, base8, ALL_FIELDS)

    def test_held_to_repro_as_the_sweep_is(self, axes8, ref8):
        """Chunks of 3 against `repro`'s one-shot `sweep`: decisions
        bitwise, float columns rtol 1e-6."""
        res = t_res.resilient_sweep(axes8, chunk_size=3, **CPU)
        for f in DECISIONS:
            a = np.asarray(getattr(ref8, f))
            b = getattr(res, f)
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f)
        for f in FLOATS:
            a, b = np.asarray(getattr(ref8, f)), getattr(res, f)
            assert a.shape == b.shape, f
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)

    def test_cuda_default_raises_without_a_card(self, axes8):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_res.resilient_sweep(axes8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_res.resilient_mc_sweep(mc_axes(t_hier, t_mc), **MC_KW)


# ---------------------------------------------------------------------------
# kill-and-resume
# ---------------------------------------------------------------------------

class TestKillAndResume:
    @pytest.mark.parametrize("crash_after", [0, 1, 2])
    def test_resume_bitwise_after_every_chunk_boundary(
            self, axes8, base8, tmp_path, crash_after):
        ck = str(tmp_path)
        with pytest.raises(t_res.InjectedCrash):
            t_res.resilient_sweep(
                axes8, chunk_size=3, checkpoint_dir=ck,
                fault_plan=t_res.FaultPlan(crash_after=crash_after), **CPU)
        res = t_res.resilient_sweep(axes8, chunk_size=3, checkpoint_dir=ck,
                                    **CPU)
        assert_bitwise(res, base8, ALL_FIELDS)
        assert res.report.chunks_resumed == crash_after + 1
        assert res.report.chunks_computed == 3 - (crash_after + 1)
        if crash_after == 2:
            assert res.event_steps == 0      # nothing left to evaluate

    def test_completed_run_resumes_fully_then_rejects_other_grid(
            self, axes8, base8, tmp_path):
        ck = str(tmp_path)
        t_res.resilient_sweep(axes8, chunk_size=3, checkpoint_dir=ck, **CPU)
        res = t_res.resilient_sweep(axes8, chunk_size=3, checkpoint_dir=ck,
                                    **CPU)
        assert res.report.chunks_resumed == 3
        assert res.report.chunks_computed == 0
        assert_bitwise(res, base8, ALL_FIELDS)
        # another chunk grid, another static, other axes: other runs
        with pytest.raises(t_res.ResumeMismatchError):
            t_res.resilient_sweep(axes8, chunk_size=4, checkpoint_dir=ck,
                                  **CPU)
        with pytest.raises(t_res.ResumeMismatchError):
            t_res.resilient_sweep(axes8, chunk_size=3, checkpoint_dir=ck,
                                  interpret=True, **CPU)
        other = t_sweep.SweepAxes.zip(axes8.designs, axes8.envs,
                                      seeds=[s + 1 for s in axes8.seeds])
        with pytest.raises(t_res.ResumeMismatchError):
            t_res.resilient_sweep(other, chunk_size=3, checkpoint_dir=ck,
                                  **CPU)

    def test_torn_manifest_discards_chunks_and_restarts(
            self, axes8, base8, tmp_path):
        ck = str(tmp_path)
        with pytest.raises(t_res.InjectedCrash):
            t_res.resilient_sweep(axes8, chunk_size=3, checkpoint_dir=ck,
                                  fault_plan=t_res.FaultPlan(crash_after=1),
                                  **CPU)
        raw = (tmp_path / t_res.RUN_MANIFEST).read_text()
        (tmp_path / t_res.RUN_MANIFEST).write_text(raw[:len(raw) // 2])
        res = t_res.resilient_sweep(axes8, chunk_size=3, checkpoint_dir=ck,
                                    **CPU)
        assert res.report.chunks_resumed == 0
        assert res.report.chunks_computed == 3
        assert_bitwise(res, base8, ALL_FIELDS)
        m = json.loads((tmp_path / t_res.RUN_MANIFEST).read_text())
        assert m["fingerprint"] == res.report.fingerprint
        assert m["salt"] == t_res.SALT

    def test_torn_chunk_payload_recomputed(self, axes8, base8, tmp_path):
        ck = str(tmp_path)
        with pytest.raises(t_res.InjectedCrash):
            t_res.resilient_sweep(axes8, chunk_size=3, checkpoint_dir=ck,
                                  fault_plan=t_res.FaultPlan(crash_after=1),
                                  **CPU)
        payload = tmp_path / "step_00000001" / LEAVES
        raw = bytearray(payload.read_bytes())
        raw[-1] ^= 0xFF
        payload.write_bytes(bytes(raw))
        res = t_res.resilient_sweep(axes8, chunk_size=3, checkpoint_dir=ck,
                                    **CPU)
        assert res.report.chunks_resumed == 1      # chunk 0 only
        assert res.report.chunks_computed == 2
        assert_bitwise(res, base8, ALL_FIELDS)


# ---------------------------------------------------------------------------
# fault isolation: the port's reports equal repro's
# ---------------------------------------------------------------------------

# name → (chunk size, FaultPlan keywords, crash-and-resume, quarantined)
FAULTS = {
    "poison": (3, dict(poison=(5,)), False, (5,)),
    "nan": (3, dict(nan=(2,)), False, (2,)),
    "oom": (8, dict(oom={0: 1}), False, ()),
    "transient": (3, dict(fail={1: 2}), False, ()),
    "poison_across_kill": (3, dict(poison=(5,), crash_after=1), True, (5,)),
}


def run_fault(res_mod, fault_mod, axes, case, ck, **kw):
    """One FAULTS case through a package; with a crash, the resumed run."""
    chunk, plan, crash, _ = FAULTS[case]
    no_wait = fault_mod.Backoff(base_s=0.0, max_retries=2)
    go = lambda **more: res_mod.resilient_sweep(   # noqa: E731
        axes, chunk_size=chunk, backoff=no_wait, **kw, **more)
    if not crash:
        return go(fault_plan=res_mod.FaultPlan(**plan))
    with pytest.raises(res_mod.InjectedCrash):
        go(checkpoint_dir=ck, fault_plan=res_mod.FaultPlan(**plan))
    return go(checkpoint_dir=ck)


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_fault_reports_equal_repro(axes8, base8, ref8, tmp_path, case):
    port = run_fault(t_res, t_fault, axes8, case, str(tmp_path / "t"), **CPU)
    ref = run_fault(r_res, r_fault, sweep_axes(r_hier, r_arr, r_sweep),
                    case, str(tmp_path / "r"))
    assert report_of(port.report) == report_of(ref.report)
    q = FAULTS[case][3]
    assert port.report.quarantined_indices() == q
    keep = [i for i in range(8) if i not in q]
    assert_bitwise(port, base8, ALL_FIELDS, rows=keep)
    for f in DECISIONS:
        b = getattr(port, f)[keep]
        a = np.asarray(getattr(ref8, f))[keep]
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f)
    for i in q:
        # the quarantined row carries sentinels in every representation
        assert np.isnan(port.final_deployed_mw[i])
        assert np.isnan(port.deployed_mw[i]).all()
        assert np.isnan(port.placed_fraction[i])
        assert int(port.n_halls_built[i]) == -1
        assert (port.act_month[i] == -1).all()
        assert (port.reg_rows[i] == -1).all()
        assert np.isnan(port.reg_counts[i]).all()
        assert np.isnan(port.total_capex[i])
        assert np.isnan(port.dollars_per_tps[i]).all()
    if case == "poison":
        assert "poisoned" in port.report.quarantined[0].error


def test_real_cuda_oom_counts_as_oom(axes8, base8, monkeypatch):
    """A `torch.cuda.OutOfMemoryError` (a RuntimeError, not a
    MemoryError) from the range evaluator halves the dispatch, and the
    halves' rows are the one-shot's bits."""
    real = t_res._evaluate

    def fits_four(prep, lo, hi, **kw):
        if hi - lo > 4:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(prep, lo, hi, **kw)

    monkeypatch.setattr(t_res, "_evaluate", fits_four)
    res = t_res.resilient_sweep(axes8, chunk_size=8, **CPU)
    assert res.report.oom_halvings == 1 and not res.report.quarantined
    assert res.report.retries == 0
    assert_bitwise(res, base8, ALL_FIELDS)
    assert t_res._is_oom(RuntimeError("CUDA out of memory. Tried to "
                                      "allocate 20.00 MiB"))
    assert t_res._is_oom(t_res.SimulatedOOM("injected"))
    assert not t_res._is_oom(RuntimeError("CUDA error: an illegal memory "
                                          "access was encountered"))


def test_kernel_build_failure_raises_before_any_chunk(axes8, monkeypatch):
    """A missing `nvcc` surfaces as itself, never as every configuration
    quarantined with reason "crash"."""
    def no_nvcc():
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source on the machine with the card")

    evaluated = []
    monkeypatch.setattr(t_res, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(t_dispatch.SCORE_LIBRARY, "library", no_nvcc)
    monkeypatch.setattr(t_res, "_evaluate",
                        lambda *a, **k: evaluated.append(a))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        t_res.resilient_sweep(axes8, chunk_size=3)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        t_res.resilient_mc_sweep(mc_axes(t_hier, t_mc), **MC_KW)
    assert not evaluated


# ---------------------------------------------------------------------------
# input validation: the catalog, through the resilient front door
# ---------------------------------------------------------------------------

def _bad_design(hier, **kw):
    return dataclasses.replace(hier.get_design("4N/3"), **kw)


def _bad_env(arr, **kw):
    return arr.EnvelopeSpec(**kw)


# name → (build the axes for (hier, arr, sweep module), offending field)
BAD_AXES = {
    "policy_id": (lambda h, a, s: s.SweepAxes.zip(
        designs=[h.get_design("4N/3")],
        envs=[a.EnvelopeSpec(demand_scale=SCALE)], policies=[99]),
        "policies"),
    "empty": (lambda h, a, s: s.SweepAxes.zip(designs=[], envs=[]),
              "designs"),
    "zero_rows": (lambda h, a, s: s.SweepAxes.zip(
        designs=[_bad_design(h, ld_rows=0, hd_rows=0)],
        envs=[a.EnvelopeSpec(demand_scale=SCALE)]), None),
    "horizon": (lambda h, a, s: s.SweepAxes.zip(
        designs=[h.get_design("4N/3")],
        envs=[_bad_env(a, start_year=2030, end_year=2028)]), None),
    "pod_racks": (lambda h, a, s: s.SweepAxes.zip(
        designs=[h.get_design("4N/3")],
        envs=[_bad_env(a, pod_racks=t_pl.MAX_POD_RACKS + 1)]), "pod_racks"),
    "demand_scale": (lambda h, a, s: s.SweepAxes.zip(
        designs=[h.get_design("4N/3")],
        envs=[_bad_env(a, demand_scale=0.0)]), "demand_scale"),
    "mixed_horizons": (lambda h, a, s: s.SweepAxes.zip(
        designs=[h.get_design("4N/3")] * 2,
        envs=[a.EnvelopeSpec(demand_scale=SCALE, end_year=2028),
              a.EnvelopeSpec(demand_scale=SCALE, end_year=2029)]), "envs"),
}


@pytest.mark.parametrize("case", sorted(BAD_AXES))
def test_validation_catalog_through_resilient_sweep(case):
    """Every bad grid dies before any device work with `repro`'s error
    class and field, from `sweep` and from `resilient_sweep` alike."""
    build, field = BAD_AXES[case]
    with pytest.raises(r_hier.SweepValidationError) as want:
        r_res.resilient_sweep(build(r_hier, r_arr, r_sweep))
    for run in (t_sweep.sweep, t_res.resilient_sweep):
        with pytest.raises(SweepValidationError) as got:
            run(build(t_hier, t_arr, t_sweep), **CPU)
        assert got.value.field == want.value.field
        if field is not None:
            assert got.value.field == field
    assert issubclass(SweepValidationError, ValueError)


def test_zip_length_mismatch_names_offending_field():
    with pytest.raises(SweepValidationError) as e:
        t_sweep.SweepAxes.zip(designs=[t_hier.get_design("4N/3")] * 3,
                              envs=[t_arr.EnvelopeSpec()] * 2)
    assert e.value.field == "envs"
    with pytest.raises(SweepValidationError) as e:
        t_mc.MCAxes.zip(designs=[t_hier.get_design("4N/3")] * 3,
                        seeds=[1, 2])
    assert e.value.field == "seeds"
    bad = t_mc.MCAxes.zip(designs=[t_hier.get_design("4N/3")],
                          sku_kw=[-1.0])
    with pytest.raises(SweepValidationError) as e:
        t_res.resilient_mc_sweep(bad, **MC_KW, **CPU)
    assert e.value.field == "sku_kw"


# ---------------------------------------------------------------------------
# resilient_mc_sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mc_axes3():
    return mc_axes(t_hier, t_mc)


@pytest.fixture(scope="module")
def mc_base3(mc_axes3):
    return t_mc.mc_sweep(mc_axes3, **MC_KW, **CPU)


class TestMCResilience:
    def test_chunked_bitwise_equals_one_shot(self, mc_axes3, mc_base3):
        res = t_res.resilient_mc_sweep(mc_axes3, chunk_size=2, **MC_KW,
                                       **CPU)
        assert_bitwise(res, mc_base3, MC_FIELDS)
        assert res.report.n_chunks == 2 and not res.report.quarantined
        assert res.event_steps >= mc_base3.event_steps

    def test_kill_and_resume_bitwise(self, mc_axes3, mc_base3, tmp_path):
        ck = str(tmp_path)
        with pytest.raises(t_res.InjectedCrash):
            t_res.resilient_mc_sweep(
                mc_axes3, chunk_size=2, checkpoint_dir=ck,
                fault_plan=t_res.FaultPlan(crash_after=0), **MC_KW, **CPU)
        res = t_res.resilient_mc_sweep(mc_axes3, chunk_size=2,
                                       checkpoint_dir=ck, **MC_KW, **CPU)
        assert res.report.chunks_resumed == 1
        assert res.report.chunks_computed == 1
        assert_bitwise(res, mc_base3, MC_FIELDS)

    def test_poisoned_config_isolated_as_repro(self, mc_axes3, mc_base3):
        port = t_res.resilient_mc_sweep(
            mc_axes3, chunk_size=2, fault_plan=t_res.FaultPlan(poison=(1,)),
            backoff=t_fault.Backoff(base_s=0.0, max_retries=2), **MC_KW,
            **CPU)
        ref = r_res.resilient_mc_sweep(
            mc_axes(r_hier, r_mc), chunk_size=2,
            fault_plan=r_res.FaultPlan(poison=(1,)),
            backoff=r_fault.Backoff(base_s=0.0, max_retries=2), **MC_KW)
        assert report_of(port.report) == report_of(ref.report)
        assert port.report.quarantined_indices() == (1,)
        assert_bitwise(port, mc_base3, MC_FIELDS, rows=[0, 2])
        for f in ("placed_a", "placed_b", "saturated"):
            np.testing.assert_array_equal(
                getattr(port, f)[[0, 2]], np.asarray(getattr(ref, f))[[0, 2]],
                err_msg=f)
        np.testing.assert_allclose(port.deployed_kw[[0, 2]],
                                   np.asarray(ref.deployed_kw)[[0, 2]],
                                   rtol=1e-6, atol=1e-5)
        assert np.isnan(port.deployed_kw[1]).all()
        assert np.isnan(port.ha_capacity_kw[1])
        assert not port.saturated[1].any()
        assert (port.rows_a[1] == -1).all()

    def test_pod_mc_width_one_chunks_bitwise(self):
        """Pods of 5 on the split-pods path, one configuration per chunk:
        each chunk keeps the whole batch's windows and scan lengths."""
        axes = t_mc.MCAxes.zip(designs=[t_hier.get_design("10N/8"),
                                        t_hier.get_design("3+1")],
                               seeds=[11, 12])
        kw = dict(n_trials=2, n_events=100, year=2030, scenario="high",
                  pod_racks=5)
        base = t_mc.mc_sweep(axes, **kw, **CPU)
        res = t_res.resilient_mc_sweep(axes, chunk_size=1, **kw, **CPU)
        assert_bitwise(res, base, MC_FIELDS)
        assert res.report.n_chunks == 2 and base.pod_steps > 0
        assert (base.counts_a.sum(-1) > 1).any()

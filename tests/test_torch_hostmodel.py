"""Parity of the port's host-side model with `repro`: resources,
projections, hierarchy, fleet traces, cost and throughput.

Topology arrays, traces and demand vectors are numpy/float32 work that the
port repeats operation for operation, so they are held bitwise (byte for
byte).  The throughput evaluators run jitted in `repro`, where XLA may
contract `a*b + c` into one FMA and sums 256 decode terms in its own
order; the port's numpy float32 evaluation is held to rtol 1e-6.
"""
import os
import subprocess
import sys
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (arrivals as r_arr, cost as r_cost,  # noqa: E402
                        hierarchy as r_hier, projections as r_proj,
                        resources as r_res, throughput as r_tp)
from repro_torch.core import (arrivals as t_arr, cost as t_cost,  # noqa: E402
                              hierarchy as t_hier, projections as t_proj,
                              resources as t_res, throughput as t_tp)

REPO = pathlib.Path(__file__).resolve().parents[1]
DESIGNS = ("4N/3", "3+1", "10N/8", "8+2")
TOPO_FIELDS = ("row_cap", "row_feeds", "row_nfeeds", "row_is_hd",
               "row_domain", "row_hall", "lineup_cap", "lineup_is_active",
               "lineup_hall", "hall_liq_cap")


def same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.core.sweep, repro_torch.convert, "
            "repro_torch.kernels.placement_score.ops, "
            "repro_torch.core.scenarios, repro_torch.core.payoff, "
            "repro_torch.core.calibration, repro_torch.sharding.ranks, "
            "repro_torch.train.step, repro_torch.train.pipeline, "
            "repro_torch.runtime.elastic, repro_torch.launch.mesh, "
            "repro_torch.optim.compression, repro_torch.models.api; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("name", DESIGNS)
@pytest.mark.parametrize("halls,rows,lineups", [(1, None, None),
                                                (3, None, None),
                                                (4, 100, 10)])
def test_topology_byte_identical(name, halls, rows, lineups):
    a = r_hier.build_topology(r_hier.get_design(name), halls,
                              rows_per_hall=rows, lineups_per_hall=lineups)
    b = t_hier.build_topology(t_hier.get_design(name), halls,
                              rows_per_hall=rows, lineups_per_hall=lineups)
    for f in TOPO_FIELDS:
        assert same_bytes(getattr(a, f), getattr(b, f)), f
    assert (a.ha_frac, a.is_block, a.n_hd_rows) == \
        (b.ha_frac, b.is_block, b.n_hd_rows)


@pytest.mark.parametrize("kw", [
    dict(demand_scale=0.01),
    dict(demand_scale=0.02, gpu_scenario="high", la_fraction=0.3),
    dict(demand_scale=0.01, gpu_scenario="low", quantum_racks=4,
         shock_month=30, shock_multiplier=1.6, shock_ramp_months=6),
    dict(demand_scale=0.01, cohort_window_m=6, refresh_cycle_m=24,
         mix_end=(0.8, 0.15, 0.05)),
    dict(demand_scale=0.01, pod_racks=4),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_fleet_trace_byte_identical(kw, seed):
    a = r_arr.generate_fleet_trace(r_arr.EnvelopeSpec(**kw), seed)
    b = t_arr.generate_fleet_trace(t_arr.EnvelopeSpec(**kw), seed)
    for f in r_arr.Trace.__dataclass_fields__:
        assert same_bytes(getattr(a, f), getattr(b, f)), f


def test_rack_demand_bitwise():
    rng = np.random.default_rng(3)
    kw = (rng.random(4096) * 1500).astype(np.float32)
    gpu = rng.random(4096) < 0.5
    a = np.asarray(r_res.rack_demand(kw, gpu))
    b = t_res.rack_demand(torch.from_numpy(kw), torch.from_numpy(gpu))
    assert same_bytes(a, b.numpy())


def test_projections_equal():
    for year in range(2024, 2037):
        for s in r_proj.SCENARIOS:
            for pod in (False, True):
                assert r_proj.gpu_rack_kw(year, s, pod) == \
                    t_proj.gpu_rack_kw(year, s, pod)
            assert r_proj.compute_rack_kw(year, s) == \
                t_proj.compute_rack_kw(year, s)
            assert r_proj.storage_rack_kw(year, s) == \
                t_proj.storage_rack_kw(year, s)
        for line in ("oberon", "kyber"):
            assert r_proj.pkg_perf(year, line) == t_proj.pkg_perf(year, line)


@pytest.mark.parametrize("name", DESIGNS)
def test_cost_equal(name):
    a, b = r_hier.get_design(name), t_hier.get_design(name)
    assert r_cost.initial_dollars_per_mw(a) == t_cost.initial_dollars_per_mw(b)
    assert r_cost.reserve_cost_per_mw(a) == t_cost.reserve_cost_per_mw(b)
    assert r_cost.effective_dollars_per_mw(a, 7, 31.5) == \
        t_cost.effective_dollars_per_mw(b, 7, 31.5)
    assert np.isnan(t_cost.effective_dollars_per_mw(b, 3, 0.0))


@pytest.mark.parametrize("mode", ["additive", "min"])
def test_tps_per_watt_grid_rtol(mode):
    deps_r = [r_tp.serving_deployment(y, s, p)
              for y in (2026, 2030, 2034) for s in ("low", "high")
              for p in (1, 4)]
    deps_t = [t_tp.serving_deployment(y, s, p)
              for y in (2026, 2030, 2034) for s in ("low", "high")
              for p in (1, 4)]
    a = np.asarray(r_tp.tps_per_watt_grid(r_tp.MODEL_SUITE, deps_r,
                                          mode=mode))
    b = t_tp.tps_per_watt_grid(t_tp.MODEL_SUITE, deps_t, mode=mode)
    assert b.dtype == np.float32 and b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=1e-6)


@pytest.mark.parametrize("bad,field", [
    (dict(n_active=5), "n_active"),
    (dict(lineup_kw=0.0), "lineup_kw"),
    (dict(hd_feeds=5), "hd_feeds"),
    (dict(ld_rows=0, hd_rows=0), "ld_rows"),
])
def test_design_validation_matches(bad, field):
    import dataclasses
    with pytest.raises(r_hier.SweepValidationError) as ra:
        dataclasses.replace(r_hier.get_design("4N/3"), **bad).validate()
    with pytest.raises(t_hier.SweepValidationError) as ta:
        dataclasses.replace(t_hier.get_design("4N/3"), **bad).validate()
    assert ra.value.field == ta.value.field == field
    assert str(ra.value) == str(ta.value)

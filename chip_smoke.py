#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the checkout, holds it against its
plain PyTorch version, checks a small sweep on the card against the same
sweep on the CPU, then drives the main path: the `fleet_study` grid (the
four reference designs × low/med/high GPU TDP scenarios, 12
configurations at demand_scale 0.1, policy var_min) through
`repro_torch.core.sweep.sweep` on the card.  It fails, and prints no
result, without a CUDA device or without the port beside it.  The last
line of its output is a JSON object naming the device; the line before
it names the card and its power limit as `nvidia-smi` gives them, and
one line before that lists each kernel with its launches, error, times
and bound.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 outside tensor cores
MAIN_SCALE = 0.1
GOLDEN_SCALE = 0.005


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Wall time per call from CUDA events around `reps` back-to-back
    calls, after a warm-up: host gaps between launches included."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_activity(prof):
    """(busy seconds, {name: [calls, seconds]}) of the kernels and copies a
    profile saw on the card, read from the raw trace events: building the
    profiler's per-op tables for a whole sweep would take minutes."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            entry = by_name.setdefault(e.name(), [0, 0.0])
            entry[0] += 1
            entry[1] += e.duration_ns() / 1e9
    return sum(s for _, s in by_name.values()), by_name


def device_time_ms(fn, reps):
    """Device time per call: the kernels (and copies) that `reps` calls
    put on the card, summed by the profiler, after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_activity(prof)[0] * 1e3 / reps


def fleet_axes(scale, scenarios=("low", "med", "high")):
    from repro_torch.core import hierarchy
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.sweep import SweepAxes
    names = ("4N/3", "3+1", "10N/8", "8+2")
    combos = [(s, n) for s in scenarios for n in names]
    axes = SweepAxes.zip(
        designs=[hierarchy.get_design(n) for _, n in combos],
        envs=[EnvelopeSpec(demand_scale=scale, gpu_scenario=s)
              for s, _ in combos])
    return axes, combos


def kernel_inputs(dev, seed=0):
    """Inputs at the main path's shapes: its padded 12-configuration
    topology, random loads around the line-up ratings, plus rows placed
    exactly on the `+1e-4` slack and rows without feeds."""
    import numpy as np
    import torch
    from repro_torch.core.sweep import _prepare
    axes, _ = fleet_axes(MAIN_SCALE)
    jt = _prepare(axes, 0, None, dev)[0]
    N, R, _ = jt.row_cap.shape
    X = jt.lineup_cap.shape[1]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    cap = jt.lineup_cap.cpu().numpy()
    lineup_tot = (cap * rng.uniform(0, 1.05, (N, X))).astype(f32)
    lineup_ha = (lineup_tot * rng.uniform(0, 1, (N, X))).astype(f32)
    row_cap = jt.row_cap.cpu().numpy()
    row_load = (row_cap * rng.uniform(0, 1.05, row_cap.shape)).astype(f32)
    p_dep = rng.choice([30.0, 200.0, 420.0, 1000.0, 2400.0], N).astype(f32)
    is_ha = rng.random(N) < 0.7
    # rows on the slack: row power load so that load + P == cap + 1e-4
    on_edge = rng.random((N, R)) < 0.05
    edge = (row_cap[..., 0] + f32(1e-4)) - p_dep[:, None]
    row_load[..., 0] = np.where(on_edge, edge, row_load[..., 0])
    # line-ups on the slack for the block check: tot + P == cap + 1e-4
    lu_edge = rng.random((N, X)) < 0.05
    lineup_tot = np.where(lu_edge, (cap + f32(1e-4)) - p_dep[:, None],
                          lineup_tot).astype(f32)
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                      device=dev)
    return (jt.row_feeds, jt.row_nfeeds, jt.row_cap,
            t(row_load, torch.float32), t(lineup_ha, torch.float32),
            t(lineup_tot, torch.float32), jt.lineup_cap,
            t(p_dep, torch.float32), jt.ha_frac, t(is_ha, torch.bool),
            jt.is_block)


def check_kernel(dev):
    import torch
    from repro_torch.kernels.placement_score import kernel as ker
    from repro_torch.kernels.placement_score.ops import score_rows
    from repro_torch.kernels.placement_score.ref import reference_score
    args = kernel_inputs(dev)
    feas_k, score_k = score_rows(*args)
    feas_p, score_p = score_rows(*args, interpret=True)
    torch.cuda.synchronize()
    if not torch.equal(feas_k, feas_p):
        raise AssertionError(
            f"placement_score: feas differs at "
            f"{int((feas_k != feas_p).sum())} rows")
    if not torch.equal(score_k[feas_p], score_p[feas_p]):
        raise AssertionError("placement_score: scores differ at feasible rows")
    if not torch.equal(score_k, score_p):
        raise AssertionError("placement_score: BIG mask differs")
    err = (score_k[feas_p] - score_p[feas_p]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    N, R, _ = args[0].shape
    X = args[4].shape[1]
    ms = device_time_ms(lambda: ker.placement_score(*args), 200)
    plain_ms = device_time_ms(lambda: reference_score(*args), 50)
    wall_ms = cuda_time_ms(lambda: ker.placement_score(*args), 200)
    wall_plain_ms = cuda_time_ms(lambda: reference_score(*args), 50)
    # each input read once, each output written once: feeds (16 B), feed
    # count, row power cap and load (4 B each) per row; three [N, X]
    # line-up arrays; four per-configuration scalars; feas (1 B) and
    # score (4 B) per row
    n_bytes = N * R * (16 + 4 + 4 + 4) + 3 * N * X * 4 + N * 10 + N * R * 5
    # per row: 2 divisions and a subtraction, per feed 14 arithmetic and
    # compare operations, 3 adds and 2 compares after the loop
    n_flop = N * R * (3 + 4 * 14 + 5)
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S)
    by = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_flop / FP32_FLOP_PER_S \
        else "operations"
    print(f"kernel check: placement_score at {N}x{R} rows, {X} line-ups per "
          f"configuration, {int(feas_p.sum())} feasible: feas bitwise, "
          f"scores bitwise (max abs err {max_err}); device time per call "
          f"kernel {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, bound "
          f"{bound_s * 1e6:.3f} us ({by}: {n_bytes} B, {n_flop} flop); "
          f"back-to-back wall per call (host gaps included) kernel "
          f"{wall_ms * 1e3:.3f} us, plain {wall_plain_ms * 1e3:.3f} us")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=by)


SWEEP_FIELDS = ("halls_active", "deployed_mw", "p50_stranding",
                "p90_stranding", "final_hall_stranding",
                "final_lineup_stranding", "n_halls_built",
                "final_deployed_mw", "placed_fraction", "effective_dpm",
                "delivered_tps", "act_month", "reg_rows")


def assert_same(a, b, what):
    import numpy as np
    for f in SWEEP_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"{what}: `{f}` differs")
    if a.event_steps != b.event_steps:
        raise AssertionError(f"{what}: event steps differ")


def check_result(res, n_configs):
    """Shapes, finiteness and the ranges the metrics live in."""
    import numpy as np
    M = len(res.months)
    for f in SWEEP_FIELDS:
        x = np.asarray(getattr(res, f), dtype=float)
        if x.shape[0] != n_configs:
            raise AssertionError(f"sweep output `{f}` has shape {x.shape}")
        if not np.all(np.isfinite(x)):
            raise AssertionError(f"sweep output `{f}` is not finite")
    for f in ("halls_active", "deployed_mw", "p50_stranding",
              "p90_stranding"):
        if getattr(res, f).shape != (n_configs, M):
            raise AssertionError(f"`{f}` is not [configurations, months]")
    for f in ("p50_stranding", "p90_stranding", "placed_fraction"):
        x = getattr(res, f)
        if not np.all((x >= 0) & (x <= 1)):
            raise AssertionError(f"`{f}` outside [0, 1]")
    if not np.all(res.p50_stranding <= res.p90_stranding):
        raise AssertionError("p50 stranding above p90")
    if not np.all(np.diff(res.halls_active, axis=1) >= 0):
        raise AssertionError("halls closed during the lifecycle")


def golden(dev):
    from repro_torch.core.sweep import sweep
    from repro_torch.core import hierarchy
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.sweep import SweepAxes
    axes = SweepAxes.zip(
        designs=[hierarchy.get_design("4N/3"), hierarchy.get_design("8+2")],
        envs=[EnvelopeSpec(demand_scale=GOLDEN_SCALE, gpu_scenario="high")],
        policies=[3, 2], seeds=[3, 4])
    t0 = time.perf_counter()
    on_cpu = sweep(axes, device="cpu")
    t1 = time.perf_counter()
    on_card = sweep(axes, device=dev)
    t2 = time.perf_counter()
    assert_same(on_cpu, on_card, "golden (CPU vs card)")
    check_result(on_card, len(axes))
    print(f"golden: 2 configurations at scale {GOLDEN_SCALE}, "
          f"{on_card.event_steps} event steps: CPU {t1 - t0:.2f} s, card "
          f"{t2 - t1:.2f} s; decisions and outputs bitwise equal; halls "
          f"{list(on_card.n_halls_built)}, p90 "
          f"{[float(v) for v in on_card.p90_stranding[:, -1]]}")


def profile_main_path(axes, dev):
    """One run of the main path under the profiler (card activity only):
    wall seconds, device busy seconds, the number of kernels and copies,
    and the ten that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sweep import sweep
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(axes, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = device_activity(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return wall, busy, sum(c for c, _ in by_name.values()), top


def main_path(dev):
    import torch
    from repro_torch.core.sweep import sweep
    from repro_torch.kernels.placement_score.kernel import placement_score
    axes, combos = fleet_axes(MAIN_SCALE)
    t0 = time.perf_counter()
    sweep(axes, device=dev)
    print(f"main path warm-up: {time.perf_counter() - t0:.2f} s wall")

    runs, walls, launches = [], [], []
    for _ in range(2):
        placement_score.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep(axes, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(placement_score.launches)
        runs.append(res)
        if launches[-1] != res.event_steps:
            raise AssertionError(f"{launches[-1]} placement_score launches "
                                 f"for {res.event_steps} event steps")
    assert_same(runs[0], runs[1], "main path repeat")
    check_result(runs[0], len(axes))

    placement_score.launches = 0
    t0 = time.perf_counter()
    plain = sweep(axes, device=dev, interpret=True)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if placement_score.launches != 0:
        raise AssertionError("interpret=True launched the kernel")
    assert_same(runs[0], plain, "main path kernel vs interpret=True")

    res = runs[0]
    print(f"{'design':8s} {'tdp':5s} {'halls':>6s} {'deployed':>9s} "
          f"{'P90str':>7s} {'init$/MW':>9s} {'eff$/MW':>9s} {'gap':>6s}")
    for i, (scenario, name) in enumerate(combos):
        gap = res.effective_dpm[i] / res.initial_dpm[i] - 1
        print(f"{name:8s} {scenario:5s} {res.n_halls_built[i]:6d} "
              f"{res.final_deployed_mw[i]:8.0f}M "
              f"{res.p90_stranding[i, -1]:6.1%} "
              f"{res.initial_dpm[i] / 1e6:8.2f}M "
              f"{res.effective_dpm[i] / 1e6:8.2f}M {gap:6.1%}")
    steps = res.event_steps
    print(f"main path: {len(axes)} configurations at scale {MAIN_SCALE} on "
          f"{res.device}, {steps} event steps; wall per run "
          f"{walls[0]:.3f} s, {walls[1]:.3f} s ("
          f"{walls[0] / steps * 1e3:.3f}, {walls[1] / steps * 1e3:.3f} ms "
          f"per event step); repeats bitwise equal; equal to "
          f"interpret=True ({plain_wall:.3f} s wall with the plain version); "
          f"launches {{'placement_score': {launches[0]}}}")
    wall, busy, n_device, top = profile_main_path(axes, dev)
    for name, (calls, secs) in top:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {name[:90]}")
    print(f"main path profiled (card activity): {wall:.3f} s wall, device "
          f"busy {busy:.3f} s, idle share {1 - busy / wall:.3f}, "
          f"{n_device} kernels and copies ({n_device / steps:.1f} per event "
          f"step)")
    return launches[0]


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels.placement_score import kernel as ker
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    timings = {}

    t0 = time.perf_counter()
    ker.build()
    timings["build"] = time.perf_counter() - t0
    info = ker.build_info
    print(f"build: placement_score in {info['seconds']:.2f} s "
          f"({'cached' if info['cached'] else 'nvcc'}); "
          + " | ".join(line.strip() for line in info["log"].splitlines()
                       if "registers" in line or "spill" in line))

    t0 = time.perf_counter()
    stats = check_kernel(dev)
    timings["kernel check"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    golden(dev)
    timings["golden"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    launches = main_path(dev)
    timings["main path"] = time.perf_counter() - t0
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in timings.items()))

    print(json.dumps({"kernels": [dict(
        name="placement_score", route="cuda",
        source="src/repro_torch/csrc/placement_score.cu",
        replaces="src/repro/kernels/placement_score/kernel.py:73",
        launches=launches, library_ms=None, **stats)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

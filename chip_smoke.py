#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (one `nvcc` per source,
in parallel) and holds each against its plain PyTorch version at the
shapes its main path gives it.  Then it drives the port's main paths on
the card, each with the kernel launch counts set to 0 just before it and
read just after:

* the fleet sweep: a small sweep on the card against the same sweep on
  the CPU, under var_min/min_waste and under the random policy, then the
  `fleet_study` grid (the four reference designs × low/med/high GPU TDP
  scenarios, 12 configurations at demand_scale 0.1, policy var_min)
  through `repro_torch.core.sweep.sweep`; it launches `placement_score`
  once per event step;
* the single-hall Monte Carlo: the random policy's Threefry keys and
  draws at the figures' shapes and a small `mc_sweep` grid (all four
  policies), each on the card against the CPU, then Figs. 6, 5 and 7 of
  `benchmarks/run.py` at their own arguments through
  `repro_torch.core.mc_sweep.mc_sweep`, each held to its interpret=True
  run; they launch `placement_score` once per event step, and print the
  figures' numbers;
* multi-row GPU pods: the kernel at the HD-compacted pod views; a pod
  fleet golden (four policies) card against CPU, split and legacy; Fig.
  17's pod group (10N/8 and 8+2 x pods of 3, 5 and 7, HIGH, scale 0.04)
  through `sweep` with exact and with streaming quantiles (one launch
  per cluster and per pod rack); `pod_sweep_speedup`'s and
  `mc_pod_speedup`'s grids, split against `legacy_pod_cond=True`;
* the metric stage: the streaming histogram's NaN cases (F5) card
  against CPU; `scenario_frontier` with one envelope per family, card
  against CPU on every field; then `benchmarks/run.py`'s
  `scenario_sweep` (3+1, baseline + the four families at their catalog
  defaults, 15 configurations at scale 0.02, half run.py's), Fig. 18
  through `pod_payoff_study` (10N/8 and 8+2 x four models, pods of 1 and
  5, scale 0.02) and `metric_stack`'s `design_frontier` (four designs x
  pods of 1 and 5, scale 0.01), each through `sweep` with one
  `placement_score` launch per placement step; Fig. 18 and the frontier
  then run once more on the CPU, every point field equal to the card's,
  and the kernel is checked at each of their grids' rows and pod views;
  Table 2 through the per-pair throughput API (host math);
* resilient execution: `resilient_sweep`'s fault cases (poison, NaN
  output, transient failures, injected OOM, a quarantine across a kill,
  chunks of 1) on tests/test_resilience.py's grid, each report equal to
  the CPU's and the surviving rows bitwise the card's one-shot `sweep`;
  `resilience_resume`'s 1024 configurations in chunks of 256, crashed
  after chunk 2 and resumed, bitwise the one-shot `sweep`;
  `resilience_overhead`'s legs at 256 configurations (512 in
  `benchmarks/run.py`) in chunks of 128 with checkpointing off and on,
  bitwise; a real CUDA OOM under a capped
  allocator, halved without quarantine; Fig. 6 through
  `resilient_mc_sweep` in chunks of 16 configurations, crashed and
  resumed, bitwise `mc_sweep`; `placement_score` runs once per placement
  step of every chunk, retry and bisection range;
* the sharded engines: the kernel at giant_grid's 512 x 720 chunk;
  `benchmarks/run.py`'s giant_grid at half its size, 5 x 10^3
  configurations in chunks of 512 with streaming quantiles through
  `sharded_sweep` over every visible card (launches equal to the
  summed steps, the first 1024 rows bitwise a one-shot `sweep`, the
  first 16 configurations' p50/p90 within one bucket of an exact
  `sweep`, peak allocated memory within 10% of a 512-configuration
  run's, the exact/streaming peak at the 128-hall probe printed); then
  `sharded_sweep` over two slabs of card 0 (every card too, when there
  are several) on the fleet_study grid at scale 0.01, at mesh shapes
  (2, 1) and (1, 2) and in chunks of 5, and `sharded_mc_sweep` on Fig.
  5's grid flat and on a (1, 2) mesh with a trial remainder, each
  bitwise `sweep` / `mc_sweep`;
* Mamba2-2.7B serving: `smoke_config()` served on the CPU and on the card
  (float32), then the full-width model (d_model 2560, 32 of its 64
  layers, bf16 weights drawn from a generator seeded with 0) behind
  `ServeEngine`
  with 4 slots, 8 requests of 1024 prompt tokens and 32 new tokens each;
  it launches `ssd_scan` once per layer per prefill, on the tensor cores
  (bf16); its logits and tokens are held to the interpret=True run's
  within the reach of the same run with the kernel's plain version
  (SERVE_GAP_FACTOR);
* Qwen3-1.7B scoring: `smoke_config()` scored on the CPU and on the card
  (float32), then `Model.loss` at full width (28 layers, d_model 2048,
  bf16 weights drawn from a generator seeded with 0) on 4 × 4096 tokens
  under `torch.inference_mode()`; it launches `flash_attention` once per
  layer per call;
* Qwen3-1.7B serving: the smoke golden, then the full-width model (14 of
  its 28 layers) behind `ServeEngine` with Mamba2's traffic; its
  prefill and decode use the
  plain attention, as the reference's do, and launch no kernel;
* granite-moe-1b-a400m serving: the smoke golden, with its CPU-vs-card
  gap taken apart by stage and held below what one wrong route moves,
  then the full-width model (d_model 1024, 32 experts, top-8, 12 of
  its 24 layers, bf16 weights drawn from a generator seeded with 0) behind
  `ServeEngine` with the same traffic; its MoE router launches
  `gating_topk` once per layer per prefill and per decode step, and a
  run with the plain router (use_flash_kernel=False) must give the same
  tokens;
* training, with every kernel's launch count held at 0 (the reference
  trains with its kernels off): three train steps (accum 1, accum 2, the
  error-feedback compressor) of each smoke family in float32 on the card
  against the CPU, remat "full" against "none" on the card, and the
  step raising with use_flash_kernel=True; `launch.train.main` at the
  smoke size, 6 steps then `--resume` to 9, against an uninterrupted
  9-step run; qwen3-1.7b at full width and 2 layers, one float32 step on
  the card against the CPU's loss and gradient norm; then Qwen3-1.7B at
  full width and depth (2,031,739,904 bf16 parameters, remat "full")
  through `build_trainer`,
  10 steps of 8 x 256 tokens from `TokenPipeline` at lr 3e-3, with the
  losses, ms per step, tokens/s, peak memory and a profiled step;
* training over several ranks (`dp_train_path`, one process per rank
  through `repro_torch.sharding.ranks.spawn_ranks`): the same
  Qwen3-1.7B at 7 of its layers and global batch, 2 data-parallel
  steps under
  `pure_dp_rules(False)` with ZeRO-1 moments, over two gloo ranks
  sharing card 0 and, where several cards are visible, one NCCL rank
  per card; ms per step, tokens/s, peak memory per rank, rank 0's idle
  share, the first step's loss against the one-process step on the same
  global batch, every rank's parameters bitwise equal; then, at smoke
  size on the same ranks, `compressed_psum` card against CPU (bitwise),
  a pipeline of one stage per rank against the sequential stack, and
  `reshard` onto one survivor (bitwise);
* tensor and expert parallelism over "model" (`tp_train_path`, the same
  rank sets on a (1, W/2, 2) mesh, `base_rules(False)` with ZeRO-1
  moments, each rank holding its blocks): Qwen3-1.7B at full width and
  4 layers, bf16, 2 steps of the same global batch, and granite-moe at
  full width and 4 layers, float64, 2 steps; first a scoring call with flash on each
  rank's heads (flash once per layer per rank, gating_topk once per MoE
  layer), then the steps; ms per step, rank 0's idle share, peak per
  rank against the one-process step's, the collectives' bytes per step,
  the first step's loss and gradient norm and the parameters after it
  against the one-process step on the same rows, replicated leaves
  bitwise equal across ranks; then, at smoke size, `fsdp_rules` and the
  K/V-head fallback, card ranks against CPU ranks; and flash alone at a
  rank's shape (H 8, Hk 4, B 4, S 4096) beside SDPA;
* serving over a model mesh (`tp_serve_path`, the same rank sets and
  mesh): Mamba2-2.7B at full width and 16 layers under `base_rules`
  (ssd_scan once per layer per prefill on each rank's 40 of 80 heads),
  Qwen3-1.7B at 7 layers under `decode_32k`'s layout (the KV cache's
  positions split over "model", decode's partial softmaxes merged) and
  granite-moe at 4 layers under `base_rules` (gating_topk once per layer
  per prefill and step on the gathered router logits), bf16, each a
  prefill of 4 x ~1024 tokens and 16-32 decode steps of the one-process
  run's greedy tokens: prefill ms, decode ms a step, rank 0's idle
  share, the collectives' bytes per prefill and step, peak per rank
  against one process, the logits' and gathered caches' gaps against
  the one-process run within 4x its own distance from float32
  arithmetic, the logits and replicated caches bitwise across ranks;
  Mamba2's mixer trained over the ranks (8 layers, float32, its
  gradients per leaf against one process's); at smoke size, Jamba and
  the uneven-heads Mamba2, card ranks against CPU ranks; ssd_scan and
  gating_topk at a rank's shapes against their plain versions;
* the second wide model axis (`sp_serve_path`, four gloo ranks on card
  0, and one NCCL rank per card where four or more are visible, on a
  (1, W/2, 2) mesh under `sequence_parallel_rules(False)`, long_500k's
  layout: heads and SSM mixers over "data", the residual, MLP, experts,
  vocabulary and KV positions over "model", batch 1): Mamba2-2.7B at
  full width and 32 layers (a 1 x 1024 prompt, 32 decode steps;
  ssd_scan once per layer per prefill on each rank's 40 of 80 heads),
  bf16, and Jamba's period at full width with d_ff 1024, float32 (a
  1 x 1024 prefill into a cache of 524288 positions, then 16 decode
  steps from position 262136 on a drawn cache, crossing into "model"
  rank 1's slice; ssd_scan once per Mamba layer per prefill,
  gating_topk once per MoE layer per prefill and step; its routers take
  the one-process run's expert ids, each rank's own ids gated to agree
  at 99% of the rows), against the one-process run fed the same tokens
  and caches, gated as `tp_serve_path` (a float32 run's own distance
  from float32 arithmetic is 0: its bound is the floor, 1e-3 of the
  largest logit);
  at smoke size, card ranks against CPU ranks, Jamba on (1, 1, W) and
  (1, W/2, 2), Jamba under `fsdp_rules` over the rules, qwen3 with 3
  K/V heads, the uneven-heads Mamba2, and qwen3's scoring loss with
  flash on a "data" rank's heads; ssd_scan at a "data" rank's Mamba2
  shape (bf16) and Jamba's (float32, as its run) and gating_topk at E 16
  top-2 against their plain versions;
* the model zoo, each configuration at its published widths with bf16
  weights drawn from a generator seeded with 0: the smoke goldens of
  qwen3-14b, phi4-mini-3.8b, nemotron-4-15b, moonshot-v1-16b-a3b and
  jamba-1.5-large-398b (serving tokens and logits, and the scoring loss
  with its launches, card against CPU); flash_attention at their GQA
  groups (H/Hk 40/8, 24/8, 48/8, 16/16, 64/8, hd 128, B 4, S 4096) beside
  SDPA, ssd_scan at Jamba's mixer (256 heads x 64, state 16, chunk 128)
  and gating_topk at moonshot's and Jamba's routers (E 64 top-6, E 16
  top-2), each against its plain version; then `Model.loss` on 4 x 4096
  tokens (flash once per attention layer, ssd_scan once per Mamba layer,
  gating_topk once per MoE layer, per call; every kernel call of one
  more call held against its plain version on its own inputs; qwen3-14b's
  loss within SCORE_LOSS_RTOL of the kernels' plain versions) for
  qwen3-14b at full depth (40 layers), moonshot at 24 of its 48,
  phi4-mini and nemotron at 4, and Jamba at one period (8 layers, d_ff
  8192 for the card's memory);
  qwen3-14b, moonshot and Jamba also serve Mamba2's traffic, with their
  gating_topk and ssd_scan launches equal to their layers x prefills
  (and decode steps).

Float32 matrix products run in full float32 (TF32 off).  It fails, and
prints no result, without a CUDA device or without the port beside it.
The last line of its output is a JSON object naming the device; the line
before it names the card and its power limit as `nvidia-smi` gives them,
and one line before that lists each kernel with its launches, error,
times and bound.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 outside tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
MAIN_SCALE = 0.1
GOLDEN_SCALE = 0.005
# serving main path: ServeEngine over mamba2-2.7b at full width
SERVE = dict(batch_slots=4, prompt_len=1024, max_seq=1088)
SERVE_REQUESTS, SERVE_NEW = 8, 32
# The serving runs keep the published widths and half the published depth
# (64, 28 and 24 layers), so that the whole script, resilience phases
# included, stays inside its target of half the 1200 s limit.
SERVE_LAYERS = {"mamba2-2.7b": 32, "qwen3-1.7b": 14,
                "granite-moe-1b-a400m": 12}
# the smoke golden: tests/test_launchers.py's serving traffic
GOLDEN_SERVE = dict(batch_slots=2, prompt_len=8, max_seq=48)
GOLDEN_REQUESTS, GOLDEN_NEW = 5, 8
# ssd_scan check, float32 and the CUDA-core kernel: kernel vs its plain
# version.  Both run the same float32 operations in the same order, so they
# are expected to agree bitwise; the check allows 1e-5 of each output's
# largest magnitude.
SSD_RTOL = 1e-5
# ssd_scan, the bf16 tensor-core kernel (`ref.split_coefficients`).  Each
# output element is held within coefficient × T, where T sums the
# magnitudes of its terms (`ref.intra_chunk_majorants`): for y,
# Ty = Σ_{k≤q} A_qk·D_qk·|x_k| with A_qk = Σ_j |C_qj||B_kj| and D the decay;
# for h, Th = Σ_k tail_k·|x_k|·|B_k|.  Derivation, with u = SSD_SUM_U per
# float32 addition and γ(n) = n·u / (1 − n·u):
# * a float32 sum of n terms errs by at most γ(n)·Σ|terms|.  u is 4× float32's
#   2⁻²⁴: the tensor cores align each k16 step's 16 products and the
#   accumulator to the largest and truncate, losing under one ulp (2⁻²³) of
#   the largest per term, which over K/16 steps stays below K·2⁻²²·Σ|terms|;
# * the split: hi = bf16(v), lo = bf16(v − hi) (v − hi exact), so hi + lo =
#   v(1 + δ) with |δ| <= 2⁻⁸·2⁻⁸ = SSD_SPLIT, and |hi| + |lo| <= (1 + 2⁻⁸)²|v|;
# * y, kernel vs `split_intra_chunk`: C·B differs by the two sum orders over
#   st (2γ(st)·A), W = fl(s·D) by the two roundings (2u), the splits by
#   2·SSD_SPLIT, and the sums over the 2Qp hi and lo terms (Qp = Q padded to
#   64) by 2(1 + 2⁻⁸)²γ(2Qp); every |W| <= (1 + γ(st))(1 + u)·A·D.  Against
#   `reference_intra_chunk`, which does not split and sums Q terms, one
#   split and γ(2Qp) + γ(Q) instead;
# * h: both sides form the same tail·xdt and split it alike, so only the
#   sum orders differ, 2(1 + 2⁻⁸)²γ(2Qp); against the reference, one split,
#   (1 + 2⁻⁸)²γ(2Qp) + γ(Q);
# * a and the chunk-local prefix sums: the same float32 steps, bitwise;
# * the full scan through `ops.ssd_scan`, kernel vs interpret=True: the
#   inter-chunk carry, the C·h product and the sums repeat the same float32
#   steps on values that differ by the above, adding 2γ(st + nC + 2) of the
#   full magnitude sum (the scan on |xdt|, |b|, |c|);
# * SSD_MAJORANT: T itself is a float32 sum, within γ(st + Q + 2) (2⁻²⁴) of
#   its value.
SSD_SUM_U = 2.0 ** -22
SSD_SPLIT = 2.0 ** -16
SSD_MAJORANT = 1 + 2.0 ** -10
# full scan vs the naive per-step recurrence: float32 sums in another
# order, over bf16 inputs both sides widen exactly
SSD_NAIVE_RTOL = 1e-4
# serving: prefill logits of the card vs the CPU at float32 (the goldens),
# and the floor of the Mamba2 serving gate below
SERVE_LOGIT_ATOL = 5e-2
# Mamba2 serving, the bf16 kernel run vs the interpret=True run (the
# reference's function).  The full-width model with random bf16 weights
# turns a float32 reordering in one mixer into logits that differ by O(1):
# a third run, interpret=True with the kernel's plain version
# (`split_intra_chunk`) in the reference's place, involves no kernel and
# moved the prefill logits by up to 1.60 (mean 0.222; 8 of 8 requests'
# tokens parted) on an H100 80GB HBM3 at 700 W, the kernel run by 1.70
# (mean 0.222).
# The gate holds the kernel run to that reach, measured in the same run:
# prefill logits within SERVE_GAP_FACTOR × the plain run's largest (and
# mean) gap, and a request's tokens may part from interpret=True's only
# where interpret=True's top two logits lie within that reach of each
# other.  The factor is empirical, not derived: the two runs are
# reorderings of one kind and size (ratio 1.06 of the maxima, 1.00 of the
# means, in that run), and the gate sits above the spread of 8 requests.
SERVE_GAP_FACTOR = 2.0
GOLDEN_LOGIT_ATOL = 1e-4
# the MoE smoke golden: granite's attention has no qk-norm, so its float32
# scores reach ~100 and the CPU and the card round them apart by more
# than the dense goldens (moe_golden_breakdown prints each stage's gap).
# The bound sits above that gap and below the smallest change that one
# wrong route makes in the same logits; the phase fails unless it does.
MOE_GOLDEN_LOGIT_ATOL = 5e-5
# flash_attention checks.  float32: the kernel against its plain version,
# the reference's function (`reference_flash_bhsd`), which differ only in
# the order of the sums inside a key tile: max |kernel − plain| <=
# FLASH_F32_RTOL·max |plain|.
# bf16: the kernel rounds p to bf16 before P·V, which the reference does
# not, so it is held two ways.
# * Against its plain version (`rounded_flash_bhsd`: the same rounding),
#   each element within FLASH_BF16_ULP·|want| + FLASH_F32_RTOL·max |want|
#   + slack.  Both sides round the output once from float32 values that
#   agree to the float32 term (one bf16 ulp <= 2^-7 of the value); the
#   float32 term also covers elements near zero, where the weighted sum
#   cancels.  The slack is the plain version's flip slack: where the two
#   float32 orders could round a p to neighbouring bf16 values (p within
#   a derived float32 disagreement of a rounding midpoint), one bf16 ulp
#   of each such p times |v|, over l.  Without it a few elements, where
#   the two orders round a p apart, exceed the first two terms.
# * Against the reference's function (`ops.flash_attention(...,
#   interpret=True)`), each element within FLASH_BF16_ULP·|want| +
#   FLASH_P_ROUND·max_head |v| + FLASH_F32_RTOL·max |want|, derived:
#   p̃ = p(1 + δ) with |δ| <= 2^-8 (bf16 keeps 8 significant bits, and
#   rounding to nearest errs by half an ulp), and l sums the unrounded p,
#   so the weighted sum Σ p̃ v / l moves by at most 2^-8·Σ p |v| / l <=
#   2^-8·max |v| over the K/V head; both outputs then round once to bf16,
#   within 2^-8 of the value each, 2^-7·|want| together.
FLASH_F32_RTOL = 1e-5
FLASH_BF16_ULP = 2.0 ** -7
FLASH_P_ROUND = 2.0 ** -8
# gating_topk check: kernel vs its plain version, the same float32
# operations in the same order, so gates and ids must be bitwise equal
# (NaN bits included) at every shape and on rows with non-finite logits.
# the scoring main path: Model.loss on [4, 4096] tokens, the reference's
# train_4k sequence length at batch 4 (src/repro/launch/shapes.py)
SCORE_BATCH, SCORE_SEQ, SCORE_CALLS = 4, 4096, 3
# losses: the smoke golden CPU vs card at float32; at full width, the bf16
# kernel vs the interpret=True run (same weights and batch) within the
# larger of this and the bf16 model's own distance from float32 weights
SCORE_LOSS_RTOL = 1e-5


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
    put on the card, summed by the profiler, after a warm-up.  A profile
    that saw no device work at all (seen once on the H100) is taken
    again."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = device_activity(prof)[0]
        if busy > 0:
            return busy * 1e3 / reps
        print("device time: the profiler saw no device work; profiling "
              "again")
    raise AssertionError("the profiler saw no device work in three tries")


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


def kernel_inputs(dev, seed=0, jt=None):
    """Inputs at a main path's shapes: its padded topology (default: the
    fleet grid's 12 configurations), random loads around the line-up
    ratings, plus rows placed exactly on the `+1e-4` slack and rows
    without feeds."""
    import numpy as np
    import torch
    from repro_torch.core.sweep import _prepare
    if jt is None:
        axes, _ = fleet_axes(MAIN_SCALE)
        jt = _prepare(axes, 0, None, dev).jt
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


def check_kernel(dev, jt=None, label="the fleet grid"):
    import torch
    from repro_torch.kernels.placement_score import kernel as ker
    from repro_torch.kernels.placement_score.ops import score_rows
    from repro_torch.kernels.placement_score.ref import reference_score
    args = kernel_inputs(dev, jt=jt)
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
    print(f"kernel check: placement_score at {label}'s {N}x{R} rows, {X} "
          f"line-ups per "
          f"configuration, {int(feas_p.sum())} feasible: feas bitwise, "
          f"scores bitwise (max abs err {max_err}); device time per call "
          f"kernel {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, bound "
          f"{bound_s * 1e6:.3f} us ({by}: {n_bytes} B, {n_flop} flop); "
          f"back-to-back wall per call (host gaps included) kernel "
          f"{wall_ms * 1e3:.3f} us, plain {wall_plain_ms * 1e3:.3f} us")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=by)


def check_kernel_mc_shapes(dev):
    """The kernel check at each single-hall figure's padded N x R rows."""
    out = {}
    for name, (axes, kw) in mc_figures().items():
        jt = mc_prepared(axes, kw, dev)[0]
        N, R = jt.row_cap.shape[:2]
        out[name] = dict(rows=f"{N}x{R}",
                         **check_kernel(dev, jt, f"the {name} MC"))
    return out


SWEEP_FIELDS = ("halls_active", "deployed_mw", "p50_stranding",
                "p90_stranding", "final_hall_stranding",
                "final_lineup_stranding", "n_halls_built",
                "final_deployed_mw", "placed_fraction", "effective_dpm",
                "delivered_tps", "act_month", "reg_rows", "reg_counts")


def assert_same(a, b, what):
    import numpy as np
    for f in SWEEP_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"{what}: `{f}` differs")
    if (a.event_steps, a.pod_steps) != (b.event_steps, b.pod_steps):
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


def golden(dev, policies=(3, 2)):
    from repro_torch.core.sweep import sweep
    from repro_torch.core import hierarchy
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.placement import POLICY_NAMES
    from repro_torch.core.sweep import SweepAxes
    axes = SweepAxes.zip(
        designs=[hierarchy.get_design("4N/3"), hierarchy.get_design("8+2")],
        envs=[EnvelopeSpec(demand_scale=GOLDEN_SCALE, gpu_scenario="high")],
        policies=list(policies), seeds=[3, 4])
    t0 = time.perf_counter()
    on_cpu = sweep(axes, device="cpu")
    t1 = time.perf_counter()
    on_card = sweep(axes, device=dev)
    t2 = time.perf_counter()
    assert_same(on_cpu, on_card, "golden (CPU vs card)")
    check_result(on_card, len(axes))
    print(f"golden: 2 configurations at scale {GOLDEN_SCALE}, policies "
          f"{[POLICY_NAMES[p] for p in policies]}, "
          f"{on_card.event_steps} event steps: CPU {t1 - t0:.2f} s, card "
          f"{t2 - t1:.2f} s; decisions and outputs bitwise equal; halls "
          f"{list(on_card.n_halls_built)}, p90 "
          f"{[float(v) for v in on_card.p90_stranding[:, -1]]}")


def profile_run(run):
    """One call of `run` under the profiler (card activity only): wall
    seconds, device busy seconds, the number of kernels and copies, and
    the ten that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    # one timed run under the profiler (the kernel check before it is the
    # warm-up); a separate warm-up run and a separate profiled repeat went
    # for the script's time
    placement_score.launches = 0
    runs = []
    wall, busy, n_device, top = profile_run(
        lambda: runs.append(sweep(axes, device=dev)))
    walls = [wall]
    launches = [placement_score.launches]
    if launches[0] != runs[0].event_steps:
        raise AssertionError(f"{launches[0]} placement_score launches "
                             f"for {runs[0].event_steps} event steps")
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
          f"{walls[0]:.3f} s ({walls[0] / steps * 1e3:.3f} ms per event "
          f"step, under the profiler); equal to interpret=True "
          f"({plain_wall:.3f} s wall with the plain version); launches "
          f"{{'placement_score': {launches[0]}}}")
    for name, (calls, secs) in top:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {name[:90]}")
    print(f"main path profiled (card activity): {wall:.3f} s wall, device "
          f"busy {busy:.3f} s, idle share {1 - busy / wall:.3f}, "
          f"{n_device} kernels and copies ({n_device / steps:.1f} per event "
          f"step)")
    return launches[0]

# ------------------------------------------------------- single-hall MC

def mc_figures():
    """The single-hall figures of benchmarks/run.py at their own
    arguments: {name: (MCAxes, mc_sweep keywords)}."""
    import numpy as np
    from repro_torch.core import hierarchy
    from repro_torch.core.mc_sweep import MCAxes
    get = hierarchy.get_design
    kws = np.arange(200, 2501, 115)
    return {
        # Fig. 6 (benchmarks/run.py:146-162): 21 SKU-kW points x 2 designs
        "fig6": (MCAxes.product(designs=[get("4N/3"), get("3+1")],
                                sku_kw=[float(k) for k in kws], seeds=(6,)),
                 dict(n_trials=4, n_events=300, harvest=False,
                      single_sku_gpu=True)),
        # Fig. 5 (:123-136): stranding CDFs, 2030 "high", harvest on
        "fig5": (MCAxes.zip(designs=[get("4N/3"), get("3+1")], seeds=[5]),
                 dict(n_trials=16, n_events=500, year=2030,
                      scenario="high")),
        # Fig. 7 (:174-193): the four policies x 2 designs
        "fig7": (MCAxes.product(designs=[get("10N/8"), get("8+2")],
                                policies=range(4), seeds=(7,)),
                 dict(n_trials=8, n_events=900)),
    }


def mc_prepared(axes, kw, device):
    """`mc_sweep`'s staged batch for a figure: (jt, ta, tb, keys,
    policy), its (configuration x trial) axis flattened."""
    from repro_torch.core.mc_sweep import _mc_prepare
    return _mc_prepare(axes, kw["n_trials"], kw["n_events"],
                       kw.get("year", 2028), kw.get("scenario", "med"), 0.6,
                       kw.get("pod_racks", 1), 10, 0.0,
                       kw.get("single_sku_gpu", False), None, device)[0]


MC_FIELDS = ("lineup_stranding", "hall_stranding", "deployed_kw",
             "saturated", "placed_a", "placed_b", "delivered_tps",
             "tps_per_provisioned_w", "dollars_per_tps", "rows_a",
             "counts_a", "rows_b", "counts_b")


def assert_same_mc(a, b, what):
    import numpy as np
    for f in MC_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"{what}: `{f}` differs")
    if (a.event_steps, a.pod_steps) != (b.event_steps, b.pod_steps):
        raise AssertionError(f"{what}: event steps differ")


def check_mc_result(res, kw):
    """Shapes, finiteness and the ranges the MC metrics live in."""
    import numpy as np
    B, T = len(res), kw["n_trials"]
    E = kw["n_events"]
    E_b = max(200, E // 3)
    shapes = dict(hall_stranding=(B, T), deployed_kw=(B, T),
                  saturated=(B, T), placed_a=(B, T, E), placed_b=(B, T, E_b))
    for f, shape in shapes.items():
        if getattr(res, f).shape != shape:
            raise AssertionError(f"MC output `{f}` has shape "
                                 f"{getattr(res, f).shape}, not {shape}")
    for f in ("lineup_stranding", "hall_stranding", "deployed_kw"):
        x = getattr(res, f)
        if not np.all(np.isfinite(x)):
            raise AssertionError(f"MC output `{f}` is not finite")
    for f in ("lineup_stranding", "hall_stranding"):
        x = getattr(res, f)
        if not np.all((x >= 0) & (x <= 1)):
            raise AssertionError(f"`{f}` outside [0, 1]")
    if not np.all((res.deployed_kw > 0)
                  & (res.deployed_kw <= res.ha_capacity_kw[:, None] * 2)):
        raise AssertionError("deployed kW outside (0, 2 x HA capacity]")
    if res.event_steps != E + E_b:
        raise AssertionError(f"{res.event_steps} event steps for "
                             f"{E} + {E_b} events")


def check_threefry(dev):
    """Keys and draws of the random policy on the card against the CPU,
    bitwise, at each figure's N x R for both phases (every trial drawn,
    not only the random ones)."""
    import torch
    from repro_torch.core import placement as pl, prng
    n_draws = 0
    for name, (axes, kw) in mc_figures().items():
        E = kw["n_events"]
        phases = []
        for where in ("cpu", dev):
            jt, ta, tb, keys, _ = mc_prepared(axes, kw, where)
            N, R = jt.row_cap.shape[:2]
            every = torch.ones(N, dtype=torch.bool)
            ka, kb = prng.split(keys).unbind(1)
            phases.append((
                keys, ka, kb, pl.random_draws(ka, every, E, R),
                pl.random_draws(kb, every, tb.rack_kw.shape[0], R)))
        for a, b in zip(*phases):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"threefry: {name}'s keys or draws "
                                     "differ on the card")
        fill, refill = phases[0][3:]
        n_draws += fill.numel() + refill.numel()
        print(f"threefry: {name} keys [{N}, 2] and draws {list(fill.shape)} "
              f"+ {list(refill.shape)} bitwise equal, card vs CPU")
    return n_draws


def mc_golden(dev):
    """tests/test_mc_sweep.py's heterogeneous grid with two random-policy
    configurations added, on the CPU and on the card."""
    from repro_torch.core import hierarchy
    from repro_torch.core.mc_sweep import MCAxes, mc_sweep
    axes = MCAxes.zip(
        designs=[hierarchy.get_design(n) for n in
                 ("4N/3", "3+1", "10N/8", "4N/3", "10N/8")],
        policies=[3, 2, 3, 0, 0], seeds=[11, 11, 13, 11, 13])
    kw = dict(n_trials=4, n_events=150, year=2030, scenario="high")
    t0 = time.perf_counter()
    on_cpu = mc_sweep(axes, device="cpu", **kw)
    t1 = time.perf_counter()
    on_card = mc_sweep(axes, device=dev, **kw)
    t2 = time.perf_counter()
    assert_same_mc(on_cpu, on_card, "MC golden (CPU vs card)")
    check_mc_result(on_card, kw)
    print(f"MC golden: {len(axes)} configurations x {kw['n_trials']} "
          f"trials, {on_card.event_steps} event steps: CPU {t1 - t0:.2f} s, "
          f"card {t2 - t1:.2f} s; flags and outputs bitwise equal; mean "
          f"line-up stranding per configuration "
          f"{[float(on_card.lineup_stranding[i].mean()) for i in range(5)]}")


def mc_figure_numbers(name, res):
    """The figure's own numbers, as benchmarks/run.py derives them."""
    import numpy as np
    from repro_torch.core.placement import POLICY_NAMES
    designs = sorted({d.name for d in res.axes.designs},
                     key=[d.name for d in res.axes.designs].index)
    if name == "fig6":
        kws = sorted(set(res.axes.sku_kw))
        for di, dname in enumerate(designs):
            vals = []
            for ki in range(len(kws)):
                r = res.result(di * len(kws) + ki)
                vals.append(1.0 - r["deployed_kw"].mean()
                            / r["ha_capacity_kw"])
            tops = ",".join(f"{k:.0f}:{v:.2f}" for k, v in zip(kws, vals)
                            if v > 0.15)
            print(f"  fig6.{dname}: max_strand={max(vals):.3f};"
                  f"spikes>{{0.15}}=[{tops}]")
    elif name == "fig5":
        for i, dname in enumerate(designs):
            s = res.result(i)["lineup_stranding"].flatten()
            print(f"  fig5.mc.{dname}: p50={np.percentile(s, 50):.3f};"
                  f"p99={np.percentile(s, 99):.3f}")
    else:
        means = {}
        for pol in range(4):
            agg = [res.result(di * 4 + pol)["lineup_stranding"].mean()
                   for di in range(len(designs))]
            means[POLICY_NAMES[pol]] = float(np.mean(agg))
            print(f"  fig7.{POLICY_NAMES[pol]}: "
                  f"mean_lineup_stranding={np.mean(agg):.4f}")
        print(f"  fig7.best_policy: {min(means, key=means.get)}")


def mc_main_path(dev, name, axes, kw):
    """One single-hall figure through `mc_sweep` on the card: two timed
    runs (bitwise repeats, one kernel launch per event step; the first is
    the warm-up, the second is profiled: a separate warm-up and a separate
    profiled run went for the script's time), an interpret=True run (no
    launch, the same bits), and the figure's numbers."""
    import torch
    from repro_torch.core.mc_sweep import mc_sweep
    from repro_torch.kernels.placement_score.kernel import placement_score
    runs, walls, launches = [], [], []
    for i in range(2):
        placement_score.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            res = mc_sweep(axes, device=dev, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        else:
            got = []
            wall, busy, n_device, top = profile_run(
                lambda: got.append(mc_sweep(axes, device=dev, **kw)))
            res = got[0]
            walls.append(wall)
        launches.append(placement_score.launches)
        runs.append(res)
        if launches[-1] != res.event_steps:
            raise AssertionError(f"{name}: {launches[-1]} placement_score "
                                 f"launches for {res.event_steps} event "
                                 f"steps")
    assert_same_mc(runs[0], runs[1], f"{name} repeat")
    check_mc_result(runs[0], kw)

    placement_score.launches = 0
    t0 = time.perf_counter()
    plain = mc_sweep(axes, device=dev, interpret=True, **kw)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if placement_score.launches != 0:
        raise AssertionError(f"{name}: interpret=True launched the kernel")
    assert_same_mc(runs[0], plain, f"{name} kernel vs interpret=True")

    res, steps = runs[0], runs[0].event_steps
    N = len(axes) * kw["n_trials"]
    print(f"MC {name}: {len(axes)} configurations x {kw['n_trials']} trials "
          f"(N {N}) on {res.device}, {steps} event steps; wall per run "
          f"{walls[0]:.3f} s (warm-up), {walls[1]:.3f} s (profiled; "
          f"{walls[0] / steps * 1e3:.3f}, {walls[1] / steps * 1e3:.3f} ms "
          f"per event step); repeats bitwise equal; equal to interpret=True "
          f"({plain_wall:.3f} s wall with the plain version); launches "
          f"{{'placement_score': {launches[0]}}}")
    for kname, (calls, secs) in top[:5]:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {kname[:90]}")
    print(f"MC {name} profiled (card activity): {wall:.3f} s wall, device "
          f"busy {busy:.4f} s, idle share {1 - busy / wall:.3f}, {n_device} "
          f"kernels and copies ({n_device / steps:.1f} per event step)")
    mc_figure_numbers(name, res)
    return launches[0]


def mc_main_paths(dev):
    return {name: mc_main_path(dev, name, axes, kw)
            for name, (axes, kw) in mc_figures().items()}


# ------------------------------------------------------ multi-row pods

POD_SCALE = 0.04          # benchmarks/run.py's SCALE: Fig. 17's own size
FIG17_PODS = (3, 5, 7)
STREAM_TOL = 1.0 / 512 + 1e-6   # one bucket of the streaming histogram


def pod_env(scale, pod):
    from repro_torch.core.arrivals import EnvelopeSpec
    return EnvelopeSpec(demand_scale=scale, gpu_scenario="high",
                        pod_racks=pod, pod_scale_arch=True)


def fig17_axes():
    """Fig. 17's pod group (benchmarks/run.py:298-310): 10N/8 and 8+2 x
    pods of 3, 5 and 7 racks, HIGH, pod-scale racks, seed 0, var_min."""
    from repro_torch.core import hierarchy
    from repro_torch.core.sweep import SweepAxes
    combos = [(d, p) for d in ("10N/8", "8+2") for p in FIG17_PODS]
    return SweepAxes.zip(
        designs=[hierarchy.get_design(d) for d, _ in combos],
        envs=[pod_env(POD_SCALE, p) for _, p in combos]), combos


def pod_golden_axes():
    """The split-vs-legacy grid of tests/test_mc_sweep.py:219 (10N/8 with
    pods of 3, 8+2 with pods of 5, seeds 3 and 4, scale 0.005) under
    each of the four policies."""
    from repro_torch.core import hierarchy
    from repro_torch.core.sweep import SweepAxes
    combos = [(d, p, s, pol) for pol in range(4)
              for d, p, s in (("10N/8", 3, 3), ("8+2", 5, 4))]
    return SweepAxes.zip(
        [hierarchy.get_design(d) for d, *_ in combos],
        [pod_env(0.005, p) for _, p, _, _ in combos],
        policies=[c[3] for c in combos], seeds=[c[2] for c in combos])


def mc_pod_axes():
    """mc_pod_speedup's grid (benchmarks/run.py:632-660) for one pod size:
    10N/8 and 8+2 x seeds 51 and 52, and its keywords."""
    from repro_torch.core import hierarchy
    from repro_torch.core.mc_sweep import MCAxes
    axes = MCAxes.product(designs=[hierarchy.get_design(d)
                                   for d in ("10N/8", "8+2")], seeds=(51, 52))
    return axes, dict(n_trials=4, n_events=240, year=2030, scenario="high")


def check_kernel_pod_shapes(dev):
    """The kernel check at the HD-compacted row views the pod racks are
    searched on: Fig. 17's [N, hd_scan] and mc_pod_speedup's."""
    from repro_torch.core import placement as pl
    from repro_torch.core.mc_sweep import _mc_prepare
    from repro_torch.core.sweep import _prepare
    prep = _prepare(fig17_axes()[0], 0, None, dev)
    view = pl.hd_subset(prep.jt, prep.hd_scan).jt
    N, K = view.row_cap.shape[:2]
    out = {"fig17": dict(rows=f"{N}x{K}", **check_kernel(
        dev, view, "Fig. 17's HD-compacted pod view"))}
    axes, kw = mc_pod_axes()
    (jt, *_), mode = _mc_prepare(axes, kw["n_trials"], kw["n_events"],
                                 kw["year"], kw["scenario"], 0.6, 7, 10, 0.0,
                                 False, None, dev)
    view = pl.hd_subset(jt, mode["hd_scan"]).jt
    N, K = view.row_cap.shape[:2]
    out["mc_pod"] = dict(rows=f"{N}x{K}", **check_kernel(
        dev, view, "mc_pod_speedup's HD-compacted pod view"))
    return out


def pod_golden(dev):
    """Phase (b): the pod fleet golden on the CPU and on the card, split
    and through the per-event cond: bitwise, registries included."""
    from repro_torch.core.sweep import sweep
    axes = pod_golden_axes()
    for legacy in (False, True):
        t0 = time.perf_counter()
        on_cpu = sweep(axes, device="cpu", legacy_pod_cond=legacy)
        t1 = time.perf_counter()
        on_card = sweep(axes, device=dev, legacy_pod_cond=legacy)
        t2 = time.perf_counter()
        what = "legacy" if legacy else "split"
        assert_same(on_cpu, on_card, f"pod golden {what} (CPU vs card)")
        check_result(on_card, len(axes))
        if on_card.pod_steps == 0:
            raise AssertionError("pod golden: no pod rack was placed")
        print(f"pod golden ({what}): {len(axes)} configurations (4 policies)"
              f", {on_card.event_steps} placement steps of which "
              f"{on_card.pod_steps} pod racks: CPU {t1 - t0:.2f} s, card "
              f"{t2 - t1:.2f} s; registries and outputs bitwise equal; "
              f"halls {[int(v) for v in on_card.n_halls_built]}, placed fraction "
              f"{[float(v) for v in on_card.placed_fraction]}")


def timed_sweep(axes, dev, **kw):
    """One `sweep` on the card from zeroed launch counts: (result, wall
    seconds), after checking one launch per placement step."""
    import torch
    from repro_torch.core.sweep import sweep
    from repro_torch.kernels.placement_score.kernel import placement_score
    placement_score.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweep(axes, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if placement_score.launches != res.event_steps:
        raise AssertionError(f"{placement_score.launches} placement_score "
                             f"launches for {res.event_steps} placement "
                             "steps")
    return res, wall


def pod_main_path(dev):
    """Phase (a): Fig. 17's pod group through `sweep` on the card, exact
    and streaming quantiles; every output but p50/p90 bitwise, those
    within one bucket; walls, steps, launches, idle share and the
    figure's $/MW."""
    import numpy as np
    axes, combos = fig17_axes()
    exact, wall_e = timed_sweep(axes, dev)
    # the streaming run profiled (a separate profiled repeat went for the
    # script's time)
    got = []
    wall, busy, n_device, top = profile_run(lambda: got.append(
        timed_sweep(axes, dev, exact_quantiles=False)))
    stream, wall_s = got[0]
    check_result(exact, len(axes))
    for f in SWEEP_FIELDS:
        if f in ("p50_stranding", "p90_stranding"):
            a, b = getattr(exact, f), getattr(stream, f)
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                raise AssertionError(f"streaming `{f}`: NaN months differ")
            gap = float(np.nanmax(np.abs(a - b)))
            if gap > STREAM_TOL:
                raise AssertionError(f"streaming `{f}` off by {gap}")
            print(f"pod main path: streaming {f} within {gap:.3e} of the "
                  f"exact (limit {STREAM_TOL:.3e})")
        elif not np.array_equal(np.asarray(getattr(exact, f)),
                                np.asarray(getattr(stream, f))):
            raise AssertionError(f"streaming run: `{f}` differs")
    steps, pods = exact.event_steps, exact.pod_steps
    if pods == 0 or (stream.event_steps, stream.pod_steps) != (steps, pods):
        raise AssertionError("pod main path: pod steps missing or unequal")
    print(f"{'design':8s} {'pod':>4s} {'halls':>6s} {'deployed':>9s} "
          f"{'P90str':>7s} {'eff$/MW':>9s}")
    for i, (name, pod) in enumerate(combos):
        print(f"{name:8s} {pod:4d} {exact.n_halls_built[i]:6d} "
              f"{exact.final_deployed_mw[i]:8.1f}M "
              f"{exact.p90_stranding[i, -1]:6.1%} "
              f"{exact.effective_dpm[i] / 1e6:8.2f}M")
    for i, (name, pod) in enumerate(combos):
        print(f"  fig17.{name}.pod{pod}: "
              f"eff$/MW={exact.effective_dpm[i] / 1e6:.2f}M")
    for name, (calls, secs) in top[:5]:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {name[:90]}")
    print(f"pod main path: Fig. 17's pod group, {len(axes)} configurations "
          f"at scale {POD_SCALE} on {exact.device}; {steps} placement steps "
          f"= launches ({pods} pod racks, {steps - pods} clusters); wall "
          f"per run exact {wall_e:.3f} s, streaming {wall_s:.3f} s "
          f"({wall_e / steps * 1e3:.3f}, {wall_s / steps * 1e3:.3f} ms per "
          f"step); profiled (streaming): {wall:.3f} s wall, device busy "
          f"{busy:.3f} s, idle share {1 - busy / wall:.3f}, {n_device} "
          f"kernels and copies ({n_device / steps:.1f} per step)")
    return dict(launches=steps, pod_racks=pods, clusters=steps - pods)


def pod_sweep_pair(dev):
    """Phase (c): pod_sweep_speedup's grid (benchmarks/run.py:576-586,
    scale 0.01, seeds 302 and 303, shared traces), split and legacy in
    turns: halls and registries bitwise, float columns within 1e-6."""
    import numpy as np
    from repro_torch.core import hierarchy
    from repro_torch.core.arrivals import generate_fleet_trace
    from repro_torch.core.sweep import SweepAxes
    combos = [(d, p, sd) for d in ("10N/8", "8+2") for p in (3, 5)
              for sd in (302, 303)]
    axes = SweepAxes.zip(
        designs=[hierarchy.get_design(d) for d, _, _ in combos],
        envs=[pod_env(0.01, p) for _, p, _ in combos],
        seeds=[sd for *_, sd in combos])
    traces = [generate_fleet_trace(e, s)
              for e, s in zip(axes.envs, axes.seeds)]
    walls = {False: [], True: []}
    runs = {}
    for legacy in (False, True, False, True):
        runs[legacy], wall = timed_sweep(axes, dev, traces=traces,
                                         legacy_pod_cond=legacy)
        walls[legacy].append(wall)
    split, legacy = runs[False], runs[True]
    for f in ("n_halls_built", "reg_rows", "reg_counts"):
        if not np.array_equal(getattr(split, f), getattr(legacy, f)):
            raise AssertionError(f"pod sweep pair: `{f}` differs")
    dev_max = 0.0
    for f in ("final_deployed_mw", "placed_fraction", "p50_stranding",
              "p90_stranding", "halls_active", "final_lineup_stranding"):
        gap = float(np.max(np.abs(np.asarray(getattr(split, f), float)
                                  - np.asarray(getattr(legacy, f), float))))
        if gap > 1e-6:
            raise AssertionError(f"pod sweep pair: `{f}` off by {gap}")
        dev_max = max(dev_max, gap)
    print(f"pod sweep pair: pod_sweep_speedup's {len(axes)} configurations "
          f"at scale 0.01; split {split.event_steps} steps ({split.pod_steps}"
          f" pod racks), walls {walls[False][0]:.3f}, {walls[False][1]:.3f} s"
          f"; legacy {legacy.event_steps} steps ({legacy.pod_steps} pod "
          f"racks), walls {walls[True][0]:.3f}, {walls[True][1]:.3f} s; "
          f"halls and registries bitwise, float columns max dev {dev_max}")
    return dict(split=split.event_steps, legacy=legacy.event_steps)


def mc_pod_pair(dev):
    """Phase (d): mc_pod_speedup's grid (pods of 3, 5 and 7, one
    `mc_sweep` call each), split and legacy in turns: flags, registries
    and every output bitwise; walls and launches per call."""
    import numpy as np
    import torch
    from repro_torch.core.mc_sweep import mc_sweep
    from repro_torch.kernels.placement_score.kernel import placement_score
    axes, kw = mc_pod_axes()
    launches = {}
    for pod in FIG17_PODS:
        runs, walls = {}, {False: [], True: []}
        for legacy in (False, True, False, True):
            placement_score.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mc_sweep(axes, device=dev, pod_racks=pod,
                           legacy_pod_cond=legacy, **kw)
            torch.cuda.synchronize()
            walls[legacy].append(time.perf_counter() - t0)
            if placement_score.launches != res.event_steps:
                raise AssertionError(f"mc pods {pod}: {placement_score.launches}"
                                     f" launches for {res.event_steps} steps")
            if legacy in runs:
                assert_same_mc(runs[legacy], res, f"mc pods {pod} repeat")
            runs[legacy] = res
        split, legacy = runs[False], runs[True]
        for f in MC_FIELDS:
            if not np.array_equal(np.asarray(getattr(split, f)),
                                  np.asarray(getattr(legacy, f)),
                                  equal_nan=True):
                raise AssertionError(f"mc pods {pod}: `{f}` differs, split "
                                     "vs legacy")
        if split.pod_steps == 0:
            raise AssertionError(f"mc pods {pod}: no pod rack placed")
        launches[pod] = dict(split=split.event_steps,
                             legacy=legacy.event_steps,
                             pod_racks=split.pod_steps)
        print(f"mc pods {pod}: {len(axes)} configurations x "
              f"{kw['n_trials']} trials; split {split.event_steps} launches "
              f"({split.pod_steps} pod racks), walls {walls[False][0]:.3f}, "
              f"{walls[False][1]:.3f} s; legacy {legacy.event_steps} "
              f"launches ({legacy.pod_steps} pod racks), walls "
              f"{walls[True][0]:.3f}, {walls[True][1]:.3f} s; flags, "
              f"registries and outputs bitwise equal")
    return launches


# ------------------------------------------------------- the metric stage

F5_X = (0.2, float("nan"), 0.7, 0.4)
F5_CASES = (((True, True, True, True), (0.2998046875, 0.6099609136581421)),
            ((True, False, True, True), (0.3994140625, 0.6400390863418579)))
# scenario_sweep and Fig. 18: half benchmarks/run.py's SCALE of 0.04, a
# cut for the script's time once the model zoo joined it
STUDY_SCALE = 0.02
FRONTIER_SCALE = 0.01     # metric_stack's min(SCALE, 0.01)
TABLE2_RTOL = 1e-6        # float32 reductions: the grid against the loop


def check_f5(dev):
    """The streaming histogram's NaN cases (ROADMAP fault F5): a NaN
    value, masked in and out, lands in bucket 0 on the card as on the
    CPU; both bitwise, and equal to `repro`'s values."""
    import numpy as np
    import torch
    from repro_torch.core.quantiles import hist_masked_quantiles
    x = torch.tensor(F5_X)
    for keep, want in F5_CASES:
        m = torch.tensor(keep)
        on_cpu = hist_masked_quantiles(x, m, (50.0, 90.0))
        on_card = hist_masked_quantiles(x.to(dev), m.to(dev), (50.0, 90.0))
        got = [v.cpu().numpy().tobytes() for v in on_card]
        if got != [v.numpy().tobytes() for v in on_cpu] or \
                got != [np.float32(w).tobytes() for w in want]:
            raise AssertionError(f"F5 {keep}: card {on_card}, CPU {on_cpu}, "
                                 f"want {want}")
        print(f"F5 check: x={list(F5_X)} mask={list(keep)}: p50, p90 card "
              f"{[float(v) for v in on_card]} bitwise the CPU's and "
              f"repro's {list(want)}")


def one_per_family(base):
    """One representative envelope per scenario family, as
    tests/test_scenarios.py:30-41 builds its shared grid."""
    from dataclasses import replace
    from repro_torch.core import scenarios as sc
    envs = {sc.FAMILY_SHOCK: replace(base, shock_month=18,
                                     shock_multiplier=1.5),
            sc.FAMILY_COHORT: replace(base, cohort_window_m=6),
            sc.FAMILY_MIX: replace(base, mix_end=(0.8, 0.14, 0.06),
                                   la_fraction=0.3),
            sc.FAMILY_REFRESH: replace(base, refresh_cycle_m=24)}
    return {k: sc.ScenarioBatch(k, ("rep",), (e,)) for k, e in envs.items()}


def same_points(a, b, what):
    """Two lists of study points equal field by field, NaN equal to NaN."""
    import math
    from dataclasses import astuple
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} points against {len(b)}")
    for p, q in zip(a, b):
        for x, y in zip(astuple(p), astuple(q)):
            nan = isinstance(x, float) and isinstance(y, float) and \
                math.isnan(x) and math.isnan(y)
            if x != y and not nan:
                raise AssertionError(f"{what}: {p} differs from {q}")


class StudySweeps:
    """Launch counting around one study call: zeroes `placement_score`'s
    count, records the axes and `SweepResult` of every sweep the study
    runs (through `payoff.sharded_sweep` or `payoff.sweep`), times each
    sweep's `_prepare` (trace synthesis, batch assembly) and its
    lifecycle (the placement steps, ended by a synchronize) apart from
    the rest, and checks one launch per placement step. The study itself
    runs unchanged."""

    def __init__(self):
        self.axes, self.results = [], []
        self.prepare_s = self.steps_s = 0.0

    def _timed(self, fn, attr):
        import torch

        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            setattr(self, attr, getattr(self, attr)
                    + time.perf_counter() - t0)
            return out
        return run

    def __enter__(self):
        import torch
        from repro_torch.core import payoff, sweep as sweep_mod
        from repro_torch.kernels.placement_score.kernel import placement_score
        self._saved = (payoff.sweep, payoff.sharded_sweep, sweep_mod._prepare,
                       sweep_mod.simulate_lifecycle)

        def recorded(fn):
            def run(axes, *args, **kw):
                res = fn(axes, *args, **kw)
                self.axes.append(axes)
                self.results.append(res)
                return res
            return run
        payoff.sweep = recorded(self._saved[0])
        payoff.sharded_sweep = recorded(self._saved[1])
        sweep_mod._prepare = self._timed(self._saved[2], "prepare_s")
        sweep_mod.simulate_lifecycle = self._timed(self._saved[3], "steps_s")
        placement_score.launches = 0
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        from repro_torch.core import payoff, sweep as sweep_mod
        from repro_torch.kernels.placement_score.kernel import placement_score
        (payoff.sweep, payoff.sharded_sweep, sweep_mod._prepare,
         sweep_mod.simulate_lifecycle) = self._saved
        if exc[0] is not None:
            return False
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self._t0
        self.launches = placement_score.launches
        self.steps = sum(r.event_steps for r in self.results)
        self.pod_steps = sum(r.pod_steps for r in self.results)
        if self.launches != self.steps or self.steps == 0:
            raise AssertionError(f"{self.launches} placement_score launches "
                                 f"for {self.steps} placement steps")
        return False


def payoff_golden(dev):
    """`scenario_frontier` on 3+1 at scale 0.005 with one envelope per
    family, on the CPU and on the card: every `ScenarioPoint` field equal
    (the sweep is bitwise card ≡ CPU, the metric stage host math)."""
    from repro_torch.core import hierarchy
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.payoff import scenario_frontier
    base = EnvelopeSpec(demand_scale=GOLDEN_SCALE)
    fams = one_per_family(base)
    t0 = time.perf_counter()
    on_cpu = scenario_frontier(hierarchy.get_design("3+1"), base,
                               families=fams, device="cpu")
    t1 = time.perf_counter()
    with StudySweeps() as run:
        on_card = scenario_frontier(hierarchy.get_design("3+1"), base,
                                    families=fams, device=dev)
    same_points(on_cpu, on_card, "payoff golden (CPU vs card)")
    print(f"payoff golden: scenario_frontier, 3+1, baseline + one envelope "
          f"per family at scale {GOLDEN_SCALE}, {run.steps} placement steps"
          f": CPU {t1 - t0:.2f} s, card {run.wall:.2f} s; every "
          f"ScenarioPoint field equal; p90 "
          f"{[p.p90_stranding for p in on_card]}")


def check_kernel_scenario_shape(dev):
    """The kernel check at the scenario grid's padded [15, R] rows."""
    from repro_torch.core import hierarchy, scenarios
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.sweep import _prepare
    axes = scenarios.frontier_axes([hierarchy.get_design("3+1")],
                                   base=EnvelopeSpec(demand_scale=STUDY_SCALE))
    jt = _prepare(axes, 0, None, dev).jt
    N, R = jt.row_cap.shape[:2]
    return dict(rows=f"{N}x{R}", **check_kernel(dev, jt,
                                                "the scenario grid"))


def study_runs(study, what):
    """`study` (a callable returning a list of points) once under
    `StudySweeps` and the profiler (a separate profiled repeat went for
    the script's time): (points, its `StudySweeps`, the profile's
    line)."""
    got = []

    def timed():
        with StudySweeps() as run:
            got.append((study(), run))
    wall, busy, n_device, top = profile_run(timed)
    pts, run = got[0]
    for name, (calls, secs) in top[:5]:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {name[:90]}")
    line = (f"{run.steps} placement steps = launches ({run.pod_steps} pod "
            f"racks); wall {run.wall:.3f} s = prepare {run.prepare_s:.3f} s "
            f"+ steps {run.steps_s:.3f} s ({run.steps_s / run.steps * 1e3:.3f}"
            f" ms per step) + other "
            f"{run.wall - run.prepare_s - run.steps_s:.3f} s (profiled); "
            f"{wall:.3f} s wall, device busy {busy:.3f} s, "
            f"idle share {1 - busy / wall:.3f}, {n_device} kernels and "
            f"copies ({n_device / run.steps:.1f} per step)")
    return pts, run, line


def check_kernel_study_shapes(dev, run, what):
    """The kernel check at the padded [N, R] rows of every grid a study's
    run swept, and at its HD-compacted pod view where pods are placed."""
    from repro_torch.core import placement as pl
    from repro_torch.core.sweep import _prepare
    out = {}
    for k, axes in enumerate(run.axes):
        prep = _prepare(axes, 0, None, dev)
        views = {"rows": prep.jt}
        if prep.with_pods:
            views["pod view"] = pl.hd_subset(prep.jt, prep.hd_scan).jt
        for v, jt in views.items():
            N, R = jt.row_cap.shape[:2]
            out[f"{what} grid {k + 1} {v}"] = dict(
                rows=f"{N}x{R}", **check_kernel(
                    dev, jt, f"{what}'s grid {k + 1} ({v})"))
    return out


def study_golden(card_pts, study, what):
    """The study once more on the CPU: every point field equal to the
    card's main-path run (the sweep is bitwise card ≡ CPU, the metric
    stage host math)."""
    t0 = time.perf_counter()
    on_cpu = study("cpu")
    same_points(on_cpu, card_pts, f"{what} golden (CPU vs card)")
    print(f"{what} golden: {len(on_cpu)} points, CPU run "
          f"{time.perf_counter() - t0:.2f} s; every field equal to the "
          "card's main-path run")


def scenario_main_path(dev):
    """`scenario_sweep` (benchmarks/run.py:949-971): `scenario_frontier`
    on 3+1 with every family at its catalog defaults around STUDY_SCALE,
    15 configurations on one grid, metric model MoE-132T."""
    from repro_torch.core import hierarchy
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.payoff import scenario_frontier
    base = EnvelopeSpec(demand_scale=STUDY_SCALE)
    pts, run, line = study_runs(lambda: scenario_frontier(
        hierarchy.get_design("3+1"), base_env=base, device=dev),
        "scenario_sweep")
    if len(pts) != 15 or pts[0].family != "baseline":
        raise AssertionError(f"scenario_sweep: {len(pts)} points")
    for p in pts:
        if not (0 <= p.p50_stranding <= p.p90_stranding <= 1) or \
                p.n_halls < 1 or not p.delivered_tps > 0:
            raise AssertionError(f"scenario_sweep: {p}")
    if (pts[0].d_p90, pts[0].d_capex, pts[0].d_dpm) != (0.0, 0.0, 0.0):
        raise AssertionError("scenario_sweep: the baseline's deltas")
    for p in pts:
        print(f"  scenario.{p.family}.{p.label}: p50={p.p50_stranding:.3f};"
              f"p90={p.p90_stranding:.3f};halls={p.n_halls};"
              f"dP90={p.d_p90:+.3f};dCapex={p.d_capex:+.3%};"
              f"d$/MW={p.d_dpm:+.3%}")
    worst = max(pts, key=lambda p: p.p90_stranding)
    print(f"scenario_sweep: {len(pts)} configurations at scale "
          f"{STUDY_SCALE} on {run.results[0].device}; worst p90 "
          f"{worst.family}:{worst.label}={worst.p90_stranding:.3f}; {line}")
    return run.launches


def fig18_main_path(dev):
    """Fig. 18 through `pod_payoff_study`: 10N/8 and 8+2, four models,
    pods of 1 and 5 racks, HIGH, pod-scale racks for both pod sizes (the
    study's own envelope), STUDY_SCALE, year 2028; one `fleet_cache` per
    design."""
    from repro_torch.core import hierarchy, throughput as tp
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.payoff import pod_payoff_study
    env = EnvelopeSpec(demand_scale=STUDY_SCALE, gpu_scenario="high",
                       pod_scale_arch=True)
    models = [tp.MODELS[m] for m in ("MoE-0.6T", "MoE-19T", "MoE-132T",
                                     "MoE-401T")]
    designs = ("10N/8", "8+2")

    def study(device=dev):
        pts = []
        for name in designs:
            cache = {}
            pts += pod_payoff_study(
                hierarchy.get_design(name), models, pod_sizes=(1, 5),
                env=env, year=2028, fleet_cache=cache, device=device)
            if sorted(cache) != [1, 5]:
                raise AssertionError(f"fig18 {name}: cache {sorted(cache)}")
        return pts
    pts, run, line = study_runs(study, "fig18")
    if run.pod_steps == 0:
        raise AssertionError("fig18: no pod rack was placed")
    by = {(p.design, p.model, p.pod_racks): p for p in pts}
    for name in designs:
        for m in models:
            p1, p5 = by[(name, m.name, 1)], by[(name, m.name, 5)]
            if (p1.d_cost, p1.payoff) != (0.0, 0.0) or \
                    not p5.fleet_tps_per_watt > 0:
                raise AssertionError(f"fig18 {name} {m.name}: {p1}, {p5}")
            print(f"  fig18.{name}.{m.name}: dTPS/W={p5.d_tps_per_watt:+.3f};"
                  f"dCost={p5.d_cost:+.3f};payoff={p5.payoff:+.3f};"
                  f"fleet_tps_per_w pod1={p1.fleet_tps_per_watt:.4f} "
                  f"pod5={p5.fleet_tps_per_watt:.4f}")
    print(f"fig18: pod_payoff_study, 2 designs x pods (1, 5) at scale "
          f"{STUDY_SCALE}, HIGH, pod_scale_arch=True for both pod sizes; "
          f"{line}")
    study_golden(pts, study, "fig18")
    return run.launches, check_kernel_study_shapes(dev, run, "fig18")


def frontier_main_path(dev):
    """`metric_stack`'s design frontier (benchmarks/run.py:1004-1015):
    the four designs x pods (1, 5) at scale 0.01, HIGH, MoE-132T."""
    from repro_torch.core import throughput as tp
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.payoff import design_frontier
    env = EnvelopeSpec(demand_scale=FRONTIER_SCALE, gpu_scenario="high")

    def study(device=dev):
        return design_frontier(base_env=env, models=[tp.MODELS["MoE-132T"]],
                               device=device)
    pts, run, line = study_runs(study, "design frontier")
    front = sorted((p for p in pts if not p.dominated),
                   key=lambda p: p.total_capex)
    if len(pts) != 8 or not front:
        raise AssertionError(f"design frontier: {len(pts)} points, "
                             f"{len(front)} on the front")
    for p in pts:
        print(f"  frontier.{p.design}.pod{p.pod_racks}: halls={p.n_halls};"
              f"tps={p.delivered_tps:.6g};capex=${p.total_capex / 1e6:.2f}M;"
              f"$/tps={p.dollars_per_tps:.2f};dominated={p.dominated}")
    print(f"design frontier: n_points={len(pts)};n_pareto={len(front)};"
          f"best={front[0].design}:pod{front[0].pod_racks}"
          f"=${front[0].dollars_per_tps:.2f}/tps; {line}")
    study_golden(pts, study, "design frontier")
    return run.launches, check_kernel_study_shapes(dev, run, "frontier")


def table2():
    """Table 2 through the per-pair API (benchmarks/run.py:331-341) on
    Kyber 2028 racks, MED: host math; the [1, M] grid against the scalar
    loop within TABLE2_RTOL."""
    import numpy as np
    from repro_torch.core import projections as proj, throughput as tp
    d = tp.Deployment(proj.KYBER, 2028, 1, proj.MED)
    loop = []
    for m in tp.MODEL_SUITE:
        t = float(tp.tps_request(m, d))
        which, _ = tp.bottleneck(m, d, "dec")
        loop.append(t)
        print(f"  table2.{m.name}: tps={t:,.0f};"
              f"tps_per_w={tp.tps_per_watt(m, d):.3f};"
              f"n_dom={tp.n_domains(m, d)};bottleneck={which}")
    grid = tp.tps_request_grid(tp.MODEL_SUITE, [d])[0]
    dev_max = float(np.max(np.abs(grid / np.array(loop) - 1.0)))
    if not dev_max <= TABLE2_RTOL:
        raise AssertionError(f"table2: grid off the loop by {dev_max}")
    print(f"table2: {len(loop)} models; tps_request_grid against the scalar "
          f"loop max rel dev {dev_max:.3e} (limit {TABLE2_RTOL})")


# ------------------------------------------------------ resilient execution

RESILIENCE_SCALE = 0.004  # tests/test_resilience.py's grid
# benchmarks/run.py's full-size legs (configurations, chunk size); a
# rehearsal on the CPU sets them lower
RESUME_GRID = (1024, 256)       # resilience_resume
OVERHEAD_GRID = (256, 128)      # resilience_overhead (512 there; cut
                                # for the script's 600 s target)
OOM_CONFIGS = 512               # the real OOM's one chunk
FAULT_BACKOFF = dict(base_s=0.0, max_retries=2)
RESULT_FIELDS = SWEEP_FIELDS + ("initial_dpm", "total_capex",
                                "provisioned_mw", "tps_per_provisioned_w",
                                "dollars_per_tps")


def resilience_grid(n_cfg):
    """benchmarks/run.py's `_resilience_grid` (:831-847), the
    `resilience_*` legs' geometry: a pool of 8 traces (MED/HIGH x seeds
    41-44, demand_scale 0.01, end_year 2028) dealt round-robin over
    `n_cfg` configurations, designs alternating 4N/3 and 3+1.  Returns
    (axes, traces)."""
    from repro_torch.core import hierarchy
    from repro_torch.core.arrivals import EnvelopeSpec, generate_fleet_trace
    from repro_torch.core.sweep import SweepAxes
    pool = [(sc, sd) for sc in ("med", "high") for sd in (41, 42, 43, 44)]
    envs_pool = [EnvelopeSpec(demand_scale=0.01, gpu_scenario=sc,
                              end_year=2028) for sc, _ in pool]
    traces_pool = [generate_fleet_trace(e, sd)
                   for e, (_, sd) in zip(envs_pool, pool)]
    idx = [i % len(pool) for i in range(n_cfg)]
    axes = SweepAxes.zip(
        designs=[hierarchy.get_design(("4N/3", "3+1")[i % 2])
                 for i in range(n_cfg)],
        envs=[envs_pool[j] for j in idx],
        seeds=[pool[j][1] for j in idx])
    return axes, [traces_pool[j] for j in idx]


def fault_axes():
    """tests/test_resilience.py's 8 configurations (4N/3 and 3+1 x MED
    and HIGH at scale 0.004, end_year 2028, x seeds 0 and 1)."""
    from repro_torch.core import hierarchy
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.sweep import SweepAxes
    envs = [EnvelopeSpec(demand_scale=RESILIENCE_SCALE, gpu_scenario=sc,
                         end_year=2028) for sc in ("med", "high")]
    return SweepAxes.product(
        designs=[hierarchy.get_design("4N/3"), hierarchy.get_design("3+1")],
        envs=envs, seeds=(0, 1))


def same_fields(a, b, fields, what, rows=None):
    """Every field bitwise equal (NaN patterns included), shapes and
    dtypes too; `rows` restricts the comparison to those configurations."""
    import numpy as np
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if rows is not None:
            x, y = x[rows], y[rows]
        if x.shape != y.shape or x.dtype != y.dtype \
                or x.tobytes() != y.tobytes():
            raise AssertionError(f"{what}: `{f}` differs")


def report_of(report):
    """A `RunReport` as comparable data (the error text aside)."""
    return dict(chunks=(report.n_chunks, report.chunks_computed,
                        report.chunks_resumed),
                retries=report.retries, oom_halvings=report.oom_halvings,
                quarantined=[(q.index, q.reason, q.attempts)
                             for q in report.quarantined])


class CommitTimer:
    """Seconds and counts of the executor's chunk commits
    (`Checkpointer.save`) and resume reads (`Checkpointer.load`) while
    the block runs."""

    def __enter__(self):
        from repro_torch.checkpoint.checkpointer import Checkpointer
        self.saved = (Checkpointer.save, Checkpointer.load)
        self.commit_s, self.commits, self.load_s, self.loads = 0.0, 0, 0.0, 0

        def timed(fn, kind):
            def run(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                setattr(self, kind + "_s", getattr(self, kind + "_s")
                        + time.perf_counter() - t0)
                setattr(self, kind + "s", getattr(self, kind + "s") + 1)
                return out
            return run
        Checkpointer.save = timed(self.saved[0], "commit")
        Checkpointer.load = timed(self.saved[1], "load")
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint.checkpointer import Checkpointer
        Checkpointer.save, Checkpointer.load = self.saved
        return False


def scratch_dir():
    """A fresh checkpoint directory under the checkout's build/."""
    import tempfile
    root = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
    os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(dir=root)


def check_kernel_resilience_shape(dev):
    """The kernel check at the resume grid's chunk: the first 256
    configurations of the 1024-configuration batch, their padded rows."""
    from repro_torch.core.placement import Topology
    from repro_torch.core.sweep import _prepare
    n_cfg, chunk = RESUME_GRID
    axes, traces = resilience_grid(n_cfg)
    jt = _prepare(axes, 0, traces, dev).jt
    jt = Topology(*(x[:chunk] for x in jt))
    N, R = jt.row_cap.shape[:2]
    return dict(rows=f"{N}x{R}", **check_kernel(
        dev, jt, "the resilience grid's chunk"))


def resume_main_path(dev):
    """`resilience_resume` (benchmarks/run.py:899-944): the card's
    one-shot `sweep` of 1024 configurations, then `resilient_sweep` in
    chunks of 256 with a crash after chunk 2 commits, then the resume:
    3 chunks resumed, 1 computed, every field bitwise the one-shot's."""
    import shutil
    import torch
    from repro_torch.core.resilience import (FaultPlan, InjectedCrash,
                                             resilient_sweep)
    from repro_torch.core.sweep import sweep
    from repro_torch.kernels.placement_score.kernel import placement_score
    n_cfg, chunk = RESUME_GRID
    axes, traces = resilience_grid(n_cfg)
    kw = dict(traces=traces, exact_quantiles=False, device=dev)
    one_shot, wall_one = timed_sweep(axes, dev, traces=traces,
                                     exact_quantiles=False)
    ck = scratch_dir()
    try:
        with CommitTimer() as timer:
            placement_score.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                resilient_sweep(axes, chunk_size=chunk, checkpoint_dir=ck,
                                fault_plan=FaultPlan(crash_after=2), **kw)
            except InjectedCrash:
                pass
            else:
                raise AssertionError("resume: the injected crash did not "
                                     "fire")
            torch.cuda.synchronize()
            wall_crash = time.perf_counter() - t0
            crash_launches = placement_score.launches
            commits = (timer.commits, timer.commit_s)
            placement_score.launches = 0
            t0 = time.perf_counter()
            res = resilient_sweep(axes, chunk_size=chunk, checkpoint_dir=ck,
                                  **kw)
            torch.cuda.synchronize()
            wall_resume = time.perf_counter() - t0
            launches = placement_score.launches
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    r = res.report
    if (r.chunks_resumed, r.chunks_computed) != (3, 1) or r.quarantined:
        raise AssertionError(f"resume: {r}")
    if launches != res.event_steps:
        raise AssertionError(f"resume: {launches} placement_score launches "
                             f"for {res.event_steps} placement steps")
    same_fields(res, one_shot, RESULT_FIELDS, "resume vs one-shot sweep")
    wall, busy, n_device, top = profile_run(lambda: sweep(
        axes, traces=traces, exact_quantiles=False, device=dev))
    for name, (calls, secs) in top[:5]:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {name[:90]}")
    print(f"resume grid's one-shot sweep profiled (card activity): "
          f"{wall:.3f} s wall, device busy {busy:.3f} s, idle share "
          f"{1 - busy / wall:.3f}, {n_device} kernels and copies "
          f"({n_device / one_shot.event_steps:.1f} per step)")
    print(f"resume: {len(axes)} configurations (resilience_resume's grid), "
          f"chunks of {chunk} on {res.device}; one-shot sweep "
          f"{wall_one:.3f} s, {one_shot.event_steps} steps "
          f"({wall_one / one_shot.event_steps * 1e3:.3f} ms per step); "
          f"crashed after chunk 2 in {wall_crash:.3f} s, {crash_launches} "
          f"launches ({wall_crash / crash_launches * 1e3:.3f} ms per step), "
          f"{commits[0]} commits {commits[1]:.3f} s "
          f"({commits[1] / commits[0]:.4f} s per chunk); resume "
          f"{wall_resume:.3f} s: 3 chunks resumed (reads "
          f"{timer.load_s:.4f} s), 1 computed, {launches} launches = its "
          f"placement steps ({wall_resume / launches * 1e3:.3f} ms per "
          f"step); every field bitwise the one-shot's")
    return dict(resume=launches, crashed_run=crash_launches,
                one_shot=one_shot.event_steps)


def overhead_legs(dev):
    """`resilience_overhead`'s legs (benchmarks/run.py:851-895), at 256
    configurations (`OVERHEAD_GRID`; 512 there) in chunks of 128 through
    `resilient_sweep`, durability
    off, on, on, off; the results bitwise equal; the on/off ratio of the
    walls printed, not gated (the host moves walls between calls)."""
    import shutil
    import torch
    from repro_torch.core.resilience import resilient_sweep
    from repro_torch.kernels.placement_score.kernel import placement_score
    n_cfg, chunk = OVERHEAD_GRID
    n_chunks = -(-n_cfg // chunk)
    axes, traces = resilience_grid(n_cfg)
    kw = dict(chunk_size=chunk, traces=traces, exact_quantiles=False,
              device=dev)
    walls, runs, commit = {"off": [], "on": []}, [], []
    for leg in ("off", "on", "on", "off"):
        ck = scratch_dir() if leg == "on" else None
        try:
            with CommitTimer() as timer:
                placement_score.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = resilient_sweep(axes, checkpoint_dir=ck, **kw)
                torch.cuda.synchronize()
                walls[leg].append(time.perf_counter() - t0)
        finally:
            if ck:
                shutil.rmtree(ck, ignore_errors=True)
        if placement_score.launches != res.event_steps:
            raise AssertionError("overhead: launches differ from steps")
        if leg == "on":
            if timer.commits != n_chunks or \
                    res.report.chunks_computed != n_chunks:
                raise AssertionError(f"overhead: {timer.commits} commits")
            commit.append(timer.commit_s)
        runs.append(res)
    for res in runs[1:]:
        same_fields(res, runs[0], RESULT_FIELDS, "overhead on vs off")
    off, on = sum(walls["off"]), sum(walls["on"])
    steps = runs[0].event_steps
    print(f"overhead: {len(axes)} configurations in {n_chunks} chunks of "
          f"{chunk}, {steps} placement steps = launches per run; walls off "
          f"{walls['off'][0]:.3f}, {walls['off'][1]:.3f} s, on "
          f"{walls['on'][0]:.3f}, {walls['on'][1]:.3f} s (commits "
          f"{commit[0]:.3f}, {commit[1]:.3f} s for {n_chunks} chunks); "
          f"on/off "
          f"{on / off:.4f}; {off / 2 / steps * 1e3:.3f} ms per step off; "
          f"the four results bitwise equal")
    return steps


FAULT_CASES = {
    # name: (chunk size, FaultPlan keywords, crash then resume)
    "poison": (3, dict(poison=(5,)), False),
    "nan": (3, dict(nan=(2,)), False),
    "transient": (3, dict(fail={1: 2}), False),
    "oom": (3, dict(oom={0: 1}), False),
    "poison_across_kill": (3, dict(poison=(5,), crash_after=1), True),
    "width_1": (1, {}, False),
}


def fault_run(axes, case, device):
    """One FAULT_CASES case through `resilient_sweep` on `device` (after
    a crash, the resumed run)."""
    import shutil
    from repro_torch.core.resilience import (FaultPlan, InjectedCrash,
                                             resilient_sweep)
    from repro_torch.runtime.fault import Backoff
    chunk, plan, crash = FAULT_CASES[case]
    kw = dict(chunk_size=chunk, backoff=Backoff(**FAULT_BACKOFF),
              device=device)
    if not crash:
        return resilient_sweep(axes, fault_plan=FaultPlan(**plan), **kw)
    ck = scratch_dir()
    try:
        try:
            resilient_sweep(axes, checkpoint_dir=ck,
                            fault_plan=FaultPlan(**plan), **kw)
        except InjectedCrash:
            pass
        else:
            raise AssertionError(f"{case}: the injected crash did not fire")
        return resilient_sweep(axes, checkpoint_dir=ck, **kw)
    finally:
        shutil.rmtree(ck, ignore_errors=True)


def fault_cases(dev):
    """The fault cases on tests/test_resilience.py's grid, chunks of 3
    (1 for the width-1 case), on the CPU and on the card: the reports
    equal, the surviving rows bitwise the card's one-shot `sweep`, the
    quarantined rows sentinels."""
    import numpy as np
    import torch
    from repro_torch.core.sweep import sweep
    from repro_torch.kernels.placement_score.kernel import placement_score
    axes = fault_axes()
    one_shot = sweep(axes, device=dev)
    out = []
    for case in FAULT_CASES:
        t0 = time.perf_counter()
        on_cpu = fault_run(axes, case, "cpu")
        t1 = time.perf_counter()
        placement_score.launches = 0
        on_card = fault_run(axes, case, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want, got = report_of(on_cpu.report), report_of(on_card.report)
        if got != want:
            raise AssertionError(f"fault {case}: card report {got} != CPU "
                                 f"report {want}")
        q = on_card.report.quarantined_indices()
        keep = [i for i in range(len(axes)) if i not in q]
        same_fields(on_card, one_shot, RESULT_FIELDS,
                    f"fault {case} (surviving rows vs one-shot)", rows=keep)
        same_fields(on_card, on_cpu, RESULT_FIELDS,
                    f"fault {case} (card vs CPU)")
        for i in q:
            if not (np.isnan(on_card.final_deployed_mw[i])
                    and on_card.n_halls_built[i] == -1
                    and (on_card.reg_rows[i] == -1).all()):
                raise AssertionError(f"fault {case}: row {i} is not a "
                                     "sentinel")
        if placement_score.launches < on_card.event_steps:
            raise AssertionError(f"fault {case}: {placement_score.launches}"
                                 f" launches for {on_card.event_steps} "
                                 "steps")
        out.append(f"{case} {got['quarantined']} retries {got['retries']} "
                   f"halvings {got['oom_halvings']} chunks "
                   f"{got['chunks']} ({placement_score.launches} launches; "
                   f"CPU {t1 - t0:.2f} s, card {t2 - t1:.2f} s)")
    print("faults: " + "; ".join(out) + "; every report equal to the CPU's, "
          "surviving rows bitwise the card's one-shot sweep")


def memory_peak(run):
    """(result, peak reserved bytes) of `run()` from an emptied cache."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = run()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_reserved()


def real_oom(dev):
    """A real CUDA OOM: the resilience grid's 512 configurations
    (`OOM_CONFIGS`) as one chunk, with the caching allocator capped (`set_per_process_memory_
    fraction`) half-way between the measured peaks of the full chunk and
    of its halves, so the full dispatch raises `torch.cuda.OutOfMemory
    Error` and its halves fit; the run must halve, quarantine nothing and
    give the uncapped run's bits."""
    import torch
    from repro_torch.core.resilience import resilient_sweep
    axes, traces = resilience_grid(OOM_CONFIGS)
    kw = dict(traces=traces, device=dev)
    full, peak_full = memory_peak(
        lambda: resilient_sweep(axes, chunk_size=OOM_CONFIGS, **kw))
    halves, peak_half = memory_peak(
        lambda: resilient_sweep(axes, chunk_size=OOM_CONFIGS // 2, **kw))
    same_fields(halves, full, RESULT_FIELDS, "real OOM: halves vs full")
    gap = peak_full - peak_half
    if gap < 4 << 20:
        raise AssertionError(f"real OOM: the full chunk's peak "
                             f"{peak_full} B is only {gap} B above its "
                             "halves'; no cap separates them")
    cap = peak_half + gap // 2
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total, dev)
    try:
        capped, peak_capped = memory_peak(
            lambda: resilient_sweep(axes, chunk_size=OOM_CONFIGS, **kw))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    r = capped.report
    if r.oom_halvings < 1 or r.quarantined:
        raise AssertionError(f"real OOM: {r}")
    same_fields(capped, full, RESULT_FIELDS, "real OOM: capped vs uncapped")
    print(f"real OOM: {OOM_CONFIGS} configurations as one chunk; peak "
          f"reserved "
          f"{peak_full / 2**20:.1f} MiB whole, {peak_half / 2**20:.1f} MiB "
          f"in halves; cap {cap / 2**20:.1f} MiB "
          f"({cap / total:.6f} of {total / 2**30:.1f} GiB); capped run "
          f"{r.oom_halvings} halving(s), no quarantine, peak "
          f"{peak_capped / 2**20:.1f} MiB, bitwise the uncapped run")


def resilient_mc_path(dev):
    """Fig. 6's grid (benchmarks/run.py:146-162) through
    `resilient_mc_sweep` in chunks of 16 configurations (64, 64 and 40
    trials), crashed after chunk 0 commits, then resumed: every output
    and registry bitwise the card's `mc_sweep`."""
    import shutil
    import torch
    from repro_torch.core.mc_sweep import mc_sweep
    from repro_torch.core.resilience import (FaultPlan, InjectedCrash,
                                             resilient_mc_sweep)
    from repro_torch.kernels.placement_score.kernel import placement_score
    axes, kw = mc_figures()["fig6"]
    kw = dict(kw, device=dev)
    one_shot = mc_sweep(axes, **kw)
    ck = scratch_dir()
    try:
        placement_score.launches = 0
        t0 = time.perf_counter()
        try:
            resilient_mc_sweep(axes, chunk_size=16, checkpoint_dir=ck,
                               fault_plan=FaultPlan(crash_after=0), **kw)
        except InjectedCrash:
            pass
        else:
            raise AssertionError("resilient MC: the crash did not fire")
        crash_launches = placement_score.launches
        placement_score.launches = 0
        res = resilient_mc_sweep(axes, chunk_size=16, checkpoint_dir=ck,
                                 **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = placement_score.launches
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    r = res.report
    if (r.n_chunks, r.chunks_resumed, r.chunks_computed) != (3, 1, 2) \
            or r.quarantined:
        raise AssertionError(f"resilient MC: {r}")
    if launches != res.event_steps:
        raise AssertionError(f"resilient MC: {launches} launches for "
                             f"{res.event_steps} steps")
    same_fields(res, one_shot, MC_FIELDS + ("ha_capacity_kw",),
                "resilient MC vs mc_sweep")
    trials = [min(16, len(axes) - i) * kw["n_trials"]
              for i in range(0, len(axes), 16)]
    print(f"resilient MC: Fig. 6's {len(axes)} configurations x "
          f"{kw['n_trials']} trials in chunks of 16 ({trials} trials); "
          f"crash after chunk 0 ({crash_launches} launches), resume "
          f"{r.chunks_resumed} resumed, {r.chunks_computed} computed "
          f"({launches} launches = steps); crash + resume {wall:.3f} s; "
          f"every output and registry bitwise the card's mc_sweep")
    return launches



# ------------------------------------------------------- sharded engines

# benchmarks/run.py's giant_grid (:723-829): configurations (half its
# 10^4 since the second wide model axis took the script's time), chunk
# size, and the hall cap of its temp-memory probe (:799-803)
GIANT_GRID = (5_000, 512)
GIANT_PROBE_HALLS = 128
GIANT_BITWISE_ROWS = 1024   # every (design, trace) pair, the same shapes
GIANT_EXACT_ROWS = 16       # giant_grid.equivalence's sub-grid
GIANT_MEMORY_SLACK = 0.10   # peak allocated, 5 x 10^3 against 512
SPLIT_SCALE = 0.01          # the fleet_study grid at giant_grid's scale


def check_kernel_giant_chunk_shape(dev):
    """The kernel check at giant_grid's chunk: 512 configurations of its
    geometry (the resilience grid's, 720 padded rows each)."""
    from repro_torch.core.sweep import _prepare
    axes, traces = resilience_grid(GIANT_GRID[1])
    jt = _prepare(axes, 0, traces, dev).jt
    N, R = jt.row_cap.shape[:2]
    return dict(rows=f"{N}x{R}", **check_kernel(
        dev, jt, "giant_grid's chunk"))


def allocated_peak(run):
    """(result, the largest rise of allocated memory over what was
    allocated before, over the cards) of `run()`: `max_memory_allocated`
    from reset peaks, less the tensors earlier phases still hold."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    base = []
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
        base.append(torch.cuda.memory_allocated(i))
    res = run()
    torch.cuda.synchronize()
    return res, max(torch.cuda.max_memory_allocated(i) - base[i]
                    for i in range(n))


class PrepareTimer:
    """Seconds spent in `sweep._prepare` (trace-free batch assembly:
    topologies, windows, the staged tensors) while the block runs."""

    def __enter__(self):
        from repro_torch.core import sweep as sweep_mod
        self.saved, self.seconds = sweep_mod._prepare, 0.0

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = self.saved(*args, **kw)
            self.seconds += time.perf_counter() - t0
            return out
        sweep_mod._prepare = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.core import sweep as sweep_mod
        sweep_mod._prepare = self.saved
        return False


def giant_grid_path(dev):
    """giant_grid (benchmarks/run.py:723-829) at `GIANT_GRID`'s size
    through `sharded_sweep` (every visible card): 5 x 10^3 configurations
    in chunks of 512, streaming quantiles; launches equal the summed steps; the
    first 1024 rows bitwise a one-shot `sweep` of them; the first 16
    configurations' streaming p50/p90 within one bucket of an exact
    `sweep`; peak allocated memory within 10% of a 512-configuration
    run's (live memory flat in the grid's size); the exact/streaming
    peak-allocated ratio at the probe grid (128 halls)."""
    import numpy as np
    import torch
    from repro_torch.core import hierarchy
    from repro_torch.core.arrivals import EnvelopeSpec
    from repro_torch.core.sweep import SweepAxes, sharded_sweep, sweep
    from repro_torch.kernels.placement_score.kernel import placement_score
    n_cfg, chunk = GIANT_GRID
    t0 = time.perf_counter()
    axes, traces = resilience_grid(n_cfg)
    axes_s = time.perf_counter() - t0

    def giant():
        with PrepareTimer() as timer:
            placement_score.launches = 0
            t0 = time.perf_counter()
            res = sharded_sweep(axes, traces=traces, exact_quantiles=False,
                                chunk_size=chunk)
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0, timer.seconds, \
            placement_score.launches
    (res, wall, prep_s, launches), peak = allocated_peak(giant)
    steps = res.event_steps
    if launches != steps:
        raise AssertionError(f"giant_grid: {launches} placement_score "
                             f"launches for {steps} placement steps")
    M = len(res.months)
    if res.halls_active.shape != (n_cfg, M) or len(res) != n_cfg:
        raise AssertionError("giant_grid: not one row per configuration")
    if not (np.all(res.n_halls_built >= 1)
            and np.all(np.isfinite(res.final_deployed_mw))
            and np.all((res.placed_fraction >= 0)
                       & (res.placed_fraction <= 1))):
        raise AssertionError("giant_grid: outputs out of range")

    sub, sub_traces = resilience_grid(GIANT_BITWISE_ROWS)
    one_shot, wall_one = timed_sweep(sub, dev, traces=sub_traces,
                                     exact_quantiles=False)
    same_fields(res, one_shot, RESULT_FIELDS,
                f"giant_grid's first {GIANT_BITWISE_ROWS} rows vs a "
                "one-shot sweep", rows=slice(0, GIANT_BITWISE_ROWS))

    n_sub = GIANT_EXACT_ROWS
    exact = sweep(SweepAxes.zip(designs=axes.designs[:n_sub],
                                envs=axes.envs[:n_sub],
                                seeds=axes.seeds[:n_sub]),
                  traces=traces[:n_sub], device=dev)
    gap = 0.0
    for f in ("p50_stranding", "p90_stranding"):
        e, s = getattr(exact, f), getattr(res, f)[:n_sub]
        if not np.array_equal(np.isnan(e), np.isnan(s)):
            raise AssertionError(f"giant_grid: streaming `{f}` NaN months "
                                 "differ from the exact")
        gap = max(gap, float(np.nanmax(np.abs(s - e))))
    if gap > STREAM_TOL:
        raise AssertionError(f"giant_grid: streaming p50/p90 off by {gap} "
                             f"(limit {STREAM_TOL})")

    small, small_traces = resilience_grid(chunk)
    kw = dict(traces=small_traces, exact_quantiles=False, chunk_size=chunk)
    small_res, peak_small = allocated_peak(
        lambda: sharded_sweep(small, **kw))
    same_fields(small_res, res, RESULT_FIELDS, "giant_grid's first chunk "
                "vs a 512-configuration run", rows=slice(0, chunk))
    if abs(peak / peak_small - 1) > GIANT_MEMORY_SLACK:
        raise AssertionError(f"giant_grid: peak allocated {peak} B against "
                             f"{peak_small} B at {chunk} configurations")
    pwall, busy, n_device, top = profile_run(
        lambda: sharded_sweep(small, **kw))

    probe = SweepAxes.zip(
        designs=[hierarchy.get_design(d) for d in ("4N/3", "3+1")],
        envs=[EnvelopeSpec(demand_scale=0.01, gpu_scenario="high")],
        seeds=[41, 42])
    probe_peaks = {}
    for exact_q in (True, False):
        probe_res, probe_peaks[exact_q] = allocated_peak(lambda: sweep(
            probe, n_halls_max=GIANT_PROBE_HALLS, exact_quantiles=exact_q,
            device=dev))
    for name, (calls, secs) in top[:5]:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {name[:90]}")
    print(f"giant_grid: {n_cfg} configurations in chunks of {chunk} on "
          f"{res.device} (streaming quantiles); axes and 8 traces "
          f"{axes_s:.3f} s, _prepare {prep_s:.3f} s; wall {wall:.3f} s, "
          f"{n_cfg / wall:.1f} configurations/s, {steps} placement steps "
          f"= launches ({wall / steps * 1e3:.3f} ms per step, "
          f"{(wall - prep_s) / steps * 1e3:.3f} without _prepare); first "
          f"{GIANT_BITWISE_ROWS} rows bitwise the one-shot sweep "
          f"({wall_one:.3f} s, {one_shot.event_steps} steps); streaming "
          f"p50/p90 within {gap:.3e} of exact on {n_sub} configurations "
          f"(limit {STREAM_TOL:.3e}); peak allocated {peak / 2**20:.1f} "
          f"MiB against {peak_small / 2**20:.1f} MiB at {chunk} "
          f"configurations (ratio {peak / peak_small:.4f}); one chunk "
          f"({chunk} configurations, {small_res.event_steps} steps) "
          f"profiled: {pwall:.3f} s wall, device busy {busy:.3f} s, idle "
          f"share {1 - busy / pwall:.3f}, {n_device} kernels and copies "
          f"({n_device / small_res.event_steps:.1f} per step); probe "
          f"({len(probe)} configurations, {GIANT_PROBE_HALLS} halls, "
          f"{probe_res.event_steps} steps) peak allocated exact "
          f"{probe_peaks[True] / 2**20:.2f} MiB, streaming "
          f"{probe_peaks[False] / 2**20:.2f} MiB, exact/streaming "
          f"{probe_peaks[True] / probe_peaks[False]:.3f}")
    return dict(launches=launches, one_shot_1024=one_shot.event_steps,
                chunk_512=small_res.event_steps)


def split_devices():
    """The device lists the split phases run over: two slabs on card 0,
    and every card when there are several."""
    import torch
    lists = [["cuda:0"] * 2]
    if torch.cuda.device_count() > 1:
        lists.append([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    return lists


def split_main_path(dev):
    """`sharded_sweep` over two slabs of one card (and over every card
    when there are several) on the fleet_study grid at scale 0.01
    (`SPLIT_SCALE`), at mesh shapes (2, 1) and (1, 2) and in chunks of 5;
    then `sharded_mc_sweep` on Fig. 5's grid, flat and on a (1, 2) mesh
    with 15 trials (a remainder); each bitwise the card's `sweep` /
    `mc_sweep`, one launch per placement step of every slab.  The walls
    of two slabs against one are printed, not gated.  (PR 28's run with
    each slab on a host thread, which measured slower than the slabs in
    turn, went in PR 32 for the script's time.)"""
    import torch
    from repro_torch.core.mc_sweep import mc_sweep, sharded_mc_sweep
    from repro_torch.core.sweep import sharded_sweep
    from repro_torch.kernels.placement_score.kernel import placement_score
    axes, _ = fleet_axes(SPLIT_SCALE)
    one, wall_one = timed_sweep(axes, dev)
    mc_axes, mc_kw = mc_figures()["fig5"]
    mc_kw15 = dict(mc_kw, n_trials=mc_kw["n_trials"] - 1)
    mc_one = {16: mc_sweep(mc_axes, device=dev, **mc_kw),
              15: mc_sweep(mc_axes, device=dev, **mc_kw15)}
    launches, lines = {}, []
    for devices in split_devices():
        label = "x".join(devices) if len(set(devices)) > 1 else \
            f"{len(devices)} slabs on {devices[0]}"
        D = len(devices)
        runs = [(f"{D}x1", sharded_sweep, dict(mesh_shape=(D, 1)), one,
                 RESULT_FIELDS),
                (f"1x{D}", sharded_sweep, dict(mesh_shape=(1, D)), one,
                 RESULT_FIELDS),
                ("chunks of 5", sharded_sweep, dict(chunk_size=5), one,
                 RESULT_FIELDS),
                ("MC flat", sharded_mc_sweep, mc_kw, mc_one[16],
                 MC_FIELDS),
                (f"MC 1x{D}, 15 trials", sharded_mc_sweep,
                 dict(mc_kw15, mesh_shape=(1, D)), mc_one[15], MC_FIELDS)]
        walls = {}
        for name, fn, kw, want, fields in runs:
            a = mc_axes if fn is sharded_mc_sweep else axes
            placement_score.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(a, devices=devices, **kw)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            if placement_score.launches != res.event_steps:
                raise AssertionError(f"split {label} {name}: "
                                     f"{placement_score.launches} launches "
                                     f"for {res.event_steps} steps")
            same_fields(res, want, fields, f"split {label} {name}")
            launches[f"{label}: {name}"] = res.event_steps
        lines.append(f"{label}: " + ", ".join(
            f"{k} {v:.3f} s ({launches[f'{label}: {k}']} steps)"
            for k, v in walls.items()))
    print(f"split: fleet_study grid ({len(axes)} configurations at scale "
          f"{SPLIT_SCALE}) one slab {wall_one:.3f} s ({one.event_steps} "
          f"steps); " + "; ".join(lines) + "; every run bitwise the card's "
          "sweep / mc_sweep, one launch per step of every slab")
    return launches


# ---------------------------------------------------------------- ssd_scan

def ssd_inputs(dev, S, seed, nh=80, hd=64, st=128):
    """Mixer-like inputs at the main path's widths: bf16 xdt, B and C,
    float32 log decays from slow heads (tens of steps) to fast ones."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    sp = lambda x: np.logaddexp(x, 0)
    rate = np.exp(rng.uniform(-4, 1, nh))                  # per head
    log_a = -sp(rng.standard_normal((1, S, nh))) * rate
    xdt = 0.5 * rng.standard_normal((1, S, nh, hd))
    b = 0.5 * rng.standard_normal((1, S, st))
    c = 0.5 * rng.standard_normal((1, S, st))
    t = lambda a, dt: torch.as_tensor(a.astype(np.float32), device=dev).to(dt)
    bf = torch.bfloat16
    return t(xdt, bf), t(log_a, torch.float32), t(b, bf), t(c, bf)


def ssd_coefficients(Q, st, nC=1):
    """The bf16 kernel's bounds as multiples of the magnitude sums, with
    the constants above (`ref.split_coefficients`)."""
    from repro_torch.kernels.ssd_scan.ref import split_coefficients
    return split_coefficients(Q, st, nC, u=SSD_SUM_U, split=SSD_SPLIT,
                              majorant=SSD_MAJORANT)


def ssd_bound(S, Q=128, nh=80, hd=64, st=128, in_bytes=2):
    """(bytes, flop) one intra-chunk launch must move and do: each input
    read once (xdt, B and C `in_bytes` an element), each output (y, h, a
    and the prefix sums) written once; y over the causal triangle, C·B
    once per chunk, the decay (sub, exp, mul) per head, the chunk
    state."""
    nC = -(-S // Q)
    Sp = nC * Q
    tri = Q * (Q + 1) // 2
    n_bytes = (Sp * nh * hd * in_bytes + Sp * nh * 4                # in
               + 2 * Sp * st * in_bytes
               + Sp * nh * hd * 4 + nC * nh * hd * st * 4 + nC * nh * 4
               + Sp * nh * 4)
    n_flop = nC * (nh * tri * hd * 2 + tri * st * 2 + nh * tri * 3
                   + nh * Q * hd * st * 2 + nh * Q * hd)
    return n_bytes, n_flop


def ssd_shares(got, plain, majorants, co, which):
    """Shares of the derived bounds (<= 1 passes) of the bf16 kernel's y
    and h against one plain version; a and the prefix sums bitwise."""
    import torch
    ty, th = majorants

    def share(g, w, t, c):
        err = (g - w).abs()
        return float(torch.where(err > 0, err / (c * t), 0.0).max())
    return dict(y=share(got[0], plain[0], ty, co["y_" + which]),
                h=share(got[1], plain[1], th, co["h_" + which]),
                err=float((got[0] - plain[0]).abs().max()),
                exact=torch.equal(got[2], plain[2])
                and torch.equal(got[3], plain[3]))


def ptxas_report(log):
    """{function: registers}, {function: spilled bytes} and the lines of
    `-Xptxas -v` output that name each function's properties."""
    import re
    regs, spills, fn = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spills[fn] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    return regs, spills


def check_ssd_build(lib):
    """The ssd_scan library's build log: no spills in any kernel, no
    ptxas warning C7510-C7515 (wgmma serialised) for the tensor-core
    kernel; prints its register counts."""
    import re
    log = lib.info["log"]
    regs, spills = ptxas_report(log)
    tc = {fn: n for fn, n in regs.items() if "ssd_intra_chunk_tc" in fn}
    serving = [n for fn, n in tc.items() if "tcILi64ELi64ELi128E" in fn]
    warned = [line.strip() for line in log.splitlines()
              if re.search(r"C751[0-5]", line)
              and "ssd_intra_chunk_tc" in line]
    spilled = {fn: n for fn, n in spills.items() if n}
    print(f"build check: ssd_scan: {len(tc)} tensor-core instances, "
          f"{min(tc.values(), default=0)}-{max(tc.values(), default=0)} "
          f"registers; the serving instance (hd 64, st 128) "
          f"{serving} registers; {len(regs) - len(tc)} CUDA-core instances; "
          f"spills {spilled or 'none'}; C7510-C7515 warnings "
          f"{len(warned)}")
    if not tc or len(serving) != 1 or spilled or warned:
        raise AssertionError("ssd_scan build: "
                             + ("; ".join(warned[:3]) or str(spilled)
                                or "tensor-core kernel missing"))


def check_ssd_kernel(dev):
    """The bf16 tensor-core kernel at the serving widths (S 1024 and S 1000,
    padded) against its plain version `split_intra_chunk` and against the
    reference's function, each within its derived bound, and the full scan
    within the bound of the interpret=True scan and SSD_NAIVE_RTOL of the
    naive recurrence; a bf16 shape the tensor cores do not take, and
    float32, on the CUDA-core kernel bitwise; then device times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import kernel as ker
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import (intra_chunk_majorants,
                                                  reference_intra_chunk,
                                                  reference_ssd,
                                                  split_intra_chunk)
    Q, st = 128, 128
    worst = 0.0
    for S in (1024, 1000):
        args = ssd_inputs(dev, S, seed=S)
        pad = (-S) % Q
        padded = [F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in args]
        got = ker.ssd_intra_chunk(*padded, Q)
        torch.cuda.synchronize()
        for g in got:
            if not torch.isfinite(g).all():
                raise AssertionError(f"ssd_scan S={S}: an output is not "
                                     "finite")
        co = ssd_coefficients(Q, st, -(-S // Q))
        majorants = intra_chunk_majorants(*padded, Q)
        split = ssd_shares(got, split_intra_chunk(*padded, Q), majorants, co,
                           "split")
        ref = ssd_shares(got, reference_intra_chunk(*padded, Q), majorants,
                         co, "ref")
        y_k = ops.ssd_scan(*args, chunk=Q)
        y_p = ops.ssd_scan(*args, chunk=Q, interpret=True)
        t_full = ops.ssd_scan(args[0].abs(), args[1], args[2].abs(),
                              args[3].abs(), chunk=Q, interpret=True)
        d_full = (y_k - y_p).abs()
        full = float(torch.where(d_full > 0, d_full / (co["full"] * t_full),
                                 0.0).max())
        worst = max(worst, split["err"])
        print(f"kernel check: ssd_scan S={S} (pad {pad}), 80 heads x 64, "
              f"state 128, chunk {Q}, bf16 inputs, tensor cores: vs its plain "
              f"version (split_intra_chunk) y {split['y']:.3e} and h "
              f"{split['h']:.3e} of the derived bound (y max abs err "
              f"{split['err']:.3e}); vs the reference's function y "
              f"{ref['y']:.3e} and h {ref['h']:.3e} of it (y max abs err "
              f"{ref['err']:.3e}); a and the prefix sums bitwise "
              f"{split['exact'] and ref['exact']}; full scan vs "
              f"interpret=True {full:.3e} of its bound (coefficients "
              + ", ".join(f"{k} {v:.3e}" for k, v in co.items()) + ")")
        if not (max(split["y"], split["h"], ref["y"], ref["h"], full) <= 1
                and split["exact"] and ref["exact"]
                and y_k.shape == (1, S, 80, 64)):
            raise AssertionError(f"ssd_scan S={S}: the bf16 kernel is "
                                 "outside its derived bounds")

    # the CUDA-core kernel: float32, and bf16 at a head dim of 8
    for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 8)):
        xdt, log_a, b, c = ssd_inputs(dev, 256, seed=7)
        xdt = xdt[..., :hd].to(dtype).contiguous()
        b, c = b.to(dtype).contiguous(), c.to(dtype).contiguous()
        if ker.uses_tensor_cores(Q, hd, st, dtype):
            raise AssertionError(f"ssd_scan {dtype} hd={hd}: expected the "
                                 "CUDA-core kernel")
        got = ker.ssd_intra_chunk(xdt, log_a, b, c, Q)
        want = reference_intra_chunk(xdt, log_a, b, c, Q)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"ssd_scan {dtype} hd={hd}: the CUDA-core "
                                 "kernel differs from its plain version")
        print(f"kernel check: ssd_scan S=256, 80 heads x {hd}, {dtype}, "
              f"CUDA cores: all four outputs bitwise its plain version")

    args = ssd_inputs(dev, 256, seed=256)
    y = ops.ssd_scan(*args, chunk=Q)
    naive = reference_ssd(*args)
    err, scale = float((y - naive).abs().max()), float(naive.abs().max())
    if not err <= SSD_NAIVE_RTOL * scale:
        raise AssertionError(f"ssd_scan S=256 vs the naive recurrence: max "
                             f"abs err {err} (max |value| {scale})")
    print(f"kernel check: ssd_scan S=256 full scan vs the naive recurrence: "
          f"max abs err {err:.3e} of max |value| {scale:.3e} (tolerance "
          f"{SSD_NAIVE_RTOL} of it)")

    args = ssd_inputs(dev, 1024, seed=1024)
    ms = device_time_ms(lambda: ker.ssd_intra_chunk(*args, Q), 50)
    plain_ms = device_time_ms(lambda: split_intra_chunk(*args, Q), 3)
    ref_ms = device_time_ms(lambda: reference_intra_chunk(*args, Q), 3)
    wall_ms = cuda_time_ms(lambda: ker.ssd_intra_chunk(*args, Q), 50)
    n_bytes, n_flop = ssd_bound(1024)
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S, n_flop / BF16_FLOP_PER_S
    by = "bytes" if t_bytes >= t_flop else "operations"
    bound_s = max(t_bytes, t_flop)
    f32_s = max(t_bytes, n_flop / FP32_FLOP_PER_S)
    print(f"kernel time: ssd_scan S=1024 bf16: device time per call kernel "
          f"{ms * 1e3:.3f} us (back-to-back wall {wall_ms * 1e3:.3f} us, host "
          f"gaps included), plain version (split_intra_chunk) "
          f"{plain_ms * 1e3:.3f} us, the reference's function "
          f"{ref_ms * 1e3:.3f} us; bound {bound_s * 1e6:.3f} us ({by}: "
          f"{n_bytes} B at 3.35 TB/s = {t_bytes * 1e6:.3f} us, {n_flop} flop "
          f"at 989 TFLOP/s bf16 = {t_flop * 1e6:.3f} us); on the float32 CUDA "
          f"cores (67 TFLOP/s) the bound would be {f32_s * 1e6:.3f} us")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=by)


# ---------------------------------------------------------- flash_attention

def flash_inputs(dev, B, S, H, Hk, hd, dtype, seed):
    """q, k, v in the model's [B, S, heads, hd] layout: unit normals, as
    qk-normed projections give, drawn from a seeded generator on the card
    and cast to `dtype`."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    t = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    return t(B, S, H, hd), t(B, S, Hk, hd), t(B, S, Hk, hd)


def flash_within(got, want, extra=0.0):
    """(max abs err, share of the bound used; <= 1 passes): |got − want|
    <= FLASH_BF16_ULP·|want| + FLASH_F32_RTOL·max |want| + `extra` at
    every element (a tensor or a number)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = FLASH_BF16_ULP * want.abs() + \
        FLASH_F32_RTOL * float(want.abs().max()) + extra
    return float(err.max()), float((err / bound).max())


def flash_bound(B, S, H, Hk, hd, elem):
    """(bytes, flop) of causal attention over S rows: q, k and v read once
    and o written once; 4·hd flop per causal (row, key) pair (q·k and
    p·v), S(S+1)/2 pairs per head."""
    n_bytes = (2 * B * H * S * hd + 2 * B * Hk * S * hd) * elem
    return n_bytes, 4 * hd * B * H * S * (S + 1) // 2


def check_flash_case(dev, B, S, H, Hk, hd, dtype, causal, seed):
    """The kernel through `ops.flash_attention` on the same inputs as its
    plain versions (the tolerances above); raises outside them.  Returns
    the max abs error against the kernel's own plain version."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import rounded_flash_bhsd
    q, k, v = flash_inputs(dev, B, S, H, Hk, hd, dtype, seed)
    before = fk.flash_attention_bhsd.launches
    got = fops.flash_attention(q, k, v, causal=causal)
    ref = fops.flash_attention(q, k, v, causal=causal, interpret=True)
    torch.cuda.synchronize()
    if fk.flash_attention_bhsd.launches != before + 1:
        raise AssertionError("flash_attention: the kernel was not launched")
    if got.shape != (B, S, H, hd) or got.dtype != dtype or \
            not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention {dtype} S={S}: output "
                             f"{tuple(got.shape)} {got.dtype} or not finite")
    block = min(128, max(8, 1 << (S - 1).bit_length()))
    what = (f"flash_attention B={B} S={S} (block {block}, padded "
            f"{-(-S // block) * block}) H={H} Hk={Hk} hd={hd} {dtype} "
            f"{'causal' if causal else 'not causal'}")
    if dtype == torch.float32:
        err = float((got - ref).abs().max())
        share = err / (FLASH_F32_RTOL * float(ref.abs().max()))
        print(f"kernel check: {what}: vs its plain version (the reference's "
              f"function) max abs err {err:.3e}, max |plain| "
              f"{float(ref.abs().max()):.4f}, {share:.3f} of the tolerance")
        if not share <= 1:
            raise AssertionError(f"{what}: kernel vs plain version off by "
                                 f"{err} ({share} of the tolerance)")
        return err
    bhsd = lambda x: x.transpose(1, 2).contiguous()
    plain, slack = rounded_flash_bhsd(bhsd(q), bhsd(k), bhsd(v),
                                      causal=causal, kv_len=S,
                                      with_slack=True)
    got = bhsd(got)
    err, share = flash_within(got, plain, slack)
    _, bare = flash_within(got, plain)
    v_max = bhsd(v).float().abs().amax(dim=(2, 3)).repeat_interleave(
        H // Hk, dim=1)[..., None, None]
    err_ref, share_ref = flash_within(got, bhsd(ref), FLASH_P_ROUND * v_max)
    print(f"kernel check: {what}: vs its plain version (p rounded) max abs "
          f"err {err:.3e}, {share:.3f} of the tolerance ({bare:.3f} of it "
          f"without the flip slack, mean slack {float(slack.mean()):.3e}); "
          f"vs the reference's function max abs err {err_ref:.3e}, "
          f"{share_ref:.3f} of the derived bound")
    if not (share <= 1 and share_ref <= 1):
        raise AssertionError(f"{what}: kernel off its plain version by {err} "
                             f"({share} of the tolerance) or off the "
                             f"reference's function by {err_ref} "
                             f"({share_ref} of the bound)")
    return err


def check_flash_kernel(dev):
    """The kernel against its plain version at the scoring shape in bf16
    and float32, at S 4097 (off the block) and at the smoke shape, causal
    and not; then device times at the scoring shape in bf16: the kernel,
    the plain version and `scaled_dot_product_attention` (the library
    yardstick, never on a path), beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import rounded_flash_bhsd
    B, S, H, Hk, hd = SCORE_BATCH, SCORE_SEQ, 16, 8, 128
    err = check_flash_case(dev, B, S, H, Hk, hd, torch.bfloat16, True, 1)
    check_flash_case(dev, B, S, H, Hk, hd, torch.float32, True, 2)
    check_flash_case(dev, 2, S + 1, H, Hk, hd, torch.bfloat16, True, 3)
    for causal in (True, False):
        for dtype in (torch.float32, torch.bfloat16):
            check_flash_case(dev, 4, 64, 4, 2, 16, dtype, causal, 4)

    q, k, v = (x.transpose(1, 2).contiguous() for x in flash_inputs(
        dev, B, S, H, Hk, hd, torch.bfloat16, 1))
    kw = dict(causal=True, kv_len=S)
    ms = device_time_ms(lambda: fk.flash_attention_bhsd(q, k, v, **kw), 10)
    plain_ms = device_time_ms(lambda: rounded_flash_bhsd(q, k, v, **kw), 2)
    library_ms = device_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True), 10)
    n_bytes, n_flop = flash_bound(B, S, H, Hk, hd, 2)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / BF16_FLOP_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound_s = max(t_bytes, t_ops)
    print(f"kernel time: flash_attention B={B} S={S} H={H} Hk={Hk} hd={hd} "
          f"bf16 causal: device time per call kernel {ms * 1e3:.3f} us, plain "
          f"{plain_ms * 1e3:.3f} us, scaled_dot_product_attention "
          f"{library_ms * 1e3:.3f} us; bound {bound_s * 1e6:.3f} us ({by}: "
          f"{n_flop} flop at 989 TFLOP/s bf16 = {t_ops * 1e6:.3f} us; "
          f"{n_bytes} B at 3.35 TB/s = {t_bytes * 1e6:.3f} us); the same "
          f"flop at 67 TFLOP/s float32 = "
          f"{n_flop / FP32_FLOP_PER_S * 1e6:.3f} us")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=by, library_ms=library_ms)


# -------------------------------------------------------------- moe_gating

GATING_SHAPES = ((128, 16, 2), (100, 64, 6), (256, 32, 8), (64, 8, 1),
                 (1024, 32, 8), (4, 32, 8), (16384, 32, 8), (77, 256, 8),
                 (300, 127, 3))


def gating_logits(dev, N, E, seed):
    """Router-like logits: float32 normals of scale 2 from a seeded
    generator on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return 2.0 * torch.randn((N, E), generator=g, device=dev)


def gating_bound(N, E, k):
    """(bytes, operations) of one launch: logits read once, gates and ids
    written once; per row the max, the subtraction, exp, sum and division
    over E, k compare passes over E, k adds and k divisions."""
    return N * E * 4 + N * k * 8, N * (5 * E + k * E + 2 * k)


def same_bits(a, b):
    """Equal shapes and bits (float32 compared as int32, so NaN counts)."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def check_gating_case(dev, N, E, k, seed):
    """The kernel through `ops.fused_gating` against the plain version on
    the same logits: ids and gates bitwise.  Returns the max gate error
    (0 when bitwise)."""
    import torch
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.kernels.moe_gating import ops as gops
    from repro_torch.kernels.moe_gating.ref import reference_gating
    x = gating_logits(dev, N, E, seed)
    before = gk.gating_topk.launches
    gate, idx = gops.fused_gating(x, k)
    want_gate, want_idx = reference_gating(x, k)
    torch.cuda.synchronize()
    if gk.gating_topk.launches != before + 1:
        raise AssertionError("gating_topk: the kernel was not launched")
    if gate.shape != (N, k) or idx.dtype != torch.int32 or \
            not torch.isfinite(gate).all():
        raise AssertionError(f"gating_topk N={N} E={E} k={k}: output "
                             f"{tuple(gate.shape)} {idx.dtype} or not finite")
    err = float((gate - want_gate).abs().max())
    if not (same_bits(idx, want_idx) and same_bits(gate, want_gate)):
        raise AssertionError(f"gating_topk N={N} E={E} k={k}: not bitwise "
                             f"the plain version (ids equal "
                             f"{torch.equal(idx, want_idx)}, gates max abs "
                             f"err {err:.3e})")
    sums = float((gate.sum(-1) - 1).abs().max())
    print(f"kernel check: gating_topk N={N} E={E} k={k}: ids and gates "
          f"bitwise the plain version's; gate sums within {sums:.3e} of 1")
    return err


def check_gating_non_finite(dev, N, E, k):
    """Rows with a NaN logit, a +inf logit and only -inf logits among
    ordinary rows: ids 0..k-1 and NaN gates, bitwise the plain version's
    (NaN ranks above every number, the first NaN first)."""
    import torch
    from repro_torch.kernels.moe_gating import ops as gops
    from repro_torch.kernels.moe_gating.ref import reference_gating
    x = gating_logits(dev, N, E, N * E)
    x[0::4, E // 2] = float("nan")
    x[1::4, E - 1] = float("inf")
    x[2::4] = float("-inf")
    bad = torch.arange(N, device=dev) % 4 < 3
    gate, idx = gops.fused_gating(x, k)
    want_gate, want_idx = reference_gating(x, k)
    torch.cuda.synchronize()
    ids = torch.arange(k, dtype=torch.int32, device=dev)
    if not torch.equal(idx[bad], ids.expand(int(bad.sum()), k)) or \
            not torch.isnan(gate[bad]).all() or \
            not torch.isfinite(gate[~bad]).all():
        raise AssertionError(f"gating_topk N={N} E={E} k={k}: non-finite "
                             f"rows gave ids {idx[:3].tolist()}, gates "
                             f"{gate[:3].tolist()}")
    if not (same_bits(idx, want_idx) and same_bits(gate, want_gate)):
        raise AssertionError(f"gating_topk N={N} E={E} k={k}: non-finite "
                             "rows not bitwise the plain version")
    print(f"kernel check: gating_topk N={N} E={E} k={k} with {int(bad.sum())} "
          f"rows of NaN, +inf or only -inf logits: ids 0..{k - 1}, NaN gates, "
          f"bitwise the plain version's")


def check_gating_kernel(dev):
    """The kernel against its plain version, bitwise, at the reference
    test's shapes and the main path's (N 1024 per prefill, 4 per decode
    step, and 16384), on non-finite rows and a row of equal logits; then
    device times beside the bound and this card's launch floor."""
    import torch
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.kernels.moe_gating import ops as gops
    from repro_torch.kernels.moe_gating.ref import reference_gating
    worst = max(check_gating_case(dev, N, E, k, seed)
                for seed, (N, E, k) in enumerate(GATING_SHAPES))
    for N, E, k in ((4, 32, 8), (1024, 32, 8), (77, 256, 8), (300, 127, 3)):
        check_gating_non_finite(dev, N, E, k)
    ties = torch.zeros((3, 32), device=dev)
    ties[1] = 1.5
    gate, idx = gops.fused_gating(ties, 8)
    if idx.tolist() != [list(range(8))] * 3 or \
            not torch.equal(gate, torch.full_like(gate, 0.125)):
        raise AssertionError(f"gating_topk: equal logits gave ids "
                             f"{idx.tolist()}, gates {gate.tolist()}")
    print("kernel check: gating_topk on rows of equal logits: ids 0..7, "
          "gates 1/8")
    one = torch.zeros(1, device=dev)
    floor_ms = device_time_ms(lambda: one.add_(1.0), 200)
    times = {}
    for N in (4, 1024, 16384):
        x = gating_logits(dev, N, 32, N)
        ms = device_time_ms(lambda: gk.gating_topk(x, 8), 200)
        plain_ms = device_time_ms(lambda: reference_gating(x, 8), 20)
        n_bytes, n_ops = gating_bound(N, 32, 8)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S
        by = "bytes" if t_bytes >= t_ops else "operations"
        times[N] = dict(ms=ms, plain_ms=plain_ms,
                        bound_ms=max(t_bytes, t_ops) * 1e3, bound_by=by)
        print(f"kernel time: gating_topk N={N} E=32 k=8: device time per "
              f"call kernel {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us; "
              f"bound {max(t_bytes, t_ops) * 1e6:.4f} us ({by}: {n_bytes} B "
              f"at 3.35 TB/s = {t_bytes * 1e6:.4f} us; {n_ops} operations at "
              f"67 TFLOP/s float32 = {t_ops * 1e6:.4f} us); launch floor "
              f"{floor_ms * 1e3:.3f} us (a one-element torch add_)")
    # the JSON line gives the prefill shape, N = 1024 tokens per launch
    return dict(max_abs_err=worst, **times[1024])


# ---------------------------------------------------------------- serving

class Recorder:
    """Stands in for the model in one engine run: passes every call
    through, times each prefill (synchronised) and keeps its logits, and
    keeps whether every logit was finite.  With `margins`, it also keeps
    the top-2 logit margin behind every token it chose, by request."""

    def __init__(self, model, margins=False):
        import torch
        self.model, self.cfg, self.device = model, model.cfg, model.device
        self.logits, self.prefill_s = [], []
        self.finite = torch.ones((), dtype=torch.bool, device=model.device)
        self.engine = None                 # set once the engine exists
        self.margins = [] if margins else None   # (request ids, margins)

    def _margin(self, logits, rids):
        if self.margins is not None:
            top = logits.float().topk(2, dim=-1).values
            self.margins.append((rids, top[..., 0] - top[..., 1]))

    def margins_by_request(self, n):
        """Per request, the margin behind each of its tokens, in order:
        prefills admit requests in submission order, then each decode step
        adds one token to every live slot."""
        out = [[] for _ in range(n)]
        n_prefill = 0
        for rids, m in self.margins:
            m = m.reshape(-1).tolist()
            if rids is None:                  # a prefill: one request
                out[n_prefill].append(m[0])
                n_prefill += 1
            else:
                for rid, v in zip(rids, m):
                    if rid is not None:
                        out[rid].append(v)
        return out

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, params, batch, max_seq):
        import torch
        self._sync()
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(params, batch, max_seq)
        self._sync()
        self.prefill_s.append(time.perf_counter() - t0)
        self.logits.append(logits)
        self.finite &= torch.isfinite(logits).all()
        self._margin(logits[0], None)
        return logits, caches

    def decode_step(self, params, token, pos, caches):
        import torch
        logits, caches = self.model.decode_step(params, token, pos, caches)
        self.finite &= torch.isfinite(logits).all()
        if self.margins is not None:
            self._margin(logits, [None if r is None else r.rid
                                  for r in self.engine.slot_req])
        return logits, caches

    def init_caches(self, batch, max_seq):
        return self.model.init_caches(batch, max_seq)


def serve_once(model, params, prompts, engine_kw, max_new, margins=False):
    """One engine run over `prompts`: outputs, prefill logits, stats and
    times; with `margins`, the top-2 logit margin behind every token."""
    import torch
    from repro_torch.serve.engine import Request, ServeEngine
    rec = Recorder(model, margins)
    engine = ServeEngine(rec, params, **engine_kw)
    rec.engine = engine
    reqs = [Request(rid, p, max_new_tokens=max_new)
            for rid, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    rec._sync()
    t0 = time.perf_counter()
    steps = engine.run_until_drained()
    rec._sync()
    wall = time.perf_counter() - t0
    if not bool(rec.finite):
        raise AssertionError("serving: a logit is not finite")
    if not all(r.done for r in reqs):
        raise AssertionError("serving: a request did not finish")
    return dict(outputs=[list(r.output) for r in reqs],
                logits=torch.cat(rec.logits).float().cpu(),
                stats=dict(engine.stats), steps=steps, wall=wall,
                prefill_s=sum(rec.prefill_s),
                margins=margins and rec.margins_by_request(len(reqs)))


def to_dev(tree, dev):
    return {k: to_dev(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def cast_tree(tree, dtype):
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def serve_golden(dev, arch="mamba2-2.7b", atol=GOLDEN_LOGIT_ATOL):
    """smoke_config() in float32 on the CPU and on the card, same
    weights: the same tokens, prefill logits within `atol`.  Returns the
    largest logit difference."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), use_flash_kernel=True)
    on_cpu = build_model(cfg, "cpu")
    params = on_cpu.init(torch.Generator().manual_seed(0), torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=8)
               for _ in range(GOLDEN_REQUESTS)]
    a = serve_once(on_cpu, params, prompts, GOLDEN_SERVE, GOLDEN_NEW)
    b = serve_once(build_model(cfg, dev), to_dev(params, dev), prompts,
                   GOLDEN_SERVE, GOLDEN_NEW)
    err = float((a["logits"] - b["logits"]).abs().max())
    if a["outputs"] != b["outputs"] or a["stats"] != b["stats"]:
        raise AssertionError("serving golden: tokens differ, CPU vs card")
    if not err <= atol:
        raise AssertionError(f"serving golden: prefill logits differ by "
                             f"{err}, CPU vs card")
    print(f"serving golden: {arch} smoke_config ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}) float32, {GOLDEN_REQUESTS} requests over "
          f"2 slots: CPU "
          f"{a['wall']:.2f} s, card {b['wall']:.2f} s; tokens equal "
          f"({a['stats']}); prefill logits max abs diff {err:.3e} "
          f"(tolerance {atol}) of max |logit| "
          f"{float(a['logits'].abs().max()):.4f}")
    return err


def golden_prompts(cfg):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    return torch.tensor(np.stack([rng.integers(0, cfg.vocab, size=8)
                                  for _ in range(GOLDEN_REQUESTS)]))


def moe_golden_breakdown(dev, gap):
    """Where the MoE smoke golden's CPU-vs-card gap `gap` comes from, and
    how far one wrong route moves the same logits.

    The golden's prompts go through the smoke model's layers (float32,
    flag on) as one batch, with the logits of every position.  Layer by
    layer, each stage also runs on the card from the CPU's input and is
    compared with the CPU's output: the attention block, the router
    logits, the gates (the kernel on the card, the plain version on the
    CPU, on the same logits) and the MoE block; the hidden state's gap is
    also carried through the card's own run.  Then the card runs the
    layers again once for every (layer, token) with that one route wrong
    (the token's k-th expert replaced by its (k+1)-th).  Fails unless the
    ids agree and the golden's gap and the all-position gap stay within
    MOE_GOLDEN_LOGIT_ATOL, below the smallest change a wrong route makes
    in the logits."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.moe_gating.ops import fused_gating
    from repro_torch.kernels.moe_gating.ref import reference_gating
    from repro_torch.models import attention as attn
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import embed_tokens, rms_norm, unembed
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                              use_flash_kernel=True)
    pc = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0),
                                      torch.float32)
    pd = to_dev(pc, dev)
    toks = golden_prompts(cfg)
    d, k, eps = cfg.d_model, cfg.top_k, cfg.norm_eps
    gap_of = lambda a, b: float((a.cpu() - b.cpu()).abs().max())

    def attn_block(p, x):
        cache = attn.init_cache(cfg, x.shape[0], x.shape[1], torch.float32,
                                x.device)
        h = rms_norm(x, p["norm1"], eps)
        return x + attn.prefill_attention(cfg, p["mixer"], h,
                                          lm._positions(x), cache)[0]

    def moe_block(p, a):
        h = rms_norm(a, p["norm2"], eps)
        return h, a + moe_lib.moe_apply(cfg, p["ffn"], h, need_aux=False)[0]

    def layers(params, tokens):
        x = embed_tokens(params["embed"], tokens)
        for i in range(cfg.n_layers):
            x = moe_block(lm._layer(params["blocks"], i),
                          attn_block(lm._layer(params["blocks"], i), x))[1]
        return unembed(cfg, params["embed"], x, eps)

    real = moe_lib.router_topk

    def wrong_route(layer, row):
        calls = [0]

        def router(cfg, p, x, need_aux=True, interpret=False):
            gate, idx, aux = real(cfg, p, x, need_aux, interpret)
            if calls[0] == layer:
                logits = (x @ p["router"].to(x.dtype)).float()
                order = reference_gating(logits, cfg.top_k + 1)[1]
                idx = idx.clone()
                idx[row, -1] = order[row, -1]
            calls[0] += 1
            return gate, idx, aux
        return router

    with torch.no_grad():
        # float32 against float64 on the CPU, stage by stage
        p64 = to_dev(pc, torch.float64)
        x64 = embed_tokens(p64["embed"], toks)
        for i in range(cfg.n_layers):
            l32, l64 = lm._layer(pc["blocks"], i), lm._layer(p64["blocks"], i)
            a64 = attn_block(l64, x64)
            a_err = gap_of(attn_block(l32, x64.float()), a64)
            x64_next = moe_block(l64, a64)[1]
            y_err = gap_of(moe_block(l32, a64.float())[1], x64_next)
            x64 = x64_next
            print(f"moe golden breakdown: layer {i}: float32 vs float64 on "
                  f"the CPU from the float64 input: attention block "
                  f"{a_err:.3e}, MoE block {y_err:.3e}")
        x_c = embed_tokens(pc["embed"], toks)
        x_d = embed_tokens(pd["embed"], toks.to(dev))
        ids_equal = True
        for i in range(cfg.n_layers):
            lc, ld = lm._layer(pc["blocks"], i), lm._layer(pd["blocks"], i)
            q, kk, _ = attn._project_qkv(cfg, lc["mixer"],
                                         rms_norm(x_c, lc["norm1"], eps),
                                         positions=lm._positions(x_c))
            kk = kk.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, 2)
            score = float(torch.einsum("bqhd,bkhd->bhqk", q, kk).abs().max()
                          / cfg.hd ** 0.5)
            a_c = attn_block(lc, x_c)
            a_gap = gap_of(attn_block(ld, x_c.to(dev)), a_c)
            h_c, y_c = moe_block(lc, a_c)
            lg_c = (h_c.reshape(-1, d) @ lc["ffn"]["router"]).float()
            lg_d = (h_c.to(dev).reshape(-1, d) @ ld["ffn"]["router"]).float()
            g_c, i_c = fused_gating(lg_c, k)
            g_d, i_d = fused_gating(lg_c.to(dev), k)
            h_d, x_d = moe_block(ld, attn_block(ld, x_d))
            own = fused_gating((h_d.reshape(-1, d) @ ld["ffn"]["router"])
                               .float(), k)[1]
            same = torch.equal(i_d.cpu(), i_c) and torch.equal(own.cpu(), i_c)
            ids_equal &= same
            y_gap = gap_of(moe_block(ld, a_c.to(dev))[1], y_c)
            x_c = y_c
            print(f"moe golden breakdown: layer {i}: max |q.k|/sqrt(hd) "
                  f"{score:.2f}; card vs CPU from the CPU's input: attention "
                  f"block {a_gap:.3e}, router logits {gap_of(lg_d, lg_c):.3e},"
                  f" gates {gap_of(g_d, g_c):.3e}, MoE block {y_gap:.3e}; "
                  f"ids equal (same logits and the card's own) {same}; "
                  f"hidden carried through the card's run "
                  f"{gap_of(x_d, x_c):.3e} of max |hidden| "
                  f"{float(x_c.abs().max()):.3f}")
        out_c = unembed(cfg, pc["embed"], x_c, eps)
        out_d = unembed(cfg, pd["embed"], x_d, eps)
        all_gap = gap_of(out_d, out_c)
        print(f"moe golden breakdown: unembed from the CPU's input "
              f"{gap_of(unembed(cfg, pd['embed'], x_c.to(dev), eps), out_c):.3e};"
              f" logits at every position carried {all_gap:.3e}, at the "
              f"last {gap_of(out_d[:, -1], out_c[:, -1]):.3e}")

        right = layers(pd, toks.to(dev))
        if not torch.equal(right, out_d):
            raise AssertionError("moe golden: the layer walk is not repeatable")
        changes, last = [], []
        try:
            for layer in range(cfg.n_layers):
                for row in range(toks.numel()):
                    moe_lib.router_topk = wrong_route(layer, row)
                    got = layers(pd, toks.to(dev))
                    moe_lib.router_topk = real
                    changes.append(gap_of(got, right))
                    last.append(gap_of(got[:, -1], right[:, -1]))
        finally:
            moe_lib.router_topk = real
    bound = MOE_GOLDEN_LOGIT_ATOL
    moved = sorted(c for c in changes if c > 0)
    print(f"moe golden breakdown: one wrong route, {len(changes)} cases "
          f"(layer, token): {len(changes) - len(moved)} change nothing (the "
          f"token's choice is dropped at capacity either way); the others "
          f"move the logits at every position by {moved[0]:.3e} at least, "
          f"{moved[len(moved) // 2]:.3e} median; at the last position only "
          f"{sum(c > bound for c in last)} move them by more than the bound "
          f"(the rest are a later token's route in the last layer, or a "
          f"token the last one barely attends to: {min(last):.3e} at least); "
          f"gaps CPU vs card: golden {gap:.3e}, every position "
          f"{all_gap:.3e}; bound {bound}")
    if not ids_equal:
        raise AssertionError("moe golden: the card routed a token otherwise")
    if not max(gap, all_gap) <= bound < moved[0]:
        raise AssertionError("moe golden: the bound does not separate the "
                             "CPU-vs-card gap from a wrong route")


def serve_main_path(dev):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import split_intra_chunk
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(CONFIG, use_flash_kernel=True,
                              n_layers=SERVE_LAYERS[CONFIG.name])
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16)
    torch.cuda.synchronize()
    print(f"serving: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.ssm_heads} SSM heads x {cfg.ssm_headdim}, "
          f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab}:"
          f" {model.n_params():,} bf16 parameters drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=SERVE["prompt_len"])
               for _ in range(SERVE_REQUESTS)]
    serve = lambda m: serve_once(m, params, prompts, SERVE, SERVE_NEW)

    runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        ssd_intra_chunk.launches = 0
        runs.append(serve(model))
        runs[-1]["launches"] = ssd_intra_chunk.launches
    launches = runs[0]["launches"]
    want = runs[0]["stats"]["prefills"] * cfg.n_layers
    if not launches == want == SERVE_REQUESTS * cfg.n_layers:
        raise AssertionError(f"serving: {launches} ssd_scan launches for "
                             f"{runs[0]['stats']['prefills']} prefills")
    if runs[1]["outputs"] != runs[0]["outputs"] or \
            not torch.equal(runs[1]["logits"], runs[0]["logits"]):
        raise AssertionError("serving: a repeat run gave other tokens")
    for out in runs[0]["outputs"]:
        if len(out) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"serving: bad output {out}")
    ssd_intra_chunk.launches = 0
    plain = serve_once(build_model(cfg, dev, interpret=True), params,
                       prompts, SERVE, SERVE_NEW, margins=True)
    # the same run with the kernel's plain version in the reference's
    # place: the model's own reach under a float32 reordering, no kernel
    real_ref = ssd_ops.reference_intra_chunk
    ssd_ops.reference_intra_chunk = split_intra_chunk
    try:
        split = serve(build_model(cfg, dev, interpret=True))
    finally:
        ssd_ops.reference_intra_chunk = real_ref
    if ssd_intra_chunk.launches != 0:
        raise AssertionError("serving: interpret=True launched the kernel")
    gap = lambda r: (r["logits"] - plain["logits"]).abs()
    k_gap, s_gap = gap(runs[0]), gap(split)
    reach = max(SERVE_LOGIT_ATOL, SERVE_GAP_FACTOR * float(s_gap.max()))
    # tokens: equal, or parting only where interpret=True's own top two
    # logits lie within the reach of each other
    parted = []
    for rid, (got, want) in enumerate(zip(runs[0]["outputs"],
                                          plain["outputs"])):
        if got != want:
            t = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            parted.append((rid, t, plain["margins"][rid][t]))
    n_split = sum(a != b for a, b in zip(split["outputs"], plain["outputs"]))
    print(f"serving: prefill logits vs interpret=True: kernel max "
          f"{float(k_gap.max()):.4f}, mean {float(k_gap.mean()):.5f}; its "
          f"plain version (split_intra_chunk, no kernel) max "
          f"{float(s_gap.max()):.4f}, mean {float(s_gap.mean()):.5f}; "
          f"kernel vs plain version max "
          f"{float((runs[0]['logits'] - split['logits']).abs().max()):.4f}; "
          f"reach {reach:.4f}; tokens: {len(parted)} of {SERVE_REQUESTS} "
          f"requests part from interpret=True with the kernel (request, "
          f"first differing token, interpret=True's top-2 logit margin "
          f"there: {parted}), {n_split} with the plain version; smallest "
          f"margin behind any interpret=True token "
          f"{min(min(m) for m in plain['margins']):.3e}")
    if any(not m < reach for _, _, m in parted):
        raise AssertionError("serving: interpret=True gave other tokens "
                             "where its top-2 margin is not below the reach "
                             f"{reach}")
    if not (float(k_gap.max()) <= reach and float(k_gap.mean()) <=
            max(SERVE_LOGIT_ATOL, SERVE_GAP_FACTOR * float(s_gap.mean()))):
        raise AssertionError("serving: prefill logits of the kernel run are "
                             "farther from interpret=True than its plain "
                             "version's allow")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print_serving_runs(runs)
    print(f"serving: ssd_scan launches {launches} (= {SERVE_REQUESTS} "
          f"prefills x {cfg.n_layers} layers); repeat bitwise equal; "
          f"interpret=True run ({plain['wall']:.3f} s wall, prefill "
          f"{plain['prefill_s'] / SERVE_REQUESTS * 1e3:.2f} ms per request); "
          f"every logit finite; peak "
          f"device memory {peak:.2f} GiB; first tokens "
          f"{[o[:4] for o in runs[0]['outputs'][:2]]}")
    # ops.ssd_scan takes the kernel's prefix sums: the cumsums left are the
    # final states' (models/ssm.py `_final_state`), one per layer per prefill
    real, cumsums = torch.cumsum, [0]

    def counted(*args, **kw):
        cumsums[0] += 1
        return real(*args, **kw)
    torch.cumsum = counted
    try:
        profile_serving(lambda: serve(model), "serving")
    finally:
        torch.cumsum = real
    print(f"serving: {cumsums[0]} torch.cumsum calls in the profiled run")
    if cumsums[0] > SERVE_REQUESTS * cfg.n_layers:
        raise AssertionError(f"serving: {cumsums[0]} torch.cumsum calls, "
                             "ssd_scan takes one again")
    return launches


def print_serving_runs(runs, label="serving"):
    for i, r in enumerate(runs):
        st = r["stats"]
        decode_s = r["wall"] - r["prefill_s"]
        print(f"{label} run {i + 1}: {st['prefills']} prefills of "
              f"{SERVE['prompt_len']} tokens, {st['decode_steps']} decode "
              f"steps over {SERVE['batch_slots']} slots, {r['steps']} engine "
              f"steps; wall {r['wall']:.3f} s; prefill "
              f"{r['prefill_s'] / st['prefills'] * 1e3:.2f} ms per request; "
              f"decode {decode_s / st['decode_steps'] * 1e3:.2f} ms per step;"
              f" {st['tokens'] / r['wall']:.1f} tokens/s (prompt + "
              f"generated), {SERVE_REQUESTS * SERVE_NEW / r['wall']:.1f} "
              f"generated tokens/s")


def profile_serving(serve, label):
    """One engine run under the profiler (card activity only): the top
    device kernels and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_run = serve()
        torch.cuda.synchronize()
    busy, by_name = device_activity(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (calls, secs) in top:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {name[:90]}")
    print(f"{label} profiled (card activity): {prof_run['wall']:.3f} s wall, "
          f"device busy {busy:.3f} s, idle share "
          f"{1 - busy / prof_run['wall']:.3f}, "
          f"{sum(c for c, _ in by_name.values())} kernels and copies")
    return busy, by_name


def dense_serve_main_path(dev):
    """qwen3-1.7b at full width behind `ServeEngine`, Mamba2's traffic:
    two runs with equal tokens; prefill and decode take the plain
    attention, as the reference's do, so no kernel is launched."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.qwen3_1p7b import CONFIG
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bhsd
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(CONFIG, use_flash_kernel=True,
                              n_layers=SERVE_LAYERS[CONFIG.name])
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=SERVE["prompt_len"])
               for _ in range(SERVE_REQUESTS)]
    serve = lambda: serve_once(model, params, prompts, SERVE, SERVE_NEW)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_bhsd.launches = 0
    runs = [serve(), serve()]
    if flash_attention_bhsd.launches != 0:
        raise AssertionError("dense serving launched flash_attention; the "
                             "reference's prefill and decode do not")
    if runs[1]["outputs"] != runs[0]["outputs"] or \
            not torch.equal(runs[1]["logits"], runs[0]["logits"]):
        raise AssertionError("dense serving: a repeat run gave other tokens")
    for out in runs[0]["outputs"]:
        if len(out) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"dense serving: bad output {out}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"dense serving: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv_heads} "
          f"K/V heads x {cfg.hd}, bf16 KV caches of {SERVE['max_seq']} "
          f"positions: {model.n_params():,} bf16 parameters")
    print_serving_runs(runs, "dense serving")
    print(f"dense serving: repeat bitwise equal; every logit finite; "
          f"flash_attention launches 0; peak device memory {peak:.2f} GiB; "
          f"first tokens {[o[:4] for o in runs[0]['outputs'][:2]]}")
    profile_serving(serve, "dense serving")
    dense_decode_silu_cost(model, params, prompts)


def dense_decode_silu_cost(model, params, prompts, steps=32, rounds=2):
    """The dense decode step with the SwiGLU's SiLU rounded at each step
    as the reference rounds it (`layers.silu`, four eager ops) against
    `F.silu` (one op, rounding once, as before): host wall per step,
    synchronised, over `steps` steps after one prefill of the slots, in
    `rounds` rounds of turns F.silu, layers.silu, layers.silu, F.silu."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers
    ours = layers.silu
    B, P = SERVE["batch_slots"], SERVE["prompt_len"]
    batch = {"tokens": torch.as_tensor(np.stack(prompts[:B]),
                                       device=model.device)}
    with torch.inference_mode():
        logits, caches = model.prefill(params, batch, SERVE["max_seq"])
        token = logits.argmax(-1)[:, None]

        def per_step(silu):
            layers.silu = silu
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(steps):
                    model.decode_step(params, token, P + i, caches)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / steps
            finally:
                layers.silu = ours

        per_step(ours)
        turns = [(name, per_step(fn)) for _ in range(rounds)
                 for name, fn in (("F.silu", F.silu), ("layers.silu", ours),
                                  ("layers.silu", ours), ("F.silu", F.silu))]
    mean = lambda who: sum(t for n, t in turns if n == who) / (2 * rounds)
    print("dense serving: decode step with the MLP's SiLU as F.silu (before)"
          " and as layers.silu (the reference's rounding), host wall per "
          f"step over {steps} steps, in turns: " + ", ".join(
              f"{name} {t * 1e3:.3f} ms" for name, t in turns) +
          f"; means F.silu {mean('F.silu') * 1e3:.3f} ms, layers.silu "
          f"{mean('layers.silu') * 1e3:.3f} ms")


def moe_serve_main_path(dev):
    """granite-moe-1b-a400m at full width behind `ServeEngine`, Mamba2's
    traffic, use_flash_kernel=True: two runs, each launching gating_topk
    once per layer per prefill and decode step, with equal tokens and
    logits; then a run with the plain router (flag off, no launch) that
    must give the same tokens; then one profiled run."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.granite_moe_1b_a400m import CONFIG
    from repro_torch.kernels.moe_gating.kernel import gating_topk
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(CONFIG, use_flash_kernel=True,
                              n_layers=SERVE_LAYERS[CONFIG.name])
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16)
    torch.cuda.synchronize()
    print(f"moe serving: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv_heads} "
          f"K/V heads x {cfg.hd}, {cfg.n_experts} experts top-{cfg.top_k} "
          f"of d_ff {cfg.d_ff}, vocab {cfg.vocab}: {model.n_params():,} bf16 "
          f"parameters drawn in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=SERVE["prompt_len"])
               for _ in range(SERVE_REQUESTS)]
    serve = lambda m: serve_once(m, params, prompts, SERVE, SERVE_NEW)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        gating_topk.launches = 0
        runs.append(serve(model))
        st = runs[-1]["stats"]
        want = cfg.n_layers * (st["prefills"] + st["decode_steps"])
        if gating_topk.launches != want or st["prefills"] != SERVE_REQUESTS:
            raise AssertionError(f"moe serving: {gating_topk.launches} "
                                 f"gating_topk launches for {st}")
        runs[-1]["launches"] = gating_topk.launches
    if runs[1]["outputs"] != runs[0]["outputs"] or \
            not torch.equal(runs[1]["logits"], runs[0]["logits"]):
        raise AssertionError("moe serving: a repeat run gave other tokens")
    for out in runs[0]["outputs"]:
        if len(out) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"moe serving: bad output {out}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gating_topk.launches = 0
    plain = serve(build_model(dataclasses.replace(cfg, use_flash_kernel=False),
                              dev))
    if gating_topk.launches != 0:
        raise AssertionError("moe serving: the plain router launched the "
                             "kernel")
    if plain["outputs"] != runs[0]["outputs"]:
        raise AssertionError("moe serving: the plain router gave other "
                             "tokens")
    err = float((plain["logits"] - runs[0]["logits"]).abs().max())
    launches = runs[0]["launches"]
    st = runs[0]["stats"]
    print_serving_runs(runs, "moe serving")
    print(f"moe serving: gating_topk launches {launches} (= {cfg.n_layers} "
          f"layers x ({st['prefills']} prefills + {st['decode_steps']} decode "
          f"steps)); repeat bitwise equal; the plain router's run "
          f"({plain['wall']:.3f} s wall) gave the same tokens, prefill "
          f"logits max abs diff {err:.3e}; every logit finite; peak device "
          f"memory {peak:.2f} GiB; first tokens "
          f"{[o[:4] for o in runs[0]['outputs'][:2]]}")
    busy, by_name = profile_serving(lambda: serve(model), "moe serving")
    calls, secs = [sum(v[i] for name, v in by_name.items()
                       if "gating_topk" in name) for i in (0, 1)]
    print(f"moe serving profiled: gating_topk {calls} launches, device time "
          f"{secs * 1e3:.3f} ms per run ({secs / max(calls, 1) * 1e6:.3f} us "
          f"per launch) of {busy * 1e3:.1f} ms busy")
    activation_cost(dev, cfg, runs[0])
    return launches


def activation_cost(dev, cfg, run, reps=2000):
    """What the MoE layer's `silu` (XLA's rounding: four eager ops) costs
    a decode step beside `F.silu` (one op): host wall time per call on the
    decode step's expert activations [slots, E, C 1, d_ff] in bf16, over
    `reps` calls, times the layers, beside the run's decode step."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.layers import silu
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((SERVE["batch_slots"], cfg.n_experts, 1, cfg.d_ff),
                    generator=g, device=dev).to(torch.bfloat16)

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    t_silu, t_f = wall(lambda: silu(a)), wall(lambda: F.silu(a))
    step = (run["wall"] - run["prefill_s"]) / run["stats"]["decode_steps"]
    print(f"moe serving: expert activation at the decode shape "
          f"{list(a.shape)} bf16, host wall per call over {reps} calls: "
          f"layers.silu {t_silu * 1e6:.2f} us, F.silu {t_f * 1e6:.2f} us; x "
          f"{cfg.n_layers} layers = {t_silu * cfg.n_layers * 1e3:.3f} ms vs "
          f"{t_f * cfg.n_layers * 1e3:.3f} ms per decode step of "
          f"{step * 1e3:.2f} ms")


# ---------------------------------------------------------------- scoring

def plain_losses(cfg, dev, params, batch):
    """The bf16 loss of `params` on `batch` without the kernel, three ways:
    L_rounded with the flash op as the bf16 kernel's plain version
    (`rounded_flash_bhsd`, p rounded to bf16), L_plain with interpret=True
    (the reference's function) and L_32 the same on the weights in
    float32.  Launches nothing."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import rounded_flash_bhsd
    from repro_torch.models import attention
    from repro_torch.models.api import build_model
    bhsd = lambda x: x.transpose(1, 2).contiguous()

    def rounded_op(q, k, v, causal=True, **_):
        return bhsd(rounded_flash_bhsd(bhsd(q), bhsd(k), bhsd(v),
                                       causal=causal, kv_len=k.shape[1]))

    plain_model = build_model(cfg, dev, interpret=True)
    op = fops.flash_attention
    attention.fa.flash_attention = rounded_op
    try:
        rounded = float(plain_model.loss(params, batch)[0])
    finally:
        attention.fa.flash_attention = op
    plain = float(plain_model.loss(params, batch)[0])
    loss32 = float(plain_model.loss(cast_tree(params, torch.float32),
                                    batch)[0])
    return rounded, plain, loss32


def check_bf16_loss(what, kernel, rounded, plain, loss32):
    """The kernel's loss against its plain version's within
    SCORE_LOSS_RTOL (they differ in float32 order and where a p rounds to
    the other bf16 neighbour); prints all four losses and whether the
    kernel's p rounding moved the loss from L_plain by no more than the
    bf16 model's own rounding moves it from L_32.  Returns that."""
    gap = abs(kernel - rounded)
    if not gap <= SCORE_LOSS_RTOL * abs(rounded):
        raise AssertionError(f"{what}: loss {kernel} through the kernel vs "
                             f"{rounded} through its plain version")
    allowed = max(SCORE_LOSS_RTOL * abs(plain), abs(plain - loss32))
    held = abs(kernel - plain) <= allowed
    print(f"{what}: L_kernel {kernel:.6f}, L_rounded (its plain version) "
          f"{rounded:.6f}, relative difference {gap / abs(rounded):.3e} "
          f"(tolerance {SCORE_LOSS_RTOL}); L_plain (interpret=True) "
          f"{plain:.6f}, L_32 (float32 weights) {loss32:.6f}: |L_kernel - "
          f"L_plain| {abs(kernel - plain):.3e} vs max({SCORE_LOSS_RTOL} "
          f"|L_plain|, |L_plain - L_32|) = {allowed:.3e}: "
          f"{'within' if held else 'beyond'}")
    return held


def score_golden(dev):
    """qwen3-1.7b smoke_config() scored in float32 on the CPU (the kernel's
    plain version) and on the card (the kernel), same weights and batches:
    losses within SCORE_LOSS_RTOL, one launch per layer per call."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.qwen3_1p7b import smoke_config
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bhsd
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(smoke_config(), use_flash_kernel=True)
    on_cpu = build_model(cfg, "cpu")
    on_card = build_model(cfg, dev)
    params = on_cpu.init(torch.Generator().manual_seed(0), torch.float32)
    card_params = to_dev(params, dev)
    rng = np.random.default_rng(0)
    losses, worst = [], 0.0
    with torch.inference_mode():
        for S in (64, 64, 77):
            tokens = rng.integers(0, cfg.vocab, (SCORE_BATCH, S))
            a, _ = on_cpu.loss(params, {"tokens": torch.as_tensor(tokens)})
            before = flash_attention_bhsd.launches
            b, m = on_card.loss(card_params,
                                {"tokens": torch.as_tensor(tokens,
                                                           device=dev)})
            if flash_attention_bhsd.launches - before != cfg.n_layers:
                raise AssertionError("scoring golden: the card's loss did "
                                     "not launch flash_attention per layer")
            a, b = float(a), float(b)
            rel = abs(a - b) / abs(a)
            if not (np.isfinite(b) and rel <= SCORE_LOSS_RTOL and
                    float(m["tokens"]) == SCORE_BATCH * (S - 1)):
                raise AssertionError(f"scoring golden: loss {b} on the card "
                                     f"vs {a} on the CPU")
            losses.append((a, b))
            worst = max(worst, rel)
    print(f"scoring golden: qwen3-1.7b smoke_config float32, batches of "
          f"{SCORE_BATCH} x 64, 64, 77 tokens: losses CPU vs card "
          f"{[(round(a, 6), round(b, 6)) for a, b in losses]}; max relative "
          f"difference {worst:.3e} (tolerance {SCORE_LOSS_RTOL})")
    params = to_dev(on_cpu.init(torch.Generator().manual_seed(0),
                                torch.bfloat16), dev)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (SCORE_BATCH, 64)), device=dev)}
    with torch.inference_mode():
        kernel = float(on_card.loss(params, batch)[0])
        check_bf16_loss("scoring golden bf16 (smoke_config, 4 x 64)", kernel,
                        *plain_losses(cfg, dev, params, batch))


def score_main_path(dev):
    """`Model.loss` on qwen3-1.7b at full width with use_flash_kernel=True
    under `torch.inference_mode()`: one warm-up call, SCORE_CALLS timed
    calls (the main path's run, flash launches counted), the loss against
    the same model without the kernel (`check_bf16_loss`), then one
    profiled call."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.qwen3_1p7b import CONFIG
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bhsd
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(CONFIG, use_flash_kernel=True)
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16)
    torch.cuda.synchronize()
    print(f"scoring: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv_heads} "
          f"K/V heads x {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
          f"{model.n_params():,} bf16 parameters drawn in "
          f"{time.perf_counter() - t0:.2f} s; batch {SCORE_BATCH} x "
          f"{SCORE_SEQ} tokens")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab,
                                               (SCORE_BATCH, SCORE_SEQ))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    n_tokens = SCORE_BATCH * SCORE_SEQ
    with torch.inference_mode():
        t0 = time.perf_counter()
        float(model.loss(params, batch)[0])
        print(f"scoring warm-up: {time.perf_counter() - t0:.3f} s wall")
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        flash_attention_bhsd.launches = 0
        for _ in range(SCORE_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, metrics = model.loss(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launches = flash_attention_bhsd.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if launches != SCORE_CALLS * cfg.n_layers:
            raise AssertionError(f"scoring: {launches} flash_attention "
                                 f"launches in {SCORE_CALLS} calls")
        if not (np.isfinite(losses[0]) and len(set(losses)) == 1 and
                float(metrics["tokens"]) == SCORE_BATCH * (SCORE_SEQ - 1)):
            raise AssertionError(f"scoring: losses {losses}, tokens "
                                 f"{float(metrics['tokens'])}")
        flash_attention_bhsd.launches = 0
        t0 = time.perf_counter()
        plain = plain_losses(cfg, dev, params, batch)
        plain_wall = time.perf_counter() - t0
        if flash_attention_bhsd.launches != 0:
            raise AssertionError("scoring: the plain runs launched the "
                                 "kernel")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.loss(params, batch)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    busy, by_name = device_activity(prof)
    for i, w in enumerate(walls):
        print(f"scoring call {i + 1}: {w * 1e3:.2f} ms wall, "
              f"{n_tokens / w:.1f} tokens/s, loss {losses[i]:.6f}")
    print(f"scoring: flash_attention launches {launches} (= {SCORE_CALLS} "
          f"calls x {cfg.n_layers} layers); losses bitwise equal across "
          f"calls; peak device memory {peak:.2f} GiB; the three plain runs "
          f"{plain_wall:.3f} s wall")
    check_bf16_loss("scoring", losses[0], *plain)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (calls, secs) in top:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {name[:90]}")
    print(f"scoring profiled call (card activity): {prof_wall:.3f} s wall, "
          f"device busy {busy:.3f} s, idle share {1 - busy / prof_wall:.3f},"
          f" {sum(c for c, _ in by_name.values())} kernels and copies")
    return launches


# ---------------------------------------------------------------------------
# training (no kernel: the reference trains with use_flash_kernel=False)
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m", "mamba2-2.7b")
TRAIN_GOLDEN_OPT = dict(lr=1e-2, warmup_steps=2)
TRAIN_GOLDEN_BATCH = (4, 32)
# Card against CPU, float32 with TF32 off, the same start: the tolerances
# tests/test_torch_train.py holds the port to `repro` with.  Loss rtol
# 1e-5, lr 1e-6, grad_norm 1e-4 (1e-3 on the step through the int8
# compressor, where an element on a rounding boundary moves by one
# quantization step); each moment leaf within TRAIN_MOMENT_TOL of its
# largest element; parameters, which Adam's first steps move by about
# lr·sign(g), within 0.5·Σlr everywhere and within 1e-2·Σlr for all but
# 0.1% of the elements.  Index: step 1 (accum 1), 2 (accum 2), 3 (the
# error-feedback compressor).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_LR_RTOL = 1e-6
TRAIN_GRAD_NORM_RTOL = (1e-4, 1e-4, 1e-3)
TRAIN_MOMENT_TOL = (1e-3, 1e-3, 2e-2)
TRAIN_PARAM_TOL = dict(most=1e-2, share=1e-3, every=0.5)   # × Σlr
# remat "full" against "none" on the card: the same products, so only a
# reduction's order may move a gradient (no wrong route: one MoE token on
# another expert moves its leaves by ~1e-2 of their largest element)
REMAT_GRAD_TOL = 1e-5
# the launcher's resumed losses against the uninterrupted run's: one
# bfloat16 rounding step (2^-8, relative); printed whether bitwise
TRAIN_RESUME_RTOL = 2.0 ** -8
TRAIN_LAUNCH_ARGS = ["--arch", "qwen3-1.7b", "--batch", "4", "--seq", "64",
                     "--lr", "3e-3", "--ckpt-every", "3"]
WIDTH_LAYERS = 2
WIDTH_TOKENS = (1, 64)
TRAIN_MAIN = dict(batch=8, seq=256, lr=3e-3, steps=10)   # 20 until PR 32


def kernel_counters():
    """The launch counters of the four kernels."""
    from repro_torch.kernels.flash_attention import kernel as flash_ker
    from repro_torch.kernels.moe_gating import kernel as gating_ker
    from repro_torch.kernels.placement_score import kernel as ker
    from repro_torch.kernels.ssd_scan import kernel as ssd_ker
    return {"placement_score": ker.placement_score,
            "ssd_scan": ssd_ker.ssd_intra_chunk,
            "flash_attention": flash_ker.flash_attention_bhsd,
            "gating_topk": gating_ker.gating_topk}


def moved(tree, dev):
    """A copy of a tree of tensors on `dev`."""
    from repro_torch.checkpoint.checkpointer import tree_flatten
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([t.to(dev, copy=True) for t in leaves])


def train_three_steps(arch, dev, start):
    """`arch`'s smoke model from `start` (float32 CPU tensors, copied):
    step 1 with accum 1, step 2 with accum 2, step 3 through the
    error-feedback compressor; each step's (params, opt_state, metrics)
    on the CPU."""
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import ef_compress_grads, ef_init
    from repro_torch.train.step import make_train_step
    model = build_model(get_smoke_config(arch), dev)
    params = moved(start, dev)
    opt = adamw.init(params)
    box = {"r": ef_init(params)}

    def compressor(grads, opt_state):
        grads, box["r"] = ef_compress_grads(grads, box["r"])
        return grads, opt_state
    cfg = adamw.AdamWConfig(**TRAIN_GOLDEN_OPT)
    pipe = TokenPipeline(PipelineConfig(*TRAIN_GOLDEN_BATCH,
                                        model.cfg.vocab))
    out = []
    for step, fn in enumerate((make_train_step(model, cfg),
                               make_train_step(model, cfg, 2),
                               make_train_step(model, cfg,
                                               compressor=compressor))):
        batch = {"tokens": torch.as_tensor(pipe._batch_at(step),
                                           device=dev)}
        params, opt, met = fn(params, opt, batch)
        out.append(moved((params, opt, met), "cpu"))
    return out


def leaf_gaps(got, want):
    """max over leaves of max|got − want| / max|want| (CPU tensors)."""
    from repro_torch.checkpoint.checkpointer import tree_flatten
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]))


def param_gaps(got, want, lr_sum):
    """(largest |got − want| / Σlr, share of elements beyond
    TRAIN_PARAM_TOL["most"]·Σlr) over a parameter tree."""
    import torch
    from repro_torch.checkpoint.checkpointer import tree_flatten
    gap = torch.cat([(a.float() - b.float()).abs().flatten() for a, b in zip(
        tree_flatten(got)[0], tree_flatten(want)[0])]) / lr_sum
    return float(gap.max()), float((gap > TRAIN_PARAM_TOL["most"])
                                   .float().mean())


def check_train_step(what, step, got, want, lr_sum):
    """One step's (params, opt_state, metrics), card against CPU, within
    the TRAIN_* tolerances; returns the printed gaps."""
    (p_c, o_c, m_c), (p_h, o_h, m_h) = got, want
    gaps = {k: abs(float(m_c[k]) - float(m_h[k])) / abs(float(m_h[k]))
            for k in ("loss", "grad_norm", "lr")}
    gaps["moments"] = max(leaf_gaps(o_c.mu, o_h.mu),
                          leaf_gaps(o_c.nu, o_h.nu))
    gaps["params"], share = param_gaps(p_c, p_h, lr_sum)
    ok = (sorted(m_c) == sorted(m_h) and int(o_c.step) == int(o_h.step)
          and gaps["loss"] <= TRAIN_LOSS_RTOL
          and gaps["lr"] <= TRAIN_LR_RTOL
          and gaps["grad_norm"] <= TRAIN_GRAD_NORM_RTOL[step]
          and gaps["moments"] <= TRAIN_MOMENT_TOL[step]
          and gaps["params"] <= TRAIN_PARAM_TOL["every"]
          and share <= TRAIN_PARAM_TOL["share"])
    line = (f"loss {gaps['loss']:.2e}, grad_norm {gaps['grad_norm']:.2e}, "
            f"lr {gaps['lr']:.1e}, moments {gaps['moments']:.2e} of the "
            f"leaf's largest, params {gaps['params']:.2e} x sum(lr) "
            f"({share:.1e} beyond {TRAIN_PARAM_TOL['most']})")
    if not ok:
        raise AssertionError(f"{what}, step {step + 1}: card against CPU "
                             f"beyond the tolerances: {line}")
    return line


def remat_grads(arch, dev, remat, params, tokens):
    """The gradients of one loss under `remat` (CPU copies)."""
    import dataclasses
    import torch
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    flat, treedef = tree_flatten(params)
    leaves = [p.detach().clone().requires_grad_() for p in flat]
    loss, _ = build_model(cfg, dev).loss(treedef.unflatten(leaves),
                                         {"tokens": tokens})
    return [g.cpu() for g in torch.autograd.grad(loss, leaves)]


def train_golden(dev):
    """The three smoke families' three steps on the card against the CPU;
    remat "full" against "none" on the card (dense, MoE); the step with
    use_flash_kernel=True raises on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    for arch in TRAIN_ARCHS:
        start = build_model(get_smoke_config(arch), "cpu").init(
            torch.Generator().manual_seed(0), torch.float32)
        card = train_three_steps(arch, dev, start)
        host = train_three_steps(arch, "cpu", start)
        lr_sum = 0.0
        for step, (got, want) in enumerate(zip(card, host)):
            lr_sum += float(want[2]["lr"])
            line = check_train_step(arch, step, got, want, lr_sum)
            print(f"train golden {arch} step {step + 1} "
                  f"({('accum 1', 'accum 2', 'EF compressor')[step]}): "
                  f"loss {float(got[2]['loss']):.6f}; gaps card vs CPU: "
                  f"{line}")
    for arch in TRAIN_ARCHS[:2]:
        cfg = get_smoke_config(arch)
        params = moved(build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(0), torch.float32), dev)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (4, 33)), dtype=torch.int32, device=dev)
        none = remat_grads(arch, dev, "none", params, tokens)
        full = remat_grads(arch, dev, "full", params, tokens)
        gap = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
                  for a, b in zip(full, none))
        same = all(torch.equal(a, b) for a, b in zip(full, none))
        print(f"train golden {arch}: remat full against none on the card, "
              f"largest gradient gap {gap:.3e} of the leaf's largest "
              f"({'bitwise' if same else 'not bitwise'}; tolerance "
              f"{REMAT_GRAD_TOL})")
        if gap > REMAT_GRAD_TOL:
            raise AssertionError(f"train golden {arch}: remat changed the "
                                 f"gradients by {gap}")
    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  use_flash_kernel=True)
        model = build_model(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            torch.float32)
        step = make_train_step(model, adamw.AdamWConfig())
        try:
            step(params, adamw.init(params),
                 {"tokens": torch.zeros(2, 16, dtype=torch.int32,
                                        device=dev)})
        except RuntimeError as exc:
            if "has no backward" not in str(exc):
                raise
        else:
            raise AssertionError(f"train golden {arch}: the step with "
                                 "use_flash_kernel=True did not raise")
    print("train golden: the step with use_flash_kernel=True raises on the "
          "card for all three families")


def train_launcher_path(dev):
    """`launch.train.main` on the card at the smoke size: 6 steps, then
    `--resume` to 9, against an uninterrupted 9-step run."""
    import numpy as np
    from repro_torch.launch import train as train_launch
    cut, full = scratch_dir(), scratch_dir()
    first = train_launch.main(TRAIN_LAUNCH_ARGS + ["--steps", "6",
                                                   "--ckpt-dir", cut])
    resumed = train_launch.main(TRAIN_LAUNCH_ARGS + [
        "--steps", "9", "--ckpt-dir", cut, "--resume"])
    whole = train_launch.main(TRAIN_LAUNCH_ARGS + ["--steps", "9",
                                                   "--ckpt-dir", full])
    if len(first) != 6 or len(resumed) != 3 or len(whole) != 9:
        raise AssertionError(f"train launcher: {len(first)}, "
                             f"{len(resumed)}, {len(whole)} losses")
    gap = float(np.max(np.abs(np.array(resumed) - whole[6:]) /
                       np.abs(whole[6:])))
    bitwise = resumed == whole[6:] and first == whole[:6]
    print(f"train launcher: losses {[round(v, 5) for v in whole]}; resumed "
          f"7-9 {[round(v, 5) for v in resumed]}: largest relative gap "
          f"{gap:.3e} ({'bitwise' if bitwise else 'not bitwise'} on the "
          f"card; tolerance {TRAIN_RESUME_RTOL:.2e})")
    if not (gap <= TRAIN_RESUME_RTOL and all(np.isfinite(whole))):
        raise AssertionError("train launcher: the resumed losses differ")


def train_width_check(dev):
    """qwen3-1.7b's config at full width and WIDTH_LAYERS layers, float32,
    one train step on 1 x 64 tokens on the card against the loss and the
    gradients' norm on the CPU, from the same parameters.  The CPU side
    takes no optimizer step (cut for the script's time once the model zoo
    joined it): AdamW's parity, elementwise per leaf, is `train_golden`'s
    at the smoke widths."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import _value_and_grad
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              n_layers=WIDTH_LAYERS)
    t0 = time.perf_counter()
    tokens = TokenPipeline(PipelineConfig(*WIDTH_TOKENS, cfg.vocab)) \
        ._batch_at(0)
    on_cpu = build_model(cfg, "cpu")
    params = on_cpu.init(torch.Generator().manual_seed(0), torch.float32)
    model, _, step_fn = build_trainer(cfg, *WIDTH_TOKENS, TRAIN_MAIN["lr"],
                                      device=dev)
    card = moved(params, dev)
    _, opt, m_c = step_fn(card, adamw.init(card), {
        "tokens": torch.as_tensor(tokens, device=dev)})
    loss_c, norm_c = float(m_c["loss"]), float(m_c["grad_norm"])
    del card, opt
    loss_h, _, grads = _value_and_grad(on_cpu, params, {
        "tokens": torch.as_tensor(tokens)})
    loss_h, norm_h = float(loss_h), float(adamw.global_norm(grads))
    del params, grads
    loss_gap = abs(loss_c - loss_h) / loss_h
    norm_gap = abs(norm_c - norm_h) / norm_h
    print(f"train width check: {cfg.name} at d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.n_layers} layers, {model.n_params():,} "
          f"float32 parameters, one step on {WIDTH_TOKENS[0]} x "
          f"{WIDTH_TOKENS[1] + 1} tokens: loss {loss_c:.6f} (CPU "
          f"{loss_h:.6f}, gap {loss_gap:.2e}), grad_norm {norm_c:.6f} (CPU "
          f"{norm_h:.6f}, gap {norm_gap:.2e}); "
          f"{time.perf_counter() - t0:.1f} s")
    if not (loss_gap <= TRAIN_LOSS_RTOL and
            norm_gap <= TRAIN_GRAD_NORM_RTOL[0]):
        raise AssertionError("train width check: card against CPU beyond "
                             "the tolerances")


def train_main_path(dev):
    """Qwen3-1.7B at full width and depth (bf16, remat "full", its
    config's default) through `build_trainer`, TRAIN_MAIN["steps"] steps
    on `TokenPipeline` batches as the launcher's `one_step` builds them,
    then one profiled step."""
    import statistics
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim import adamw
    cfg = get_config("qwen3-1.7b")
    B, S = TRAIN_MAIN["batch"], TRAIN_MAIN["seq"]
    model, _, step_fn = build_trainer(cfg, B, S, TRAIN_MAIN["lr"],
                                            device=dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw.init(params)
    torch.cuda.synchronize()
    state_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    print(f"train main path: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, remat {cfg.remat}: "
          f"{model.n_params():,} bf16 parameters and float32 moments, "
          f"{state_gib:.2f} GiB, drawn in {time.perf_counter() - t0:.2f} s; "
          f"batch {B} x {S + 1} tokens, lr {TRAIN_MAIN['lr']}")
    pipe = TokenPipeline(PipelineConfig(B, S, cfg.vocab))

    def one_step(step):
        nonlocal params, opt
        batch = {"tokens": torch.as_tensor(pipe._batch_at(step),
                                           device=dev)}
        params, opt, metrics = step_fn(params, opt, batch)
        return metrics

    walls, history = [], []
    t_all = time.perf_counter()
    for step in range(TRAIN_MAIN["steps"]):
        t0 = time.perf_counter()
        history.append(one_step(step))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    dt = time.perf_counter() - t_all
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    losses = [float(h["loss"]) for h in history]
    norms = [float(h["grad_norm"]) for h in history]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step(TRAIN_MAIN["steps"])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, by_name = device_activity(prof)
    tokens = B * S * len(history)
    print(f"train main path: losses {losses[0]:.4f} .. {losses[-1]:.4f} "
          f"({[round(v, 4) for v in losses]}); grad_norm {norms[0]:.4f} .. "
          f"{norms[-1]:.4f}")
    print(f"train main path: step 1 {walls[0] * 1e3:.1f} ms, steps 2-"
          f"{len(walls)} median {statistics.median(walls[1:]) * 1e3:.1f} ms "
          f"(min {min(walls[1:]) * 1e3:.1f}, max {max(walls[1:]) * 1e3:.1f});"
          f" {tokens / dt:,.0f} tokens/s (batch x seq x steps / wall, as the "
          f"launcher counts); peak allocated {peak:.2f} GiB above the "
          f"{base / 2 ** 30:.2f} GiB held before it")
    for name, (calls, secs) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1])[:10]:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {name[:90]}")
    print(f"train main path profiled step: {prof_wall * 1e3:.1f} ms wall, "
          f"device busy {busy * 1e3:.1f} ms, idle share "
          f"{1 - busy / prof_wall:.3f}, "
          f"{sum(c for c, _ in by_name.values())} kernels and copies")
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(norms))
            and losses[-1] < losses[0]):
        raise AssertionError(f"train main path: losses {losses}, grad_norm "
                             f"{norms}")
    del params, opt
    torch.cuda.empty_cache()


def training_section(dev, timings):
    """The training phases, with every kernel's launch count held at 0."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    for name, phase in (("train golden", train_golden),
                        ("train launcher", train_launcher_path),
                        ("train width check", train_width_check),
                        ("train main path", train_main_path)):
        t0 = time.perf_counter()
        phase(dev)
        timings[name] = time.perf_counter() - t0
    launched = {k: c.launches for k, c in counters.items()}
    print(f"training: kernel launches {launched} (all 0: the reference "
          f"trains with its kernels off)")
    if any(launched.values()):
        raise AssertionError(f"training launched kernels: {launched}")


# ---------------------------------------------------------------------------
# training over several ranks: data parallel with ZeRO-1 moments, and the
# collectives, the pipeline and resharding at smoke size on the same ranks
# ---------------------------------------------------------------------------

# Qwen3-1.7B at full width and 4 of its 28 layers (28 layers and 5 steps
# until the tensor-parallel path came, 14 and 3 until serving over ranks
# came, 7 until the second wide model axis came), the global batch of
# 8 x 256 split over the ranks, 2 steps under pure_dp_rules(False), whose
# opt_rules shard the moments over "data" (ZeRO-1)
DP_MAIN = dict(batch=8, seq=256, lr=3e-3, steps=2, layers=4)
DP_NAMES = ("pod", "data", "model")
# The first step's loss against the one-process step on the same
# (concatenated) global batch.  Both run the same bf16 model on the same
# card; only the rows a product sees differ (4 per rank against 8), so
# cuBLAS may tile the sums otherwise.  The ports' bf16 gaps from other
# reduction orders stay below 8.3e-4 (ROADMAP.md, queue 3's checks).
DP_LOSS_RTOL = 1e-3
# the pipeline's smoke stack: 2 tanh layers of width 64 per stage, 8 rows
# in 4 microbatches; float32 (TF32 off), `tests/test_pipeline.py`'s
# tolerances against the sequential stack
DP_PIPE = dict(layers_per_stage=2, d=64, rows=8, microbatches=4)
PIPE_ATOL, PIPE_GRAD_ATOL = 1e-5, 1e-4


def dp_layouts():
    """(backend, device, ranks): two gloo ranks sharing card 0 (NCCL
    refuses two ranks on one card), and one NCCL rank per card where
    there are several."""
    import torch
    out = [("gloo", "cuda:0", 2)]
    if torch.cuda.device_count() > 1:
        out.append(("nccl", "cuda", torch.cuda.device_count()))
    return out


def _mlp_stage(p, x):
    import torch
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def dp_smoke_checks(rank, world, dev, mesh, rules):
    """At smoke size on the phase's ranks: `compressed_psum` on card
    tensors against the same call on CPU tensors (a gloo group), bitwise;
    a `world`-stage pipeline against the sequential stack, outputs and
    gradients; one ZeRO-1 step of qwen3's smoke model, then `reshard`
    onto a survivors mesh of rank 0 alone, every leaf bitwise."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.runtime import elastic
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    from repro_torch.train.pipeline import pipeline, split_stages
    from repro_torch.train.step import make_train_step, opt_shardings
    out = {}
    host = dist.new_group(backend="gloo")
    x = np.random.default_rng(rank).standard_normal((64, 33)) * (1 + rank)
    card = compressed_psum(torch.as_tensor(x, dtype=torch.float32,
                                           device=dev))
    cpu = compressed_psum(torch.as_tensor(x, dtype=torch.float32), host)
    out["psum_bitwise"] = card.cpu().numpy().tobytes() == cpu.numpy().tobytes()

    L, d = DP_PIPE["layers_per_stage"] * world, DP_PIPE["d"]
    rng = np.random.default_rng(7)
    w = torch.as_tensor(rng.standard_normal((L, d, d)) * 0.3 / 8 ** 0.5,
                        dtype=torch.float32, device=dev)
    b = torch.as_tensor(rng.standard_normal((L, d)) * 0.1,
                        dtype=torch.float32, device=dev)
    xs = torch.as_tensor(rng.standard_normal((DP_PIPE["rows"], d)),
                         dtype=torch.float32, device=dev)
    stage_mesh = DeviceMesh(dev.type, torch.arange(world),
                            mesh_dim_names=(ax.STAGE_AXIS,))
    staged = split_stages({"w": w.clone(), "b": b.clone()}, world)
    for a in staged.values():
        a.requires_grad_()
    y = pipeline(_mlp_stage, stage_mesh,
                 n_microbatches=DP_PIPE["microbatches"])(staged, xs)
    gw, gb = torch.autograd.grad(torch.sum(y ** 2),
                                 [staged["w"], staged["b"]])
    gw, gb = ranks.all_sum_(gw.clone()), ranks.all_sum_(gb.clone())
    full = {"w": w.clone().requires_grad_(), "b": b.clone().requires_grad_()}
    seq = _mlp_stage(full, xs)
    sw, sb = torch.autograd.grad(torch.sum(seq ** 2), [full["w"], full["b"]])
    out["pipe_err"] = float((y - seq).detach().abs().max())
    out["pipe_grad_err"] = max(float((gw.reshape(sw.shape) - sw).abs().max()),
                               float((gb.reshape(sb.shape) - sb).abs().max()))

    model = build_model(get_smoke_config("qwen3-1.7b"), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.float32)
    opt = adamw.init(params, opt_shardings(model, mesh, rules))
    step = make_train_step(model, adamw.AdamWConfig(lr=1e-2, warmup_steps=2),
                           mesh=mesh, rules=rules)
    pipe = TokenPipeline(PipelineConfig(8 // world, 32, model.cfg.vocab,
                                        shard_id=rank, num_shards=world))
    params, opt, _ = step(params, opt, {"tokens": torch.as_tensor(
        pipe._batch_at(0), device=dev)})
    full_mu = [ranks.gather_dtensor(m) for m in tree_flatten(opt.mu)[0]]
    axes = model.param_axes()
    new = elastic.survivors_mesh(list(range(1, world)), (1, 1, 1), DP_NAMES,
                                 dev.type)
    p_new = elastic.reshard(params, axes, new, rules)
    mu_new = elastic.reshard(opt.mu, axes, new, ax.opt_rules(rules, True))
    out["moments_sharded"] = sum(
        m.to_local().numel() < m.numel() for m in tree_flatten(opt.mu)[0])
    if rank == 0:
        out["reshard_bitwise"] = all(
            torch.equal(a.to_local(), b) for a, b in
            zip(tree_flatten(p_new)[0] + tree_flatten(mu_new)[0],
                tree_flatten(params)[0] + full_mu))
    return out


def dp_train_rank(rank, world, dev):
    """One rank of `dp_train_path`: on rank 0 PR 29's one-process step
    from a copy of the weights on the concatenated global batch (for the
    first step's loss), then DP_MAIN's steps under `pure_dp_rules(False)`
    on a (1, world, 1) mesh with ZeRO-1 moments, the last of them
    profiled on rank 0, the parameters' checksums across the ranks, then
    `dp_smoke_checks`.  Returns numbers only."""
    import contextlib
    import gc
    import statistics
    from dataclasses import replace
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    from repro_torch.train.step import make_train_step, opt_shardings
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    cfg = replace(get_config("qwen3-1.7b"), n_layers=DP_MAIN["layers"])
    B, S, steps = DP_MAIN["batch"], DP_MAIN["seq"], DP_MAIN["steps"]
    mesh = make_test_mesh((1, world, 1), DP_NAMES, dev.type)
    rules = ax.pure_dp_rules(False)
    opt_cfg = adamw.AdamWConfig(lr=DP_MAIN["lr"])
    model = build_model(cfg, dev)
    pipes = [TokenPipeline(PipelineConfig(B // world, S, cfg.vocab,
                                          shard_id=k, num_shards=world))
             for k in range(world)]
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    out = {}
    if rank == 0:       # the same weights, one process, global batch
        leaves, treedef = tree_flatten(params)
        ref = treedef.unflatten([p.clone() for p in leaves])
        glob = np.concatenate([p._batch_at(0) for p in pipes])
        met = make_train_step(model, opt_cfg)(
            ref, adamw.init(ref), {"tokens": torch.as_tensor(
                glob, device=dev)})[2]
        out["one_process"] = {k: float(met[k]) for k in ("loss",
                                                         "grad_norm")}
        del leaves, ref, met
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    opt = adamw.init(params, opt_shardings(model, mesh, rules))
    step_fn = make_train_step(model, opt_cfg, mesh=mesh, rules=rules)
    moment_bytes = 4 * sum(m.to_local().numel()
                           for m in tree_flatten((opt.mu, opt.nu))[0])

    def one_step(step):
        nonlocal params, opt
        batch = {"tokens": torch.as_tensor(pipes[rank]._batch_at(step),
                                           device=dev)}
        params, opt, metrics = step_fn(params, opt, batch)
        return metrics

    for c in counters.values():
        c.launches = 0
    walls, history = [], []
    dist.barrier()      # the ranks start the timed steps together
    t_all = time.perf_counter()
    for step in range(steps):
        profiled = rank == 0 and step == steps - 1
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            history.append({k: float(v) for k, v in one_step(step).items()})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    out.update(
        walls=walls, wall=wall, history=history,
        peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        base_gib=base / 2 ** 30, moment_gib=moment_bytes / 2 ** 30,
        launches={k: c.launches for k, c in counters.items()},
        median_ms=statistics.median(walls[1:]) * 1e3)
    if rank == 0:
        busy, by_name = device_activity(prof)
        out.update(prof_wall=walls[-1], busy=busy, top=sorted(
            ((n, c, t) for n, (c, t) in by_name.items()),
            key=lambda e: -e[2])[:6])
    sums = torch.stack([torch.stack((
        p.view(torch.int16).sum(dtype=torch.int64),
        p.view(torch.int16).flatten()[1::7].sum(dtype=torch.int64)))
        for p in tree_flatten(params)[0]]).flatten()
    hi = ranks.all_max_(sums.clone())
    lo = -ranks.all_max_(-sums)
    out["params_equal"] = bool(torch.equal(hi, lo))
    del params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    out.update(dp_smoke_checks(rank, world, dev, mesh, rules))
    return out


def dp_train_path(timings):
    """Qwen3-1.7B trained data-parallel with ZeRO-1 moments on each of
    `dp_layouts`' rank sets (`spawn_ranks`, one process per rank), with
    the smoke checks beside it; fails on any rank's error or failed
    check."""
    import gc
    import numpy as np
    import torch
    from repro_torch.sharding.ranks import spawn_ranks
    B, S, steps = DP_MAIN["batch"], DP_MAIN["seq"], DP_MAIN["steps"]
    # the serving phases' engines hold their weights in reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    print(f"dp train path: this process holds "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved on "
          f"card 0 before the ranks start")
    for backend, device, world in dp_layouts():
        label = (f"{backend}, {world} ranks on "
                 + (device if ":" in device else f"{world} cards"))
        t0 = time.perf_counter()
        res = spawn_ranks(dp_train_rank, world, backend, device)
        secs = time.perf_counter() - t0
        r0 = res[0]
        first = r0["history"][0]
        one = r0["one_process"]
        gap = abs(first["loss"] - one["loss"]) / abs(one["loss"])
        norm_gap = abs(first["grad_norm"] - one["grad_norm"]) / one[
            "grad_norm"]
        losses = [h["loss"] for h in r0["history"]]
        tokens = B * S * steps
        print(f"dp train path ({label}): Qwen3-1.7B full width, "
              f"{DP_MAIN['layers']} layers, "
              f"global batch {B} x {S}, {steps} steps, pure_dp_rules(False) "
              f"with ZeRO-1 moments; losses {[round(v, 4) for v in losses]}")
        for r, rr in enumerate(res):
            walls = [round(w * 1e3, 1) for w in rr["walls"]]
            print(f"  rank {r}: steps {walls} ms; peak allocated {rr['peak_gib']:.2f} GiB above "
                  f"{rr['base_gib']:.2f} GiB of bf16 parameters; its moments "
                  f"{rr['moment_gib']:.2f} GiB (ZeRO-1); kernel launches "
                  f"{rr['launches']}")
        for name, calls, t in r0["top"]:
            print(f"  device {t:8.4f} s {calls:8d} calls  {name[:90]}")
        print(f"dp train path ({label}): step 1 {r0['walls'][0] * 1e3:.1f} "
              f"ms, steps 2-{steps} median {r0['median_ms']:.1f} ms; "
              f"{tokens / r0['wall']:,.0f} tokens/s (global batch x seq x "
              f"steps / wall, as the launcher counts); rank 0's profiled "
              f"step {steps} {r0['prof_wall'] * 1e3:.1f} ms wall, its device "
              f"busy {r0['busy'] * 1e3:.1f} ms, idle share "
              f"{1 - r0['busy'] / r0['prof_wall']:.3f}; first-step loss "
              f"{first['loss']:.6f} against the one-process step's "
              f"{one['loss']:.6f} (relative {gap:.3e}, gated at "
              f"{DP_LOSS_RTOL}), grad_norm {first['grad_norm']:.6f} against "
              f"{one['grad_norm']:.6f} (relative {norm_gap:.3e}); params "
              f"bitwise equal across ranks "
              f"{all(r['params_equal'] for r in res)}; compressed_psum card "
              f"== CPU bitwise {all(r['psum_bitwise'] for r in res)}; "
              f"{world}-stage pipeline max |err| "
              f"{max(r['pipe_err'] for r in res):.3e} (atol {PIPE_ATOL}), "
              f"gradients {max(r['pipe_grad_err'] for r in res):.3e} (atol "
              f"{PIPE_GRAD_ATOL}); reshard onto 1 survivor bitwise "
              f"{r0['reshard_bitwise']}; {secs:.1f} s")
        ok = (gap <= DP_LOSS_RTOL and all(np.isfinite(losses))
              and all(r["params_equal"] and r["psum_bitwise"] and
                      r["pipe_err"] <= PIPE_ATOL and
                      r["pipe_grad_err"] <= PIPE_GRAD_ATOL and
                      r["moments_sharded"] > 0 and
                      not any(r["launches"].values()) for r in res)
              and r0["reshard_bitwise"])
        timings[f"dp train {backend}"] = secs
        if not ok:
            raise AssertionError(f"dp train path ({label}) failed its checks")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# tensor and expert parallelism over "model", and FSDP: the loss and the
# train step on each rank's blocks
# ---------------------------------------------------------------------------

# Each arch at full width under base_rules(False) on (1, W/2, 2) with
# opt_rules' ZeRO-1 moments, remat "full", the global batch 8 x 256:
# Qwen3-1.7B at 4 of its 28 layers, 2 steps (14 and 3 until serving over
# ranks came, 7 until the second wide model axis came), bf16;
# granite-moe at 4 of 24, 2 steps (E 32 over 2 ranks, its router's
# gathered logits, vocab 49155 replicated: it does not divide), float64.
# At this random init on the Zipf batch granite's gradient follows its
# near-tied top-k routes, so any rounding moves it: on an H100 80GB HBM3
# at 700 W `probes/tp_grads.py` read, in float32, 8 of 2056 token rows
# of layer 3 rerouted and each leaf's gradient 14-42% from one
# process's (15-48% at capacity factor E/k, where no choice is dropped;
# ±1e-6 on one leaf moved them 7-13%), while in float64 the routes agree
# and every leaf lies within 2.8e-7 of one process's.  So granite trains
# in float64, where its gradients are gated per leaf (TP_LEAF_RTOL).
# Its TP scoring call, whose flash takes bf16 and float32, runs on
# float32 weights from the same seed.
TP_MAIN = {"qwen3-1.7b": dict(layers=4, steps=2, dtype="bfloat16"),
           "granite-moe-1b-a400m": dict(layers=4, steps=2, dtype="float64")}
TP_BATCH = (8, 256)
# warmup 1: step 1 updates at the full lr, above a bf16 ulp for most
# weights (lr 3e-3 made Qwen3's losses climb on the same H100 80GB HBM3
# at 700 W: 12.69, 14.79, 20.69)
TP_OPT = dict(lr=3e-4, warmup_steps=1)
# The first step's loss and grad_norm against the one-process step on the
# same global batch, same card, bf16: the ranks sum their heads' and MLP
# columns' partial products in bf16 before the reduce-scatter, where one
# device sums them inside one product (DP_LOSS_RTOL's reasoning); the
# gradient norm sums 1.3e9 such squares.
TP_LOSS_RTOL, TP_GRAD_NORM_RTOL = 1e-3, 1e-2
# Each leaf's gradient as the step hands it to AdamW against one
# process's, |tp - one| / |one|, in float64, where roundings leave the
# routes alone: the forward's float32 casts (router logits, the norms'
# statistics, RoPE, the cross-entropy's logits) round the two sides'
# float64 sums apart by ~6e-8, and `probes/tp_grads.py` read at most
# 2.8e-7 (H100 80GB HBM3, 700 W); a wrong block or gradient is O(1).
# float32 (Mamba2's steps in `tp_serve_path`): the forward's float32 sums
# reorder by ~1e-7 and eight random layers may amplify that ~10³, where a
# wrong block or gradient is O(1).
TP_LEAF_RTOL = {"float64": 1e-5, "float32": 1e-3}
# After step 1 each parameter element against the one-process step's, in
# units of lr beyond two ulps of the element in its type (each side's
# store rounds once): Adam's first update is lr·(sign(g) + wd·p) wherever
# |g| >> eps, so this reads the gradients' signs, and two runs from the
# same init differ by at most about 2·lr whatever their gradients.  A
# sign that differs moves an element by up to 2·lr: the bf16 sums do so
# to gradients within their rounding of 0, on a few elements of a leaf
# (Qwen3: 2.6e-3 of a leaf), where a rank's block of a wrong or lost
# gradient moves about half of its leaf (`probes/tp_share.py`).  So in
# every leaf a share of at most TP_PARAM_SHARE beyond PARAM_TOL's
# 1e-2·lr.
TP_PARAM_SHARE = 5e-2
# The TP scoring call with the kernels (flash on each rank's heads, the
# gating kernel on the gathered router logits) against the same call on
# the same blocks with the plain attention and router: float32 within
# 1e-4 (a near-tied route that rounds the other way moves granite's
# float32 loss by ~1.5e-5: its one-process and two-rank scoring calls),
# bf16 within TP_LOSS_RTOL by its reasoning.
TP_FLASH_RTOL = {"float32": 1e-4, "bfloat16": TP_LOSS_RTOL}
# The smoke checks, card ranks against CPU ranks in float32: the loss
# within 1e-5, `grad_norm` 1e-4, each moment leaf within MOMENT_TOL of its
# largest element, and at most PARAM_TOL's share of the parameters beyond
# 1e-2·lr (the same sign flips: on the same card granite's FSDP step put
# one element 0.65·lr apart, a float32 gradient within its rounding of 0)
TP_SMOKE_PARAM_TOL = dict(most=1e-2, share=1e-3)
TP_SMOKE_MOMENT_TOL = 1e-3


def tp_layouts():
    """(backend, device, ranks): two gloo ranks sharing card 0, and one
    NCCL rank per card where an even number of cards is visible (gloo
    beside it for the CPU meshes of `tp_smoke_checks`)."""
    import torch
    out = [("gloo", "cuda:0", 2)]
    n = torch.cuda.device_count()
    if n > 1 and n % 2 == 0:
        out.append(("cpu:gloo,cuda:nccl", "cuda", n))
    return out


def tp_param_gaps(params, ref, lr):
    """(the largest share of a leaf's elements beyond 1e-2·lr, that
    leaf's index) of each rank's gathered parameter blocks against rank
    0's one-process parameters `ref` (None elsewhere), in units of lr
    beyond two ulps of the one-process element in its type."""
    import torch
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.sharding import ranks
    share, which = 0.0, None
    for i, p in enumerate(tree_flatten(params)[0]):
        full = ranks.gather_dtensor(p)
        if ref is None:
            continue
        want = ref[i].float()
        ulps = 2 * torch.finfo(ref[i].dtype).eps * want.abs()
        gap = torch.clamp_min((full.float() - want).abs() - ulps, 0) / lr
        over = float((gap > 1e-2).float().mean())
        if over > share:
            share, which = over, i
        del full, want, ulps, gap
    return share, which


def tp_leaf_gaps(model, mesh, rules, grads, ref):
    """{leaf: |g - ref| / |ref|} of the gradients the sharded step handed
    AdamW (`grads`, flat, each rank's blocks, gathered here) against the
    one-process step's `ref` (flat, rank 0; None elsewhere, which gets
    {})."""
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.models.params import leaves
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    sizes = ax.axis_sizes(mesh)
    out = {}
    for i, ((path, pd), g, s) in enumerate(zip(
            leaves(model.spec), grads,
            tree_flatten(model.param_shardings(mesh, rules))[0])):
        if any(sizes[a] > 1 for e in s.spec for a in ax._names(e)):
            g = ranks.gather_full(g, s, pd.shape)
        if ref is not None:
            want = ref[i].double()
            out[path] = float((g.double() - want).norm()
                              / want.norm().clamp_min(1e-300))
    return out


@contextlib.contextmanager
def kept_grads(store):
    """While active, each gradient tree that a train step hands
    `adamw.update` is appended to `store`, flat."""
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.optim import adamw
    orig = adamw.update

    def spy(cfg, grads, state, params):
        store.append(tree_flatten(grads)[0])
        return orig(cfg, grads, state, params)
    adamw.update = spy
    try:
        yield store
    finally:
        adamw.update = orig


def tp_arch_run(arch, rank, world, dev, mesh, rules, counters, spec=None):
    """One arch of `tp_train_rank`: on rank 0 the one-process scoring
    call (flash) and train step on the same rows, from the same seed;
    then on every rank the tensor-parallel scoring call on its blocks,
    with the kernels (launches counted) and with the plain attention and
    router, `TP_MAIN[arch]`'s steps (the last profiled on rank 0, the
    collectives' bytes per step counted), the gradients of step 1 per
    leaf against the one-process step's where `TP_LEAF_RTOL` names the
    type, the parameters after step 1 against the one-process step's,
    the replicated leaves' bits across the ranks.  `spec` (layers, steps,
    dtype) defaults to `TP_MAIN[arch]`."""
    import gc
    import statistics
    from dataclasses import replace
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    from repro_torch.train.step import make_train_step, opt_shardings
    spec = TP_MAIN[arch] if spec is None else spec
    steps = spec["steps"]
    dtype = getattr(torch, spec["dtype"])
    # flash takes bf16 and float32
    score_dtype = torch.float32 if dtype == torch.float64 else dtype
    leaf_rtol = TP_LEAF_RTOL.get(spec["dtype"])
    cfg = replace(get_config(arch), n_layers=spec["layers"])
    B, S = TP_BATCH
    n_data = ax.axis_sizes(mesh)["data"]
    k = mesh.get_coordinate()[1]
    pipe = TokenPipeline(PipelineConfig(B, S, cfg.vocab))
    glob = [pipe._batch_at(s) for s in range(steps)]

    def mine(step):
        w = B // n_data
        return {"tokens": torch.as_tensor(glob[step][k * w:(k + 1) * w],
                                          device=dev)}

    def seed():
        return torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev)
    scorer = build_model(replace(cfg, use_flash_kernel=True), dev)
    opt_cfg = adamw.AdamWConfig(**TP_OPT)
    out = {"score_dtype": str(score_dtype).removeprefix("torch.")}
    ref = one_grads = None
    if rank == 0:       # one process, the same weights and rows
        w = model.init(seed(), score_dtype)
        with torch.no_grad():
            out["one_score"] = float(scorer.loss(w, mine(0))[0])
        del w
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        full = model.init(seed(), dtype)
        base = torch.cuda.memory_allocated()
        kept = []
        with (kept_grads(kept) if leaf_rtol else contextlib.nullcontext()):
            full, opt1, met = make_train_step(model, opt_cfg)(
                full, adamw.init(full), mine(0))
        torch.cuda.synchronize()
        out["one_process"] = {k_: float(met[k_]) for k_ in
                              ("loss", "grad_norm", "lr")}
        out["one_peak_gib"] = (torch.cuda.max_memory_allocated()
                               - base) / 2 ** 30
        ref = tree_flatten(full)[0]
        one_grads = kept[0] if kept else None
        del opt1, met, kept
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    shardings = model.param_shardings(mesh, rules)
    w = model.init(seed(), score_dtype, shardings)
    for c in counters.values():
        c.launches = 0
    with ax.use_rules(rules, mesh), torch.no_grad():
        out["tp_score"] = float(scorer.loss(w, mine(0))[0])
        out["score_launches"] = {n: c.launches for n, c in counters.items()}
        out["tp_plain_score"] = float(model.loss(w, mine(0))[0])
    del w
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = model.init(seed(), dtype, shardings)
    out["param_gib"] = (torch.cuda.memory_allocated() - held) / 2 ** 30
    opt = adamw.init(params, opt_shardings(model, mesh, rules))
    step_fn = make_train_step(model, opt_cfg, mesh=mesh, rules=rules)
    base = torch.cuda.memory_allocated()
    for c in counters.values():
        c.launches = 0
    walls, history, traffic = [], [], []
    dist.barrier()
    t_all = time.perf_counter()
    for step in range(steps):
        profiled = rank == 0 and step == steps - 1
        kept = []
        ranks.traffic.clear()
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof, \
                (kept_grads(kept) if leaf_rtol and step == 0
                 else contextlib.nullcontext()):
            t0 = time.perf_counter()
            params, opt, met = step_fn(params, opt, mine(step))
            history.append({k_: float(v) for k_, v in met.items()})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        traffic.append(dict(ranks.traffic))
        if step == 0:
            out["param_gap"] = tp_param_gaps(params, ref,
                                             history[0]["lr"])
            if leaf_rtol:
                out["leaf_gaps"] = tp_leaf_gaps(model, mesh, rules,
                                                kept[0], one_grads)
            ref = one_grads = None
        del kept
    wall = time.perf_counter() - t_all
    walls_steady = walls[1:] if len(walls) > 1 else walls
    out.update(walls=walls, wall=wall, history=history, traffic=traffic,
               peak_gib=(torch.cuda.max_memory_allocated() - held)
               / 2 ** 30,
               opt_gib=(base - held) / 2 ** 30 - out["param_gib"],
               launches={n: c.launches for n, c in counters.items()},
               median_ms=statistics.median(walls_steady) * 1e3)
    if rank == 0:
        busy, by_name = device_activity(prof)
        out.update(prof_wall=walls[-1], busy=busy, top=sorted(
            ((n, c, t) for n, (c, t) in by_name.items()),
            key=lambda e: -e[2])[:6])
    flat = tree_flatten(params)[0]
    wide = [i for i, p in enumerate(flat) if any(
        ax.axis_sizes(mesh)[a] > 1 for e in ranks.sharding_of(p).spec
        for a in ax._names(e))]
    sums = torch.stack([torch.stack((
        p.to_local().view(torch.int16).sum(dtype=torch.int64),
        p.to_local().view(torch.int16).flatten()[1::7].sum(
            dtype=torch.int64)))
        for i, p in enumerate(flat) if i not in wide]).flatten()
    hi = ranks.all_max_(sums.clone())
    lo = -ranks.all_max_(-sums)
    out["replicated_equal"] = bool(torch.equal(hi, lo))
    out["n_sharded"] = len(wide)
    out["n_leaves"] = len(flat)
    del params, opt, step_fn, flat
    return out


def tp_kernel_checks(dev):
    """The kernels at the shapes the tensor-parallel scoring call gives
    them on each rank of (1, 1, 2) (the global batch's 8 rows of 257
    tokens, half the heads): flash for Qwen3 (H 8, Hk 4, hd 128, bf16)
    and granite-moe (H 8, Hk 4, hd 64, float32), causal, and gating on
    granite's gathered router logits (N 2056, E 32, k 8), each against
    its plain version (`check_flash_case`, `check_gating_case`).
    Returns each one's max abs error."""
    import torch
    B, S = TP_BATCH
    S += 1              # the pipeline's rows hold S + 1 tokens
    return {"flash B 8 S 257 H 8 Hk 4 hd 128 bf16": check_flash_case(
                dev, B, S, 8, 4, 128, torch.bfloat16, True, 18),
            "flash B 8 S 257 H 8 Hk 4 hd 64 float32": check_flash_case(
                dev, B, S, 8, 4, 64, torch.float32, True, 19),
            "gating N 2056 E 32 k 8": check_gating_case(
                dev, B * S, 32, 8, 120)}


def tp_smoke_checks(rank, world, dev):
    """At smoke size on the phase's ranks, float32, TF32 off, one step
    from the same init on the card's ranks and on a mesh of the same
    ranks on the CPU (gloo), card against CPU (`TP_SMOKE_PARAM_TOL`): `fsdp_rules(base_rules(
    False))` on (1, W, 1) (FSDP over every rank) for qwen3 and
    granite-moe, and qwen3 with one K/V head under `base_rules(False)` on
    (1, 1, W) (kv_heads replicated, each rank's q heads reading it)."""
    from dataclasses import replace
    import numpy as np
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.train.step import make_train_step, opt_shardings
    cases = [("fsdp", "qwen3-1.7b", (1, world, 1),
              ax.fsdp_rules(ax.base_rules(False), False), {}),
             ("fsdp", "granite-moe-1b-a400m", (1, world, 1),
              ax.fsdp_rules(ax.base_rules(False), False), {}),
             ("kv fallback", "qwen3-1.7b", (1, 1, world),
              ax.base_rules(False), {"n_kv_heads": 1})]
    out = []
    for name, arch, shape, rules, changes in cases:
        cfg = replace(get_smoke_config(arch), remat="full", **changes)
        tokens = np.random.default_rng(3).integers(0, cfg.vocab, (8, 32))
        got = []
        for d in (dev, torch.device("cpu")):
            mesh = make_test_mesh(shape, DP_NAMES, d.type)
            model = build_model(cfg, d)
            params = model.init(torch.Generator().manual_seed(0),
                                torch.float32,
                                model.param_shardings(mesh, rules))
            n = 1
            for a in ax.batch_axes(rules):
                n *= ax.axis_sizes(mesh)[a]
            k = mesh.get_coordinate()[1]
            opt = adamw.init(params, opt_shardings(model, mesh, rules))
            params, opt, met = make_train_step(
                model, adamw.AdamWConfig(lr=1e-2, warmup_steps=2),
                mesh=mesh, rules=rules)(params, opt, {
                    "tokens": torch.as_tensor(
                        tokens[k * 8 // n:(k + 1) * 8 // n], device=d)})
            got.append((
                {k_: float(v) for k_, v in met.items()},
                [ranks.gather_dtensor(p).cpu()
                 for p in tree_flatten(params)[0]],
                [p.to_local().numel() < p.numel()
                 for p in tree_flatten(params)[0]],
                [ranks.gather_dtensor(m).cpu()
                 for m in tree_flatten(opt.mu)[0]]))
        (mc, pc, sc, uc), (mh, ph, _, uh) = got
        lr = mh["lr"]
        gap = torch.cat([(a - b).abs().flatten() for a, b in
                         zip(pc, ph)]) / lr
        out.append(dict(
            name=f"{name} {arch} {shape}",
            loss_gap=abs(mc["loss"] - mh["loss"]) / abs(mh["loss"]),
            norm_gap=abs(mc["grad_norm"] - mh["grad_norm"])
            / mh["grad_norm"],
            moment_gap=max(float((a - b).abs().max())
                           / max(float(b.abs().max()), 1e-30)
                           for a, b in zip(uc, uh)),
            param_share=float((gap > TP_SMOKE_PARAM_TOL["most"])
                              .float().mean()),
            n_sharded=sum(sc)))
    return out


def tp_train_rank(rank, world, dev):
    """One rank of `tp_train_path`: `tp_arch_run` for each arch of
    `TP_MAIN` under `base_rules(False)` on (1, W/2, 2), then
    `tp_smoke_checks`.  Returns numbers only."""
    import gc
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import axes as ax
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    mesh = make_test_mesh((1, world // 2, 2), DP_NAMES, dev.type)
    rules = ax.base_rules(False)
    out = {}
    for arch in TP_MAIN:
        out[arch] = tp_arch_run(arch, rank, world, dev, mesh, rules,
                                counters)
        gc.collect()
        torch.cuda.empty_cache()
    out["smoke"] = tp_smoke_checks(rank, world, dev)
    return out


def tp_train_report(label, arch, spec, res):
    """Print `tp_arch_run`'s results of one arch (`res`, per rank) and
    return whether they pass `tp_train_path`'s gates."""
    import numpy as np
    B, S = TP_BATCH
    r0 = res[0]
    steps, layers = spec["steps"], spec["layers"]
    first, one = r0["history"][0], r0["one_process"]
    gap = abs(first["loss"] - one["loss"]) / abs(one["loss"])
    norm_gap = abs(first["grad_norm"] - one["grad_norm"]) / one[
        "grad_norm"]
    score_gap = abs(r0["tp_score"] - r0["one_score"]) / abs(
        r0["one_score"])
    share, which = r0["param_gap"]
    flash_gap = abs(r0["tp_score"] - r0["tp_plain_score"]) / abs(
        r0["tp_plain_score"])
    score_dtype = r0["score_dtype"]
    flash_tol = TP_FLASH_RTOL[score_dtype]
    leaf_gaps = r0.get("leaf_gaps")
    losses = [h["loss"] for h in r0["history"]]
    print(f"tp train path ({label}): {arch} full width, {layers} "
          f"layers, {spec['dtype']}, global batch {B} x {S}, "
          f"{steps} steps, "
          f"base_rules(False) with ZeRO-1 moments, remat full; "
          f"losses {[round(v, 4) for v in losses]}")
    for r, a in enumerate(res):
        per = ", ".join(f"{n} {b / 2 ** 20:.1f} MiB"
                        for n, b in sorted(a["traffic"][-1].items()))
        print(f"  rank {r}: steps "
              f"{[round(w * 1e3, 1) for w in a['walls']]} ms; peak "
              f"allocated {a['peak_gib']:.2f} GiB above what the "
              f"rank held (its blocks {a['param_gib']:.2f} GiB,"
              f" moments {a['opt_gib']:.2f} GiB) against the "
              f"one-process step's {r0['one_peak_gib']:.2f} GiB "
              f"above its parameters; collectives per step {per}; "
              f"{a['n_sharded']} of {a['n_leaves']} leaves sharded;"
              f" replicated leaves bitwise equal across ranks "
              f"{a['replicated_equal']}; flash launches in the TP "
              f"scoring call {a['score_launches']['flash_attention']}"
              f", gating {a['score_launches']['gating_topk']}, "
              f"ssd_scan {a['score_launches']['ssd_scan']}; "
              f"kernel launches in training {a['launches']}")
    for name, calls, t in r0["top"]:
        print(f"  device {t:8.4f} s {calls:8d} calls  {name[:90]}")
    if leaf_gaps is not None:
        print(f"  step 1's gradient per leaf against the one-process "
              f"step's, |tp - one| / |one| (gated at "
              f"{TP_LEAF_RTOL[spec['dtype']]}): " + ", ".join(
                  f"{n} {v:.3e}" for n, v in leaf_gaps.items()))
    print(f"tp train path ({label}) {arch}: step 1 "
          f"{r0['walls'][0] * 1e3:.1f} ms, steps 2-{steps} median "
          f"{r0['median_ms']:.1f} ms; {B * S * steps / r0['wall']:,.0f}"
          f" tokens/s; rank 0's profiled step {steps} "
          f"{r0['prof_wall'] * 1e3:.1f} ms wall, device busy "
          f"{r0['busy'] * 1e3:.1f} ms, idle share "
          f"{1 - r0['busy'] / r0['prof_wall']:.3f}; first-step loss "
          f"{first['loss']:.6f} against the one-process step's "
          f"{one['loss']:.6f} (relative {gap:.3e}, gated at "
          f"{TP_LOSS_RTOL}), grad_norm {first['grad_norm']:.6f} "
          f"against {one['grad_norm']:.6f} (relative "
          f"{norm_gap:.3e}, gated at {TP_GRAD_NORM_RTOL}); after "
          f"step 1 at most {share:.2e} of a leaf's elements beyond "
          f"1e-2·lr (leaf {which}, gated at {TP_PARAM_SHARE}); the "
          f"TP scoring call ({score_dtype}) with flash "
          f"{r0['tp_score']:.6f} against one process's "
          f"{r0['one_score']:.6f} (relative {score_gap:.3e}, gated "
          f"at {TP_LOSS_RTOL}) and against the plain attention and "
          f"router on the same blocks {r0['tp_plain_score']:.6f} "
          f"(relative {flash_gap:.3e}, gated at {flash_tol})")
    ok = (gap <= TP_LOSS_RTOL and score_gap <= TP_LOSS_RTOL
          and flash_gap <= flash_tol
          and norm_gap <= TP_GRAD_NORM_RTOL
          and share <= TP_PARAM_SHARE
          and all(np.isfinite(losses)))
    if spec["dtype"] in TP_LEAF_RTOL:
        ok &= (leaf_gaps is not None and len(leaf_gaps) == r0[
            "n_leaves"] and max(leaf_gaps.values())
            <= TP_LEAF_RTOL[spec["dtype"]])
    ssm = arch.startswith("mamba2")
    for a in res:
        want = {"flash_attention": 0 if ssm else layers,
                "gating_topk": layers if "moe" in arch else 0,
                "ssd_scan": layers if ssm else 0}
        ok &= (a["replicated_equal"] and a["n_sharded"] > 0
               and all(a["score_launches"][n] == v
                       for n, v in want.items())
               and not any(a["launches"].values()))
    return ok


def tp_train_path(timings):
    """Qwen3-1.7B and granite-moe trained tensor- and expert-parallel on
    each of `tp_layouts`' rank sets (`spawn_ranks`, one process per rank),
    with the smoke checks beside them; fails on any rank's error or failed
    check.  Returns the flash launches of each TP scoring call, per rank."""
    import gc
    import torch
    from repro_torch.sharding.ranks import spawn_ranks
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    for backend, device, world in tp_layouts():
        label = (f"{backend}, {world} ranks on "
                 + (device if ":" in device else f"{world} cards")
                 + f", mesh (1, {world // 2}, 2)")
        t0 = time.perf_counter()
        res = spawn_ranks(tp_train_rank, world, backend, device)
        secs = time.perf_counter() - t0
        ok = True
        for arch, spec in TP_MAIN.items():
            ok &= tp_train_report(label, arch, spec,
                                  [rr[arch] for rr in res])
            launches[f"{arch} {backend}"] = [
                rr[arch]["score_launches"]["flash_attention"] for rr in res]
        for c in res[0]["smoke"]:
            print(f"tp smoke check ({label}) {c['name']}: card against CPU "
                  f"ranks, loss {c['loss_gap']:.2e}, grad_norm "
                  f"{c['norm_gap']:.2e}, first moments within "
                  f"{c['moment_gap']:.2e} of each leaf's largest, "
                  f"{c['param_share']:.2e} of the parameters beyond "
                  f"1e-2·lr; {c['n_sharded']} leaves sharded")
            ok &= (c["loss_gap"] <= 1e-5 and c["norm_gap"] <= 1e-4
                   and c["moment_gap"] <= TP_SMOKE_MOMENT_TOL
                   and c["param_share"] <= TP_SMOKE_PARAM_TOL["share"]
                   and c["n_sharded"] > 0)
        print(f"tp train path ({label}): {secs:.1f} s")
        timings[f"tp train {backend}"] = secs
        if not ok:
            raise AssertionError(f"tp train path ({label}) failed its "
                                 "checks")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# serving over a model mesh: prefill and decode under tensor and expert
# parallelism, the KV cache's sequence over "model", the SSM mixers over a
# wide "model" axis
# ---------------------------------------------------------------------------

# Each arch at full width on random bf16 weights (seed 0), the kernels'
# ops on, over `tp_layouts`' rank sets on a (1, W/2, 2) mesh: its depth,
# its layout, the prompt's rows x tokens, the caches' length and the
# decode steps.  Mamba2 at 16 of 64 layers under `base_rules` (40 of its
# 80 SSM heads a rank); Qwen3-1.7B at 7 of 28 layers under `decode_32k`'s
# layout (the reference dry-run's: the KV
# sequence over "model", K/V heads whole), 2048 positions, 1024 a rank, a
# prompt of 1016, so that steps 9-16 write into rank 1's slice;
# granite-moe at 4 of 24 layers under `base_rules` (E 32 over the ranks,
# vocab 49155 replicated).  Mamba2 at 32 and Qwen3 at 14 layers until
# `sp_serve_path` needed the script's time.
TP_SERVE = {
    "mamba2-2.7b": dict(layers=16, layout="base", rows=4, prompt=1024,
                        max_seq=1056, steps=32),
    "qwen3-1.7b": dict(layers=7, layout="decode_32k", rows=4,
                       prompt=1016, max_seq=2048, steps=16),
    "granite-moe-1b-a400m": dict(layers=4, layout="base", rows=4,
                                 prompt=1024, max_seq=1040, steps=16),
}
# Mamba2's SSM mixer trained over the ranks (`tp_arch_run`, gated as
# `tp_train_path`'s archs): 8 layers, 2 steps of the global batch 8 x 256,
# in float32.  In bf16 (on an H100 80GB HBM3 at 700 W) the step's
# grad_norm read 8.2e-3 from one process's and 3.85e-2 of a leaf moved
# beyond 1e-2·lr: at this random init bf16 rounding, not the layout,
# sets those numbers, so float32 checks the mixer's gradient per leaf
# (TP_LEAF_RTOL)
TP_SERVE_TRAIN = {"mamba2-2.7b": dict(layers=8, steps=2, dtype="float32")}
# The logits' and the gathered caches' largest gap against the
# one-process run (same weights, same fed tokens), relative to the
# one-process run's largest magnitude, at the prefill and at every step.
# A rank's run rounds the same bf16 model another way: its row-parallel
# partial sums round to bf16 before they are summed, the merged decode
# softmax sums in another order.  The one-process run's own distance from
# the same weights computed in float32 (no activation rounded to bf16)
# is measured in the same call, point by point and leaf by leaf: the
# rank's extra roundings are a few of the many that distance is made
# of, in a model that does not amplify them; random-weight Mamba2
# amplifies any float32 reordering into O(1) logits (`SERVE_GAP_FACTOR`'s
# note), where both distances saturate.  The layout rounds the
# residual's updates about as often as the bf16 run itself does: a CPU
# rehearsal at smoke size (2 layers, two gloo ranks) read gaps of 0.94-1.2
# times that distance.  So each gap is gated at TP_SERVE_FACTOR x that
# distance, and never below TP_SERVE_FLOOR: a wrong head, expert,
# vocabulary block or cache slice moves a non-amplifying model's logits
# by O(1) of their largest.
TP_SERVE_FACTOR = 4.0
TP_SERVE_FLOOR = 1e-3
# With `replay` the twin's and the layout's routers take the one-process
# run's expert ids (`RouteLog`), since a near-tied route that one
# rounding flips moves a token's residual by O(1).  A rank's own top-k
# must still agree with them: its kernel's ids may differ at no more
# than this share of the token rows (float32 roundings flip only
# near-exact ties; a wrong router input moves most rows).
ROUTE_FLIP_SHARE = 0.01
# Smoke size, card ranks against CPU ranks of the same layout, float32,
# each decode step from the CPU ranks' caches: `test_torch_tp_serve.py`'s
# tolerances, |card - cpu| <= 1e-5 |cpu| + 1e-5 + 1e-5 max |cpu|, the
# atol 1e-3 for the archs whose smoke attention has no qk-norm
TP_SERVE_SMOKE_ATOL = {"jamba-1.5-large-398b": 1e-3}


def tp_serve_rules(layout):
    """The rules of a layout name: "base", "decode_32k", "seq_parallel"."""
    from repro_torch.sharding import axes as ax
    base = ax.base_rules(False)
    if layout == "decode_32k":
        return dict(base, seq_kv="model", kv_heads=None)
    if layout == "seq_parallel":
        return ax.sequence_parallel_rules(False)
    return base


def rel_gap(got, want):
    """max |got - want| / max |want|, in float32."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def cache_leaves(tree):
    """The leaves of a cache tree (dicts by key, then NamedTuple fields)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in cache_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in cache_leaves(v)]
    return [tree]


def cache_copy(tree, dev):
    """A copy on `dev` of a cache tree of plain tensors."""
    if isinstance(tree, dict):
        return {k: cache_copy(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(cache_copy(v, dev) for v in tree))
    return tree.to(dev, copy=True)


def cast_tree(tree, dtype):
    """A nested dict of tensors, each cast to `dtype` (the same values)."""
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def stored_gap(got, want, dtype):
    """`rel_gap` of a cache leaf of a run computed in `dtype`, less one
    ulp of each element where the leaf is stored narrower (a float32
    run's bf16 K/V and conv states): both runs round values that agree
    far below that ulp, so an element may part by one rounding."""
    import torch
    if got.element_size() >= dtype.itemsize:
        return rel_gap(got, want)
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.full_like(g, torch.finfo(got.dtype).eps), e - 1)
    return float(((g - w).abs() - ulp).clamp_min(0).max()
                 / w.abs().max().clamp_min(1e-30))


def kv_leaves(tree):
    """The K/V cache leaves of a cache tree, in `cache_leaves`' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in kv_leaves(tree[k])]
    return list(tree) if type(tree).__name__ == "KVCache" else []


def kv_rows(leaf, lo, hi):
    """Positions [lo, hi) of a K/V cache leaf [L, B, S, Hk, hd], full: of
    a DTensor whose sequence the rules split, each rank's part of them
    (zeros elsewhere) summed over the sequence's ranks in float32 (each
    position is one rank's: exact), then gathered over the heads' (every
    rank calls it)."""
    import torch
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    sharding = ranks.sharding_of(leaf)
    if sharding is None:
        return leaf[:, :, lo:hi].clone()
    x = leaf.to_local()
    off = sharding.block(leaf.shape)[2].start or 0
    a, b = max(lo, off), min(hi, off + x.shape[2])
    part = torch.zeros(x.shape[:2] + (hi - lo,) + x.shape[3:],
                       dtype=torch.float32, device=x.device)
    if a < b:
        part[:, :, a - lo:b - lo] = x[:, :, a - off:b - off]
    spec = list(sharding.spec) + [None] * (leaf.dim() - len(sharding.spec))
    group, n = ranks.axis_group(sharding.mesh, ax._names(spec[2]))
    if n > 1:
        ranks.all_sum_(part, group)
    spec[2] = None
    return ranks.gather_full(part.to(x.dtype), ax.NamedSharding(
        sharding.mesh, ax.P(*spec)), tuple(leaf.shape[:2]) + (hi - lo,)
        + tuple(leaf.shape[3:]))


def compared_leaves(tree, rows=None):
    """A cache tree's leaves in `cache_leaves`' order, each a full copy
    (gathered from the ranks' blocks where it is a DTensor: every rank
    calls it), the K/V caches only at positions [rows) when `rows` is
    given (`kv_rows`)."""
    from repro_torch.sharding import ranks
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in compared_leaves(tree[k], rows)]
    if rows is not None and type(tree).__name__ == "KVCache":
        return [kv_rows(x, *rows) for x in tree]
    return [ranks.gather_dtensor(x).clone() for x in tree]


def serve_run(model, params, tokens, max_seq, start, steps, feed=None,
              fed=None, caches=None, keep=None):
    """`Model.prefill` of `tokens`, then `steps` decode steps from
    position `start`, each synchronised: greedy (its tokens written into
    `fed`, [steps, rows, 1] on the CPU) or of `feed`'s tokens.  With
    `caches` the steps go on from them, not from the prefill's, of which
    `keep` returns what is compared.  Returns (logits per point, caches,
    what `keep` returned, prefill s, decode s per step)."""
    import torch
    t0 = time.perf_counter()
    logits, new = model.prefill(params, {"tokens": tokens}, max_seq)
    torch.cuda.synchronize()
    prefill_s, step_s, points = time.perf_counter() - t0, [], [logits]
    kept = []
    if caches is None:
        caches = new
    else:
        kept = keep(new)
    del new
    for i in range(steps):
        tok = feed[i] if feed is not None else logits.argmax(-1, True)
        if fed is not None:
            fed[i] = tok.cpu()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, tok, start + i, caches)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        points.append(logits)
    return points, caches, kept, prefill_s, step_s


def rank_rows(mesh, rules, rows):
    """(rows per rank, this rank's first row) of a global batch of `rows`
    split over the rules' batch axes (every row on every rank where they
    put the batch on no wide axis)."""
    from repro_torch.sharding import axes as ax
    sizes, coord = ax.axis_sizes(mesh), mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    k, n = 0, 1
    for a in ax.batch_axes(rules):
        k, n = k * sizes[a] + coord[names.index(a)], n * sizes[a]
    return rows // n, k * (rows // n)


def ranks_agree(tensors, mesh, rules, spec=()):
    """Whether every rank of the group over which these blocks are
    replicated (the wide axes that neither `spec` nor the rules' batch
    axes name) holds the same bits: their integer sums' maximum and
    minimum over it agree.  Every rank calls it in the same order."""
    import torch
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    used = {a for e in spec for a in ax._names(e)}
    used |= set(ax.batch_axes(rules))
    group, n = ranks.axis_group(mesh, [a for a in mesh.mesh_dim_names
                                       if a not in used])
    if n == 1:
        return True
    sums = torch.stack([(x.view(torch.int16) if x.element_size() == 2 else
                         x.view(torch.int32)).sum(dtype=torch.int64)
                        for x in tensors])
    return torch.equal(ranks.all_max_(sums.clone(), group),
                       -ranks.all_max_(-sums, group))


def tp_serve_arch(arch, spec, rank, world, dev, mesh, counters):
    """One arch of `tp_serve_rank` or `sp_serve_rank`: on rank 0 the
    one-process run in the spec's `dtype` (bf16 unless it names another;
    greedy: its tokens feed every run) and, of a bf16 run, its twin on
    the same weights cast to float32 (the bf16 arithmetic's own reach; a
    float32 run's is 0); then on every rank the
    run under the layout on its blocks, profiled on rank 0, with the
    kernels' launches and the collectives' bytes per prefill and per
    step; its logits and gathered caches against the one-process run's
    on rank 0; the logits and the caches the rules replicate bitwise
    across the ranks that hold them.  With `start` every run decodes
    from that position of caches drawn from a seeded generator
    (`drawn_caches`, stored in the run's type), not from the prefill's,
    and the K/V caches are
    compared at the prompt's rows after the prefill and at the
    `SP_WINDOW` rows around the middle after the steps; with `replay`
    the twin's and the layout's routers take the one-process run's
    expert ids (`RouteLog`), a float32 run's bf16 K/V and conv states
    (the prefill's) gated beyond one rounding (`stored_gap`)."""
    import gc
    import statistics
    from dataclasses import replace
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    rules = tp_serve_rules(spec["layout"])
    cfg = replace(get_config(arch), n_layers=spec["layers"],
                  use_flash_kernel=True, **spec.get("cfg", {}))
    model = build_model(cfg, dev)
    name = spec.get("dtype", "bfloat16")
    dtype = getattr(torch, name)
    B, S, steps, max_seq = (spec["rows"], spec["prompt"], spec["steps"],
                            spec["max_seq"])
    start = spec.get("start")
    at, mid = S if start is None else start, max_seq // 2
    kv = ((None, None) if start is None else
          ((0, S), (mid - SP_WINDOW, mid + SP_WINDOW)))
    w, lo = rank_rows(mesh, rules, B)
    tokens = torch.as_tensor(np.random.default_rng(34).integers(
        0, cfg.vocab, (B, S)), device=dev)
    routes = RouteLog() if spec.get("replay") else None

    def seed():
        return torch.Generator(device=dev).manual_seed(0)

    def routed(mode):
        return routes.run(mode) if routes else contextlib.nullcontext()

    def one_run(m, params, mode, **kw):
        """The one-process run of `m` on `params`: (logits per point, the
        compared cache leaves, prefill s, decode s per step)."""
        drawn = None if start is None else drawn_caches(m, B, max_seq, dev,
                                                        dtype)
        with torch.no_grad(), routed(mode):
            points, caches, kept, pre_s, step_s = serve_run(
                m, params, tokens, max_seq, at, steps, caches=drawn,
                keep=lambda c: compared_leaves(c, kv[0]), **kw)
            return points, kept + compared_leaves(caches, kv[1]), pre_s, \
                step_s
    out = {}
    fed = torch.zeros((steps, B, 1), dtype=torch.int64)
    if rank == 0:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        one_points, one_caches, one_prefill, one_steps = one_run(
            model, model.init(seed(), dtype), "record", fed=fed)
        out["one_peak_gib"] = (torch.cuda.max_memory_allocated()
                               - held) / 2 ** 30
        out.update(one_prefill_ms=one_prefill * 1e3,
                   one_decode_ms=statistics.median(one_steps) * 1e3)
        gc.collect()
        torch.cuda.empty_cache()
        out["reach"] = [0.0] * len(one_points)      # float32 arithmetic
        out["cache_reach"] = [0.0] * len(one_caches)
        if dtype == torch.bfloat16:
            points32, caches32, _, _ = one_run(
                model, cast_tree(model.init(seed(), dtype), torch.float32),
                "replay", feed=fed.to(dev))
            out["reach"] = [rel_gap(a, b)
                            for a, b in zip(points32, one_points)]
            out["cache_reach"] = [rel_gap(a, b)
                                  for a, b in zip(caches32, one_caches)]
            del points32, caches32
    gc.collect()
    torch.cuda.empty_cache()
    ranks.all_sum_(fed)             # rank 0's greedy tokens, every rank
    feed = fed.to(dev)
    if routes:                      # and its routes: the prefill's, the steps'
        n = zoo_layer_counts(cfg)["gating_topk"]
        routes.share([B * S] * n + [B] * (n * steps), cfg.top_k)
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = model.init(seed(), dtype, model.param_shardings(mesh, rules))
    out["param_gib"] = (torch.cuda.memory_allocated() - held) / 2 ** 30
    drawn = None if start is None else drawn_caches(
        model, B, max_seq, dev, dtype, model.cache_shardings(
            B, max_seq, mesh, rules, dtype))
    mine, same = tokens[lo:lo + w], []

    def keep(caches):
        same.extend(ranks_agree([x.to_local()], mesh, rules,
                                ranks.sharding_of(x).spec)
                    for x in cache_leaves(caches))
        return compared_leaves(caches, kv[0])
    with ax.use_rules(rules, mesh), torch.no_grad():
        model.prefill(params, {"tokens": mine[:, :128]}, max_seq)
        torch.cuda.synchronize()
        dist.barrier()
        for c in counters.values():
            c.launches = 0
        launches, traffic = [], []
        real_prefill, real_decode = model.prefill, model.decode_step

        def counted(fn):
            def call(*args):
                for c in counters.values():
                    c.launches = 0
                ranks.traffic.clear()
                res = fn(*args)
                launches.append({n: c.launches for n, c in
                                 counters.items() if c.launches})
                traffic.append(dict(ranks.traffic))
                return res
            return call
        model.prefill, model.decode_step = (counted(real_prefill),
                                            counted(real_decode))
        try:
            with (profile(activities=[ProfilerActivity.CUDA])
                  if rank == 0 else contextlib.nullcontext()) as prof, \
                    routed("replay"):
                t0 = time.perf_counter()
                points, caches, kept, prefill_s, step_s = serve_run(
                    model, params, mine, max_seq, at, steps,
                    feed=feed[:, lo:lo + w], caches=drawn, keep=keep)
                wall = time.perf_counter() - t0
        finally:
            model.prefill, model.decode_step = real_prefill, real_decode
        del drawn
        out.update(prefill_ms=prefill_s * 1e3,
                   decode_ms=statistics.median(step_s) * 1e3,
                   launches=launches, traffic=traffic,
                   peak_gib=(torch.cuda.max_memory_allocated() - held)
                   / 2 ** 30)
        if routes:
            out.update(route_flips=routes.flipped, route_rows=routes.rows,
                       route_want=sum(c.shape[0] for c in routes.calls))
        if rank == 0:
            busy, _ = device_activity(prof)
            out.update(busy=busy, wall=wall)
            out["gaps"] = [rel_gap(a, b[lo:lo + w])
                           for a, b in zip(points, one_points)]
            out["tokens_equal"] = sum(
                bool(torch.equal(p.argmax(-1), feed[i, lo:lo + w, 0]))
                for i, p in enumerate(points[:-1]))
            del one_points
        same.append(ranks_agree(points, mesh, rules))
        leaves = cache_leaves(caches)
        same += [ranks_agree([x.to_local()], mesh, rules,
                             ranks.sharding_of(x).spec) for x in leaves]
        got = kept + compared_leaves(caches, kv[1])
        out.update(bitwise_across_ranks=all(same), n_cache_leaves=len(
            leaves), n_cache_sharded=sum(
                any(ax.axis_sizes(mesh)[a] > 1 for e in
                    ranks.sharding_of(x).spec for a in ax._names(e))
                for x in leaves),
            kv_local=[tuple(x.to_local().shape) for x in kv_leaves(caches)])
        if rank == 0:
            out["cache_gaps"] = [stored_gap(a, b, dtype)
                                 for a, b in zip(got, one_caches)]
            del one_caches
    del params, caches, points, kept, got
    return out


def tp_serve_smoke(rank, world, dev):
    """At smoke size, float32, TF32 off: Jamba's period stack under
    `base_rules(False)` and the uneven-heads Mamba2 (3 heads of 32) on
    (1, W/2, 2) (`sequence_parallel_rules` moved to `sp_serve_smoke`),
    each a prefill of 4 x 6 tokens and 3 decode
    steps on the card's ranks and on a mesh of the same ranks on the CPU
    (gloo), each card step from the CPU ranks' caches before it: (name,
    the largest logit gap over its bound)."""
    from dataclasses import replace
    import numpy as np
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import build_model, like_blocks, local_blocks
    from repro_torch.sharding import axes as ax
    cases = [("base", "jamba-1.5-large-398b", (1, world // 2, 2), {}),
             ("base", "mamba2-2.7b", (1, world // 2, 2),
              {"d_model": 48, "ssm_headdim": 32})]
    rng = np.random.default_rng(35)
    tokens = rng.integers(0, 512, (4, 6))
    steps = rng.integers(0, 512, (3, 4, 1))
    out = []
    for layout, arch, shape, changes in cases:
        cfg = replace(get_smoke_config(arch), use_flash_kernel=True,
                      **changes)
        rules = tp_serve_rules(layout)
        points, before = [], []
        for d in (torch.device("cpu"), dev):
            mesh = make_test_mesh(shape, DP_NAMES, d.type)
            model = build_model(cfg, d)
            params = model.init(torch.Generator().manual_seed(0),
                                torch.float32,
                                model.param_shardings(mesh, rules))
            n = 1
            for a in ax.batch_axes(rules):
                n *= ax.axis_sizes(mesh)[a]
            k = mesh.get_coordinate()[1] if n > 1 else 0
            rows = slice(k * 4 // n, (k + 1) * 4 // n)
            with ax.use_rules(rules, mesh), torch.no_grad():
                logits, caches = model.prefill(params, {
                    "tokens": torch.as_tensor(tokens[rows], device=d)}, 16)
                got = [logits.cpu()]
                for i in range(3):
                    if len(points) == 0:        # the CPU ranks' run
                        before.append(cache_copy(local_blocks(caches), d))
                    else:
                        caches = like_blocks(cache_copy(before[i], d),
                                             caches)
                    logits, caches = model.decode_step(params, torch.as_tensor(
                        steps[i, rows], device=d), 6 + i, caches)
                    got.append(logits.cpu())
            points.append(got)
        atol = TP_SERVE_SMOKE_ATOL.get(arch, 1e-5)
        worst = max(float(((c - h).abs() / (1e-5 * h.abs() + atol + 1e-5
                                             * h.abs().max())).max())
                    for h, c in zip(*points))
        out.append((f"{layout} {arch}{' uneven heads' if changes else ''} "
                    f"{shape}", worst))
    return out


def tp_serve_rank(rank, world, dev):
    """One rank of `tp_serve_path`: `tp_serve_arch` for each arch of
    `TP_SERVE`, Mamba2's train steps (`tp_arch_run`), then
    `tp_serve_smoke`.  Returns numbers only."""
    import gc
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import axes as ax
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    mesh = make_test_mesh((1, world // 2, 2), DP_NAMES, dev.type)
    out = {}
    for arch, spec in TP_SERVE.items():
        out[arch] = tp_serve_arch(arch, spec, rank, world, dev, mesh,
                                  counters)
        gc.collect()
        torch.cuda.empty_cache()
    out["train"] = {arch: tp_arch_run(arch, rank, world, dev, mesh,
                                      ax.base_rules(False), counters, spec)
                    for arch, spec in TP_SERVE_TRAIN.items()}
    gc.collect()
    torch.cuda.empty_cache()
    out["smoke"] = tp_serve_smoke(rank, world, dev)
    return out


def tp_serve_report(phase, arch, spec, res):
    """Print one arch's `tp_serve_arch` results (`res`, per rank) under
    `phase` and return whether they pass its gates: the launches per
    prefill and per decode step (the spec's `launches`, default: the
    arch's layers of `ssd_scan` per prefill, or of `gating_topk` per
    prefill and step); each logit point and cache leaf within
    TP_SERVE_FACTOR x the one-process run's own reach there, never below
    TP_SERVE_FLOOR; logits and shared blocks bitwise across the ranks;
    with `replay` every call's routes replayed and each rank's own at no
    more than ROUTE_FLIP_SHARE of the token rows apart from them."""
    r0 = res[0]
    layers, steps = spec["layers"], spec["steps"]
    ssm, moe = arch.startswith("mamba2"), "moe" in arch
    name = spec.get("dtype", "bfloat16")
    bound = [max(TP_SERVE_FLOOR, TP_SERVE_FACTOR * r) for r in r0["reach"]]
    cbound = [max(TP_SERVE_FLOOR, TP_SERVE_FACTOR * r)
              for r in r0["cache_reach"]]
    cut = "".join(f", {k} {v}" for k, v in spec.get("cfg", {}).items())
    print(f"{phase}: {arch} full width, {layers} layers{cut}, {name}, "
          f"{spec['layout']} layout, prompt {spec['rows']} x "
          f"{spec['prompt']}, caches of {spec['max_seq']}, {steps} decode "
          f"steps of the one-process run's greedy tokens")
    if "start" in spec:
        mid = spec["max_seq"] // 2
        print(f"  caches drawn from a seeded generator, decode from "
              f"position {spec['start']}; rank 0's K/V blocks "
              f"{r0['kv_local']}, the last rank's {res[-1]['kv_local']}; "
              f"compared: every SSM and conv state, K/V rows 0-"
              f"{spec['prompt'] - 1} after the prefill and "
              f"{mid - SP_WINDOW}-{mid + SP_WINDOW - 1} after the steps")
    ok = True
    for r, a in enumerate(res):
        pre, dec = a["traffic"][0], a["traffic"][-1]
        def fmt(t):
            return ", ".join(f"{n} {b / 2 ** 20:.3f} MiB"
                             for n, b in sorted(t.items()))
        print(f"  rank {r}: prefill {a['prefill_ms']:.1f} ms, decode "
              f"median {a['decode_ms']:.2f} ms a step; peak allocated "
              f"{a['peak_gib']:.2f} GiB above what the rank held (its "
              f"blocks {a['param_gib']:.2f} GiB) against the one-process "
              f"run's {r0['one_peak_gib']:.2f} GiB; collectives per "
              f"prefill {fmt(pre)}, per decode step {fmt(dec)}; kernel "
              f"launches per prefill {a['launches'][0]}, per decode step "
              f"{a['launches'][1:3]}...; logits and the cache blocks "
              f"that ranks share bitwise across them "
              f"{a['bitwise_across_ranks']}; {a['n_cache_sharded']} of "
              f"{a['n_cache_leaves']} cache leaves sharded")
        want_pre, want_dec = spec.get("launches") or (
            {"ssd_scan": layers} if ssm else (
                {"gating_topk": layers} if moe else {}),
            {"gating_topk": layers} if moe else {})
        ok &= (a["launches"][0] == want_pre
               and all(x == want_dec for x in a["launches"][1:])
               and len(a["launches"]) == steps + 1
               and a["bitwise_across_ranks"] and a["n_cache_sharded"] > 0)
    if spec.get("replay"):
        flips = [a["route_flips"] for a in res]
        rows = r0["route_want"]
        print(f"  routes: the layout's routers take the "
              f"one-process run's expert ids; each rank's own top-k ids "
              f"differ from them at {flips} of {rows} token rows (at most "
              f"{ROUTE_FLIP_SHARE} of them)")
        ok &= all(a["route_rows"] == rows and a["route_flips"]
                  <= ROUTE_FLIP_SHARE * rows for a in res)
    gaps, cgaps = r0["gaps"], r0["cache_gaps"]
    reach = ("its own distance from its weights in float32: " + ", ".join(
        f"{g:.2e}" for g in r0["reach"]) if name == "bfloat16" else
        "it computes in float32 itself (its own distance from float32 "
        f"arithmetic 0: each bound {TP_SERVE_FLOOR})")
    print(f"  logits' largest gap against the one-process run, relative to "
          f"its largest |logit| (prefill, then each step): "
          + ", ".join(f"{g:.2e}" for g in gaps) + f"; {reach}")
    print("  gathered caches against the one-process run's, per leaf"
          + ("" if name == "bfloat16" else
             " (beyond one rounding where it is stored in bf16)") + ": "
          + ", ".join(f"{g:.2e}" for g in cgaps)
          + ("; in float32: " + ", ".join(f"{g:.2e}" for g in
                                          r0["cache_reach"])
             if name == "bfloat16" else ""))
    print(f"{phase} {arch}: prefill {r0['prefill_ms']:.1f} "
          f"ms (one process {r0['one_prefill_ms']:.1f}), decode median "
          f"{r0['decode_ms']:.2f} ms a step (one process "
          f"{r0['one_decode_ms']:.2f}); rank 0's profiled run "
          f"{r0['wall'] * 1e3:.1f} ms wall, device busy "
          f"{r0['busy'] * 1e3:.1f} ms, idle share "
          f"{1 - r0['busy'] / r0['wall']:.3f}; logits within "
          f"{max(g / b for g, b in zip(gaps, bound)):.3f} of their bound, "
          f"caches within {max(g / b for g, b in zip(cgaps, cbound)):.3f};"
          f" greedy tokens of the layout equal to the fed ones at "
          f"{r0['tokens_equal']} of {steps} steps")
    ok &= (len(gaps) == steps + 1 and all(
        g <= b for g, b in zip(gaps, bound)) and all(
        g <= b for g, b in zip(cgaps, cbound)))
    return ok


def tp_serve_path(timings):
    """Mamba2-2.7B, Qwen3-1.7B and granite-moe served over each of
    `tp_layouts`' rank sets (`spawn_ranks`, one process per rank) with
    Mamba2's train steps and the smoke checks beside them, then
    `ssd_scan` and `gating_topk` at a rank's shapes against their plain
    versions; fails on any rank's error or failed check.  Returns the
    launches per rank and the kernels' numbers at those shapes."""
    import gc
    import torch
    from repro_torch.sharding.ranks import spawn_ranks
    gc.collect()
    torch.cuda.empty_cache()
    out = {"ssd_scan": {}, "gating_topk": {}}
    for backend, device, world in tp_layouts():
        label = (f"{backend}, {world} ranks on "
                 + (device if ":" in device else f"{world} cards")
                 + f", mesh (1, {world // 2}, 2)")
        t0 = time.perf_counter()
        res = spawn_ranks(tp_serve_rank, world, backend, device)
        secs = time.perf_counter() - t0
        ok = True
        for arch, spec in TP_SERVE.items():
            ok &= tp_serve_report(f"tp serve path ({label})", arch, spec,
                                  [r[arch] for r in res])
            for n in out:       # per rank: the prefill's, then each step's
                per = [[launch.get(n, 0) for launch in r[arch]["launches"]]
                       for r in res]
                if any(map(any, per)):
                    out[n][f"{arch} {backend}"] = per
        for arch, spec in TP_SERVE_TRAIN.items():
            ok &= tp_train_report(label, arch, spec,
                                  [r["train"][arch] for r in res])
        for name, worst in res[0]["smoke"]:
            print(f"tp serve smoke check ({label}) {name}: card against "
                  f"CPU ranks, float32, logits within {worst:.3f} of "
                  f"their bound")
            ok &= worst <= 1
        print(f"tp serve path ({label}): {secs:.1f} s")
        timings[f"tp serve {backend}"] = secs
        if not ok:
            raise AssertionError(f"tp serve path ({label}) failed its "
                                 "checks")
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    ssd = ssd_zoo_shape(dev, S=4096, nh=40, hd=64, st=128, seed=34,
                        label="a rank's 40 of Mamba2's 80 heads, the "
                              "prefill's B*S 4096 as one row")
    gating = gating_zoo_shapes(dev, ((4096, 32, 8), (4, 32, 8)), 134)
    timings["tp serve kernel shapes"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return dict(launches=out, ssd=ssd, gating=gating)


# ---------------------------------------------------------------------------
# the second wide model axis: serving under sequence_parallel_rules with
# "data" > 1, long_500k's layout (heads and SSM mixers over "data";
# residual, MLP, experts, vocabulary and KV sequence over "model")
# ---------------------------------------------------------------------------

# Each arch at full width on random weights, the kernels' ops on, under
# `sequence_parallel_rules(False)` on a (1, W/2, 2) mesh of
# `sp_layouts`' ranks, batch 1 (long_500k's), each against its
# one-process run fed the same tokens and caches.  Mamba2 in bf16 at 32
# of 64 layers (40 of its 80 SSM heads a "data" rank), a 1 x 1024 prompt
# and 32 decode steps.  Jamba at one period (8 layers: attention at 3,
# MoE at 1, 3, 5, 7): a 1 x 1024 prefill into a cache of long_500k's
# 524288 positions, then 16 decode steps from position 262136 on a cache
# drawn from a seeded generator (K/V, SSM and conv states), so that steps
# 9-16 write into "model" rank 1's slice.  Jamba runs in float32 (its
# caches stored in bf16, as ever): in bf16 its random-weight period took
# rounding alone to 0.23 of its largest logit at the prefill (the float32
# twin's distance, on an H100 80GB HBM3 at 700 W), where the gate would
# hide a wrong block; in float32 each point's bound is TP_SERVE_FLOOR
# (its own distance from float32 arithmetic is 0), each bf16 cache leaf's
# (the prefill's conv and K/V states) beyond one rounding
# (`stored_gap`).  Its decode runs on caches stored in float32: stored
# in bf16, each step's written conv and K/V rows round apart on the two
# sides wherever a value sits at a rounding boundary, and the random
# period took that to 4.3e-2 of the largest logit by the fourth step
# (the first step, on the drawn bits alone, 1.2e-6; same card).  float32
# doubles the weights: d_ff is cut from the
# zoo's 8192 to 1024 (a rank held 6.97 GiB of bf16 blocks at 2048, four
# ranks in float32 with their caches would pass 80 GB); d_ff sets no
# kernel's shape.
SP_SERVE = {
    "mamba2-2.7b": dict(layers=32, layout="seq_parallel", rows=1,
                        prompt=1024, max_seq=1056, steps=32,
                        launches=({"ssd_scan": 32}, {})),
    "jamba-1.5-large-398b": dict(
        layers=8, cfg=dict(d_ff=1024), dtype="float32",
        layout="seq_parallel", rows=1, prompt=1024, max_seq=524288,
        steps=16, start=262136, replay=True,
        launches=({"ssd_scan": 7, "gating_topk": 4}, {"gating_topk": 4})),
}
# rows of the K/V caches compared after Jamba's steps, centred on the
# boundary of the "model" ranks' slices (262144): the steps write 262136-
# 262151
SP_WINDOW = 16


def sp_layouts():
    """(backend, device, ranks): four gloo ranks sharing card 0, and one
    NCCL rank per card where four or more (an even number) are
    visible."""
    import torch
    out = [("gloo", "cuda:0", 4)]
    n = torch.cuda.device_count()
    if n >= 4 and n % 2 == 0:
        out.append(("cpu:gloo,cuda:nccl", "cuda", n))
    return out


def drawn_caches(model, rows, max_seq, dev, dtype, shardings=None,
                 seed=35):
    """Caches of `rows` x `max_seq` positions drawn from a seeded
    generator on `dev`, the same numbers in every call: K/V and conv
    states normal bf16 values stored in `dtype`, the SSM state normal in
    float32; with `shardings` (`Model.cache_shardings`) each leaf this
    rank's block, placed as it is drawn."""
    import torch
    from repro_torch.models import lm
    shapes = lm.init_caches(model.cfg, rows, max_seq, torch.bfloat16,
                            "meta")
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(t, s):
        if isinstance(t, dict):
            return {k: draw(t[k], None if s is None else s[k])
                    for k in sorted(t)}
        if isinstance(t, tuple):
            return type(t)(*(draw(x, None if s is None else s[i])
                             for i, x in enumerate(t)))
        x = torch.randn(t.shape, generator=g, device=dev, dtype=t.dtype)
        if t.dtype == torch.bfloat16:
            x = x.to(dtype)
        return x if s is None else s.place(x)
    return draw(shapes, shardings)


class RouteLog:
    """While active (`run`), records the expert ids of each router call
    of a run, kernel (`moe.fused_gating`) or plain
    (`moe.reference_gating`) ("record"), or has each call take the ids
    recorded at the same call ("replay"): a row whose own id set differs
    from the replayed one is counted (`flipped`, of `rows`) and takes the
    replayed ids, their probabilities renormalised in the kernel's order
    (`reference_gating`'s arithmetic); every other row keeps the call's
    own gates and ids.  Jamba's random router ranks near-tied experts, so
    a rounding may flip a route, and a flipped route moves a token's
    residual by O(1): runs compared point by point take the same
    routes."""

    def __init__(self):
        self.calls, self.at, self.flipped, self.rows = [], 0, 0, 0

    def route(self, mode, own, logits):
        import torch
        from repro_torch.kernels.moe_gating.ref import lane_butterfly_sum
        gate, idx = own
        if mode == "record":
            self.calls.append(idx.clone())
            return gate, idx
        ids = self.calls[self.at].to(idx.device, idx.dtype)
        self.at += 1
        same = (idx.sort(-1).values == ids.sort(-1).values).all(-1)
        self.rows += ids.shape[0]
        self.flipped += int((~same).sum())
        x = logits.float()
        p = torch.exp(x - x.amax(dim=-1, keepdim=True))
        p = p / lane_butterfly_sum(p)[:, None]
        g = p.gather(1, ids.long())
        total = g[:, 0]
        for j in range(1, g.shape[1]):
            total = total + g[:, j]
        g = (g / torch.clamp_min(total, 1e-9)[:, None]).to(gate.dtype)
        return (torch.where(same[:, None], gate, g),
                torch.where(same[:, None], idx, ids))

    def share(self, rows, k):
        """Every rank's copy of rank 0's recorded ids: one call for each
        entry of `rows` (its token rows), `k` ids a row (an all-sum of the
        flat ids, zeros off rank 0)."""
        import torch
        from repro_torch.sharding import ranks
        flat = torch.zeros(sum(rows) * k, dtype=torch.int64)
        if self.calls:
            flat[:] = torch.cat([c.reshape(-1).long().cpu()
                                 for c in self.calls])
        ranks.all_sum_(flat)
        self.calls = [c.view(n, k) for c, n in
                      zip(flat.split([n * k for n in rows]), rows)]

    def run(self, mode):
        """A context in which the model's router calls go through `route`
        in `mode` ("record" or "replay", from the first call)."""
        from repro_torch.models import moe
        log = self

        class Active:
            def __enter__(self):
                log.at = log.flipped = log.rows = 0
                self.real = fused, plain = (moe.fused_gating,
                                            moe.reference_gating)
                moe.fused_gating = lambda x, k, interpret=False: log.route(
                    mode, fused(x, k, interpret=interpret), x)
                moe.reference_gating = lambda x, k: log.route(
                    mode, plain(x, k), x)

            def __exit__(self, *exc):
                moe.fused_gating, moe.reference_gating = self.real
                return False
        return Active()


def sp_serve_smoke(rank, world, dev):
    """At smoke size, float32, TF32 off, on (1, W/2, 2) and (moved from
    `tp_serve_smoke`) Jamba on (1, 1, W): `sequence_parallel_rules` for
    Jamba, qwen3 with 3 K/V heads (they do not divide over "data") and
    the uneven-heads Mamba2, `fsdp_rules` over them for Jamba, each a
    prefill of 4 x 6 tokens and 3 decode steps on the card's ranks and
    on a mesh of the same ranks on the CPU (gloo), each card step from
    the CPU ranks' caches before it; then qwen3's scoring loss with the
    flash op on, its launches per rank counted: (name, the largest logit
    gap over its bound) and (flash launches, the loss gap over its
    bound)."""
    from dataclasses import replace
    import numpy as np
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as flash_ker
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import build_model, like_blocks, local_blocks
    from repro_torch.sharding import axes as ax
    sp = tp_serve_rules("seq_parallel")
    wide = (1, world // 2, 2)
    jamba = "jamba-1.5-large-398b"
    cases = [("seq_parallel", jamba, (1, 1, world), sp, {}),
             ("seq_parallel", jamba, wide, sp, {}),
             ("fsdp seq_parallel", jamba, wide, ax.fsdp_rules(sp, False), {}),
             ("seq_parallel", "qwen3-1.7b", wide, sp,
              {"n_heads": 6, "n_kv_heads": 3}),
             ("seq_parallel", "mamba2-2.7b", wide, sp,
              {"d_model": 48, "ssm_headdim": 32})]
    rng = np.random.default_rng(35)
    tokens = rng.integers(0, 512, (4, 6))
    steps = rng.integers(0, 512, (3, 4, 1))
    out = []
    for layout, arch, shape, rules, changes in cases:
        cfg = replace(get_smoke_config(arch), use_flash_kernel=True,
                      **changes)
        points, before = [], []
        for d in (torch.device("cpu"), dev):
            mesh = make_test_mesh(shape, DP_NAMES, d.type)
            model = build_model(cfg, d)
            params = model.init(torch.Generator().manual_seed(0),
                                torch.float32,
                                model.param_shardings(mesh, rules))
            with ax.use_rules(rules, mesh), torch.no_grad():
                logits, caches = model.prefill(params, {
                    "tokens": torch.as_tensor(tokens, device=d)}, 16)
                got = [logits.cpu()]
                for i in range(3):
                    if len(points) == 0:        # the CPU ranks' run
                        before.append(cache_copy(local_blocks(caches), d))
                    else:
                        caches = like_blocks(cache_copy(before[i], d),
                                             caches)
                    logits, caches = model.decode_step(params, torch.as_tensor(
                        steps[i], device=d), 6 + i, caches)
                    got.append(logits.cpu())
            points.append(got)
        atol = TP_SERVE_SMOKE_ATOL.get(arch, 1e-5)
        worst = max(float(((c - h).abs() / (1e-5 * h.abs() + atol + 1e-5
                                             * h.abs().max())).max())
                    for h, c in zip(*points))
        out.append((f"{layout} {arch}"
                    f"{' ' + str(changes) if changes else ''} {shape}",
                    worst))
    cfg = replace(get_smoke_config("qwen3-1.7b"), use_flash_kernel=True)
    batch = rng.integers(0, 512, (4, 32))
    losses, launches = [], 0
    for d in (torch.device("cpu"), dev):
        mesh = make_test_mesh(wide, DP_NAMES, d.type)
        model = build_model(cfg, d)
        params = model.init(torch.Generator().manual_seed(0), torch.float32,
                            model.param_shardings(mesh, sp))
        flash_ker.flash_attention_bhsd.launches = 0
        with ax.use_rules(sp, mesh), torch.no_grad():
            losses.append(float(model.loss(params, {
                "tokens": torch.as_tensor(batch, device=d)})[0]))
        launches = flash_ker.flash_attention_bhsd.launches
    score = (launches, abs(losses[1] - losses[0])
             / (1e-5 * abs(losses[0]) + 1e-5))
    return out, score


def sp_serve_rank(rank, world, dev):
    """One rank of `sp_serve_path`: `tp_serve_arch` for each arch of
    `SP_SERVE` under `sequence_parallel_rules` on (1, W/2, 2), then
    `sp_serve_smoke`.  Returns numbers only."""
    import gc
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    mesh = make_test_mesh((1, world // 2, 2), DP_NAMES, dev.type)
    out = {}
    for arch, spec in SP_SERVE.items():
        out[arch] = tp_serve_arch(arch, spec, rank, world, dev, mesh,
                                  counters)
        gc.collect()
        torch.cuda.empty_cache()
    out["smoke"] = sp_serve_smoke(rank, world, dev)
    return out


def sp_serve_path(timings):
    """Mamba2-2.7B and Jamba's period served over each of `sp_layouts`'
    rank sets under `sequence_parallel_rules` (`spawn_ranks`, one process
    per rank) with the smoke checks beside them, then `ssd_scan` at a
    "data" rank's shapes and `gating_topk` at Jamba's router shapes
    against their plain versions; fails on any rank's error or failed
    check.  Returns the launches per rank and the kernels' numbers."""
    import gc
    import torch
    from repro_torch.sharding.ranks import spawn_ranks
    gc.collect()
    torch.cuda.empty_cache()
    out = {"ssd_scan": {}, "gating_topk": {}, "flash_attention": {}}
    for backend, device, world in sp_layouts():
        label = (f"{backend}, {world} ranks on "
                 + (device if ":" in device else f"{world} cards")
                 + f", mesh (1, {world // 2}, 2), sequence_parallel_rules")
        t0 = time.perf_counter()
        res = spawn_ranks(sp_serve_rank, world, backend, device)
        secs = time.perf_counter() - t0
        ok = True
        for arch, spec in SP_SERVE.items():
            ok &= tp_serve_report(f"sp serve path ({label})", arch, spec,
                                  [r[arch] for r in res])
            for n in out:       # per rank: the prefill's, then each step's
                per = [[launch.get(n, 0) for launch in r[arch]["launches"]]
                       for r in res]
                if any(map(any, per)):
                    out[n][f"{arch} {backend}"] = per
        cases, (flash, loss_gap) = res[0]["smoke"]
        for name, worst in cases:
            print(f"sp serve smoke check ({label}) {name}: card against "
                  f"CPU ranks, float32, logits within {worst:.3f} of "
                  f"their bound")
            ok &= worst <= 1
        per_rank = [r["smoke"][1][0] for r in res]
        print(f"sp serve smoke check ({label}): qwen3's scoring loss with "
              f"the flash op on a 'data' rank's heads, card against CPU "
              f"ranks within {loss_gap:.3f} of rtol 1e-5 + 1e-5; flash "
              f"launches per rank {per_rank} (want 2 each: its layers)")
        ok &= loss_gap <= 1 and per_rank == [2] * world
        out["flash_attention"][f"smoke scoring {backend}"] = per_rank
        print(f"sp serve path ({label}): {secs:.1f} s")
        timings[f"sp serve {backend}"] = secs
        if not ok:
            raise AssertionError(f"sp serve path ({label}) failed its "
                                 "checks")
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    ssd = {
        "mamba2 40 of 80 heads": ssd_zoo_shape(
            dev, S=1024, nh=40, hd=64, st=128, seed=35,
            label="a 'data' rank's 40 of Mamba2's 80 heads, the prefill's "
                  "B*S 1024"),
        "jamba 128 of 256 heads float32": ssd_f32_shape(
            dev, S=1024, nh=128, hd=64, st=16, seed=36,
            label="a 'data' rank's 128 of Jamba's 256 heads, the "
                  "prefill's B*S 1024")}
    gating = gating_zoo_shapes(dev, ((1024, 16, 2), (1, 16, 2)), 135)
    timings["sp serve kernel shapes"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return dict(launches=out, ssd=ssd, gating=gating)


# ---------------------------------------------------------------------------
# the model zoo: the other dense and MoE configurations, the hybrid, the
# VLM and the encoder-decoder
# ---------------------------------------------------------------------------

ZOO_ARCHS = ("qwen3-14b", "phi4-mini-3.8b", "nemotron-4-15b",
             "moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "qwen2-vl-2b",
             "whisper-small")
# Full width at every one.  Depth: qwen3-14b whole (40 layers, ~29.6 GB
# of bf16 weights: the zoo's full-width main path); moonshot half (24 of
# 48, as SERVE_LAYERS cuts the other serving paths); phi4-mini and
# nemotron 4 layers each (scored only); Jamba one period (8 layers:
# attention at 3, MoE on the odd sub-layers) with d_ff 24576 cut to 8192,
# since one period at full width holds ~89 GB of bf16 weights and d_ff
# sets no kernel's shape; qwen2-vl-2b whole (28 layers) and whisper-small
# whole (12 decoder layers; its 12 encoder layers are its config's).
ZOO_LAYERS = {"qwen3-14b": 40, "phi4-mini-3.8b": 4, "nemotron-4-15b": 4,
              "moonshot-v1-16b-a3b": 24, "jamba-1.5-large-398b": 8,
              "qwen2-vl-2b": 28, "whisper-small": 12}
# served through ServeEngine (text prompts; the engine passes no frames,
# so whisper is served through Model.prefill / decode_step alone)
ZOO_SERVED = ("qwen3-14b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
              "qwen2-vl-2b")
JAMBA_D_FF = 8192
# the flash kernel at the zoo's scoring shapes (query heads, K/V heads,
# S, hd) at B 4: the GQA groups at hd 128 over 4096 positions (qwen2-vl's
# 12/2 over its 256-row vision prefix and 3840 tokens), and whisper's
# decoder self-attention, G 1 at hd 64 over 447 positions (padded to 512
# by ops.flash_attention)
ZOO_FLASH_SHAPES = ((40, 8, 4096, 128), (24, 8, 4096, 128),
                    (48, 8, 4096, 128), (16, 16, 4096, 128),
                    (64, 8, 4096, 128), (12, 2, 4096, 128),
                    (12, 12, 447, 64))
# whisper-small's encoder input: 30 s of audio after its conv stride
WHISPER_FRAMES = 1500
# the VLM's and the encoder-decoder's serving through Model.prefill and
# decode_step: 4 rows, qwen2-vl's 256-row vision prefix before a
# 1024-token prompt and 64 greedy steps; whisper's 1500 frames and a
# 4-token prompt, then 128 greedy steps
ZOO_PREFIX_SERVE = dict(rows=4, prompt=1024, steps=64)
ZOO_AUDIO_SERVE = dict(rows=4, prompt=4, steps=128)
# ssd_scan at Jamba's mixer: 256 heads x 64, state 16, chunk 128
ZOO_SSD = dict(nh=256, hd=64, st=16)
# gating_topk at moonshot's (E 64, k 6) and Jamba's (E 16, k 2) routers:
# a 1024-token prefill and a 4-slot decode step
ZOO_GATING = ((1024, 64, 6), (4, 64, 6), (1024, 16, 2), (4, 16, 2))
# Smoke goldens, float32 CPU vs card: GOLDEN_LOGIT_ATOL, as the dense
# goldens; Jamba's smoke attention has no qk-norm and scores of O(50)
# (the reference initializer's fan-in of the [d, H, hd] leaves), so its
# softmax amplifies a float32 reordering ~100x per attention layer
# (tests/test_torch_zoo.py shows it in the reference alone and holds
# the port to it at 1e-3, HYBRID_TOL there); whisper's encoder scores
# reach O(70) the same way (tests/test_torch_encdec.py).
ZOO_GOLDEN_ATOL = {"jamba-1.5-large-398b": 1e-3, "whisper-small": 1e-3}


def zoo_config(arch, smoke=False):
    """`arch`'s config with use_flash_kernel=True: its smoke config, or
    the published widths at ZOO_LAYERS' depth (Jamba's d_ff cut)."""
    import dataclasses
    from repro_torch.configs.base import get_config, get_smoke_config
    if smoke:
        return dataclasses.replace(get_smoke_config(arch),
                                   use_flash_kernel=True)
    cfg = dataclasses.replace(get_config(arch), use_flash_kernel=True,
                              n_layers=ZOO_LAYERS[arch])
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, d_ff=JAMBA_D_FF)
    return cfg


def zoo_layer_counts(cfg):
    """{attention, Mamba, MoE}: how many layers of each kind the stack
    has, i.e. the launches of flash (per scoring call), ssd_scan (per
    scoring call or prefill) and gating_topk (per call, prefill or decode
    step) one forward makes; the encoder-decoder's causal attention is
    its decoder's self-attention."""
    from repro_torch.models import lm
    if cfg.family == "audio":
        return {"flash_attention": cfg.n_layers, "ssd_scan": 0,
                "gating_topk": 0}
    kinds = lm._layer_kinds(cfg)
    kinds = kinds * (cfg.n_layers // len(kinds))
    return {"flash_attention": sum(m == "attn" for m, _ in kinds),
            "ssd_scan": sum(m == "mamba" for m, _ in kinds),
            "gating_topk": sum(f == "moe" for _, f in kinds)}


def zoo_launches():
    """The three model kernels' launch counts, by name."""
    counters = kernel_counters()
    return {k: counters[k].launches for k in
            ("flash_attention", "ssd_scan", "gating_topk")}


def zoo_reset():
    for k, c in kernel_counters().items():
        c.launches = 0


def kernel_device_ms(fn, reps, name):
    """Device time per launch of the kernel whose name holds `name`: its
    events in a profile of `reps` calls of `fn` after a warm-up.  A
    profile that saw another number of them than `reps` is taken again:
    one such profile, late in a run of this script, read 11 µs for a
    130 µs launch.  After three such profiles (one run of this script saw
    0, 38 and 16 of 50 launches) the time comes from CUDA events instead
    (`bracketed_device_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [v for n, v in device_activity(prof)[1].items() if name in n]
        calls = sum(c for c, _ in seen)
        if calls == reps:
            return sum(t for _, t in seen) * 1e3 / reps
        print(f"device time: the profile saw {calls} launches of {name} "
              f"in {reps} calls; profiling again")
    ms = bracketed_device_ms(fn, reps)
    print(f"device time of {name}: three profiles dropped launches; CUDA "
          f"events around {reps} launches queued behind a spin kernel "
          f"read {ms * 1e3:.3f} us per launch")
    return ms


def bracketed_device_ms(fn, reps):
    """Device time per call of `fn`: CUDA events around `reps`
    back-to-back calls queued behind `torch.cuda._sleep`, after a
    warm-up.  The host queues every call while the card spins, so the
    events time the card's work and not the host's launches (a 17 µs
    launch read 41 µs back to back, and 21 µs with events between the
    launches, which add ~4 µs each)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)              # ~25 ms at 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_zoo_shape(dev, H, Hk, seed, S=SCORE_SEQ, hd=128):
    """The bf16 kernel at B 4, (H, Hk), S, hd causal against its plain
    versions (`check_flash_case`), then the times of the kernel, its plain
    version and `scaled_dot_product_attention` beside the bound: the
    kernel's and SDPA's device time per call from CUDA events around calls
    queued behind a spin kernel (`bracketed_device_ms`: whisper's 447 rows
    take ~17 µs, where calls timed back to back time the host; one
    profiled window of SDPA summed half its kernels' time, below the
    bound), the plain version's from CUDA events around back-to-back
    calls.  The kernel and
    its plain version take q, k and v padded to the blocks
    `ops.flash_attention` picks, with kv_len S, as the scoring path
    launches it; SDPA and the bound take the S rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import _pad_to
    from repro_torch.kernels.flash_attention.ref import rounded_flash_bhsd
    B = SCORE_BATCH
    err = check_flash_case(dev, B, S, H, Hk, hd, torch.bfloat16, True, seed)
    q, k, v = (x.transpose(1, 2).contiguous() for x in flash_inputs(
        dev, B, S, H, Hk, hd, torch.bfloat16, seed))
    block = min(128, max(8, 1 << (S - 1).bit_length()))
    qp, kp, vp = (_pad_to(x, block) for x in (q, k, v))
    kw = dict(causal=True, kv_len=S)
    fns = {"kernel": (lambda: fk.flash_attention_bhsd(
               qp, kp, vp, block_q=block, block_k=block, **kw), 10),
           "plain": (lambda: rounded_flash_bhsd(qp, kp, vp, **kw), 2),
           "SDPA": (lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True), 10)}
    events = {n: (cuda_time_ms if n == "plain" else bracketed_device_ms)(
        fn, reps) for n, (fn, reps) in fns.items()}
    n_bytes, n_flop = flash_bound(B, S, H, Hk, hd, 2)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / BF16_FLOP_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"kernel time: flash_attention B={B} S={S} (padded "
          f"{qp.shape[2]}) H={H} Hk={Hk} (G {H // Hk}) hd={hd} bf16 causal, "
          f"ms per call by CUDA events (kernel and SDPA queued behind a "
          f"spin kernel): "
          + ", ".join(f"{n} {events[n]:.4f}" for n in fns)
          + f"; bound {bound_ms:.4f} ms ({by}: {n_flop} flop at 989 TFLOP/s "
          f"bf16, {n_bytes} B at 3.35 TB/s); kernel at "
          f"{bound_ms / events['kernel']:.3f} of the bound, SDPA at "
          f"{bound_ms / events['SDPA']:.3f}")
    del q, k, v, qp, kp, vp
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=events["kernel"],
                plain_ms=events["plain"], bound_ms=bound_ms, bound_by=by,
                library_ms=events["SDPA"])


def ssd_zoo_shape(dev, S=1024, nh=None, hd=None, st=None,
                  label="Jamba's mixer", seed=16):
    """The bf16 tensor-core kernel at Jamba's mixer (S 1024, 256 heads x
    64, state 16, chunk 128; st 16 the wgmma N tile), or at the shape
    given, against its plain version and the reference's function within
    the derived bounds (as `check_ssd_kernel`), the full scan within its
    bound of interpret=True; then times beside the bound."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ker
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import (intra_chunk_majorants,
                                                  reference_intra_chunk,
                                                  split_intra_chunk)
    Q = 128
    nh = ZOO_SSD["nh"] if nh is None else nh
    hd = ZOO_SSD["hd"] if hd is None else hd
    st = ZOO_SSD["st"] if st is None else st
    if not ker.uses_tensor_cores(Q, hd, st, torch.bfloat16):
        raise AssertionError(f"ssd_scan at {label}: expected the "
                             "tensor-core kernel")
    args = ssd_inputs(dev, S, seed=seed, nh=nh, hd=hd, st=st)
    before = ker.ssd_intra_chunk.launches
    got = ker.ssd_intra_chunk(*args, Q)
    torch.cuda.synchronize()
    if ker.ssd_intra_chunk.launches != before + 1 or \
            not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"ssd_scan at {label}: not launched, or an "
                             "output is not finite")
    co = ssd_coefficients(Q, st, S // Q)
    majorants = intra_chunk_majorants(*args, Q)
    split = ssd_shares(got, split_intra_chunk(*args, Q), majorants, co,
                       "split")
    ref = ssd_shares(got, reference_intra_chunk(*args, Q), majorants, co,
                     "ref")
    y_k = ops.ssd_scan(*args, chunk=Q)
    y_p = ops.ssd_scan(*args, chunk=Q, interpret=True)
    t_full = ops.ssd_scan(args[0].abs(), args[1], args[2].abs(),
                          args[3].abs(), chunk=Q, interpret=True)
    d_full = (y_k - y_p).abs()
    full = float(torch.where(d_full > 0, d_full / (co["full"] * t_full),
                             0.0).max())
    print(f"kernel check: ssd_scan S={S}, {nh} heads x {hd}, state {st}, "
          f"chunk {Q} ({label}), bf16 inputs, tensor cores: vs its "
          f"plain version (split_intra_chunk) y {split['y']:.3e} and h "
          f"{split['h']:.3e} of the derived bound (y max abs err "
          f"{split['err']:.3e}); vs the reference's function y "
          f"{ref['y']:.3e} and h {ref['h']:.3e} of it; a and the prefix sums "
          f"bitwise {split['exact'] and ref['exact']}; full scan vs "
          f"interpret=True {full:.3e} of its bound")
    if not (max(split["y"], split["h"], ref["y"], ref["h"], full) <= 1
            and split["exact"] and ref["exact"]
            and y_k.shape == (1, S, nh, hd)):
        raise AssertionError(f"ssd_scan at {label}: the kernel is outside "
                             "its derived bounds")
    ms = kernel_device_ms(lambda: ker.ssd_intra_chunk(*args, Q), 50,
                          "ssd_intra_chunk")
    plain_ms = cuda_time_ms(lambda: split_intra_chunk(*args, Q), 3)
    n_bytes, n_flop = ssd_bound(S, Q, nh, hd, st)
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S, n_flop / BF16_FLOP_PER_S
    by = "bytes" if t_bytes >= t_flop else "operations"
    bound_s = max(t_bytes, t_flop)
    print(f"kernel time: ssd_scan S={S} nh {nh} hd {hd} st {st} bf16: "
          f"device time per launch {ms * 1e3:.3f} us (kernel_device_ms); "
          f"plain version (split_intra_chunk) "
          f"{plain_ms * 1e3:.3f} us by CUDA events; bound "
          f"{bound_s * 1e6:.3f} us ({by}: {n_bytes} B at 3.35 TB/s = "
          f"{t_bytes * 1e6:.3f} us, {n_flop} flop at 989 TFLOP/s bf16 = "
          f"{t_flop * 1e6:.3f} us); kernel at {bound_s * 1e3 / ms:.3f} of the "
          f"bound")
    return dict(max_abs_err=split["err"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=by, library_ms=None)


def ssd_f32_shape(dev, S, nh, hd, st, seed, label):
    """The CUDA-core kernel on float32 inputs at `label`'s shape (a
    float32 run's prefill), bitwise its plain version (as
    `check_ssd_kernel`'s float32 case); then times beside the bound on
    the float32 CUDA cores."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ker
    from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
    Q = 128
    xdt, log_a, b, c = ssd_inputs(dev, S, seed=seed, nh=nh, hd=hd, st=st)
    args = (xdt.float(), log_a, b.float(), c.float())
    if ker.uses_tensor_cores(Q, hd, st, torch.float32):
        raise AssertionError(f"ssd_scan at {label}: expected the CUDA-core "
                             "kernel")
    got = ker.ssd_intra_chunk(*args, Q)
    want = reference_intra_chunk(*args, Q)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"ssd_scan at {label}: the CUDA-core kernel "
                             "differs from its plain version")
    ms = kernel_device_ms(lambda: ker.ssd_intra_chunk(*args, Q), 50,
                          "ssd_intra_chunk")
    plain_ms = cuda_time_ms(lambda: reference_intra_chunk(*args, Q), 3)
    n_bytes, n_flop = ssd_bound(S, Q, nh, hd, st, in_bytes=4)
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S
    by = "bytes" if t_bytes >= t_flop else "operations"
    bound_s = max(t_bytes, t_flop)
    print(f"kernel check: ssd_scan S={S}, {nh} heads x {hd}, state {st}, "
          f"chunk {Q} ({label}), float32, CUDA cores: all four outputs "
          f"bitwise its plain version (reference_intra_chunk); device time "
          f"per launch {ms * 1e3:.3f} us, plain version {plain_ms * 1e3:.3f} "
          f"us by CUDA events; bound {bound_s * 1e6:.3f} us ({by}: {n_bytes} "
          f"B at 3.35 TB/s = {t_bytes * 1e6:.3f} us, {n_flop} flop at 67 "
          f"TFLOP/s float32 = {t_flop * 1e6:.3f} us); kernel at "
          f"{bound_s * 1e3 / ms:.3f} of the bound")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=by, library_ms=None)


def gating_zoo_shapes(dev, shapes=ZOO_GATING, seed0=100):
    """The kernel bitwise its plain version at moonshot's and Jamba's
    router shapes (or `shapes`, (N, E, k) each), ordinary and non-finite
    rows; times at each."""
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.kernels.moe_gating.ref import reference_gating
    out = {}
    for seed, (N, E, k) in enumerate(shapes):
        err = check_gating_case(dev, N, E, k, seed0 + seed)
        check_gating_non_finite(dev, N, E, k)
        x = gating_logits(dev, N, E, N + E)
        ms = kernel_device_ms(lambda: gk.gating_topk(x, k), 200,
                              "gating_topk")
        plain_ms = cuda_time_ms(lambda: reference_gating(x, k), 20)
        n_bytes, n_ops = gating_bound(N, E, k)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S
        by = "bytes" if t_bytes >= t_ops else "operations"
        out[f"N{N}_E{E}_k{k}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3, bound_by=by,
            library_ms=None)
        print(f"kernel time: gating_topk N={N} E={E} k={k}: device time per "
              f"launch {ms * 1e3:.3f} us (kernel_device_ms); plain "
              f"{plain_ms * 1e3:.3f} us by CUDA events (back to back, the "
              f"host's launches included); bound "
              f"{max(t_bytes, t_ops) * 1e6:.4f} us ({by}: {n_bytes} B, "
              f"{n_ops} operations at 67 TFLOP/s float32)")
    return out


def zoo_kernel_checks(dev):
    """Each model kernel at the zoo's shapes against its plain version,
    with its times and bound."""
    flash = {f"H{H}_Hk{Hk}" + ("" if (S, hd) == (SCORE_SEQ, 128) else
                               f"_S{S}_hd{hd}"):
             flash_zoo_shape(dev, H, Hk, 30 + i, S, hd)
             for i, (H, Hk, S, hd) in enumerate(ZOO_FLASH_SHAPES)}
    return flash, ssd_zoo_shape(dev), gating_zoo_shapes(dev)


def zoo_batch(cfg, B, S, dtype, seed=0):
    """The scoring batch of `cfg`'s family, on the CPU, S positions a row:
    tokens [B, S]; the VLM's tokens [B, S − frontend_seq] after
    vision_embeds [B, frontend_seq, d] (the train_4k batch of
    `src/repro/launch/shapes.py`); the encoder-decoder's frames [B, S, d]
    and tokens [B, dec_max_seq].  Tokens from numpy, embeddings unit
    normals in `dtype` from a seeded generator (the token embeddings' own
    scale)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    normal = lambda n: torch.randn((B, n, cfg.d_model), generator=gen) \
        .to(dtype)
    if cfg.family == "audio":
        return {"frames": normal(S), "tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (B, cfg.dec_max_seq)))}
    if cfg.family == "vlm":
        sv = cfg.frontend_seq
        return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                       (B, S - sv))),
                "vision_embeds": normal(sv)}
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)))}


def batch_to(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


def describe_batch(batch):
    return ", ".join(f"{k} {list(v.shape)}" for k, v in batch.items())


def zoo_score_golden(dev, arch):
    """`arch`'s smoke config scored in float32 on the CPU (every kernel's
    plain version) and on the card (the kernels), same weights: losses
    within SCORE_LOSS_RTOL, and one launch per layer of each kernel's
    kind per call."""
    import numpy as np
    import torch
    from repro_torch.models.api import build_model
    cfg = zoo_config(arch, smoke=True)
    on_cpu = build_model(cfg, "cpu")
    params = on_cpu.init(torch.Generator().manual_seed(0), torch.float32)
    batch = zoo_batch(cfg, SCORE_BATCH, 77, torch.float32)
    want = zoo_layer_counts(cfg)
    with torch.inference_mode():
        a = float(on_cpu.loss(params, batch)[0])
        zoo_reset()
        b = float(build_model(cfg, dev).loss(to_dev(params, dev),
                                             batch_to(batch, dev))[0])
    got = zoo_launches()
    rel = abs(a - b) / abs(a)
    print(f"zoo scoring golden: {arch} smoke_config float32, "
          f"{describe_batch(batch)}: loss CPU {a:.7f}, card {b:.7f}, "
          f"relative difference {rel:.3e} (tolerance {SCORE_LOSS_RTOL}); "
          f"launches {got}")
    if not (np.isfinite(b) and rel <= SCORE_LOSS_RTOL and got == want):
        raise AssertionError(f"zoo scoring golden {arch}: loss {b} on the "
                             f"card vs {a} on the CPU, launches {got} "
                             f"(want {want})")


def greedy_decode(model, params, batch, max_seq, steps):
    """`Model.prefill` of `batch`, then `steps` greedy `decode_step`s of
    every row from the prefilled length (the VLM's prefix included):
    (tokens [rows, steps + 1] on the CPU, every step's logits stacked,
    prefill seconds, decode seconds), synchronised on the card."""
    import torch
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else lambda: None)
    pos = batch["tokens"].shape[1] + (batch["vision_embeds"].shape[1]
                                      if "vision_embeds" in batch else 0)
    sync()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch, max_seq)
    sync()
    t1 = time.perf_counter()
    out = [logits]
    for i in range(steps):
        tok = torch.argmax(out[-1], -1)[:, None]
        logits, caches = model.decode_step(params, tok, pos + i, caches)
        out.append(logits)
    sync()
    t2 = time.perf_counter()
    logits = torch.stack(out, 1)
    return (torch.argmax(logits, -1).cpu(), logits.float().cpu(),
            t1 - t0, t2 - t1)


def encdec_serve_golden(dev, arch, atol):
    """The encoder-decoder's smoke config in float32 on the CPU and on the
    card, same weights and inputs (4 rows of 77 frames, a 4-token prompt,
    8 greedy steps through `Model.prefill` and `decode_step`, as the
    engine cannot serve it): the same tokens, logits within `atol`."""
    import torch
    from repro_torch.models.api import build_model
    cfg = zoo_config(arch, smoke=True)
    on_cpu = build_model(cfg, "cpu")
    params = on_cpu.init(torch.Generator().manual_seed(0), torch.float32)
    batch = zoo_batch(cfg, SCORE_BATCH, 77, torch.float32, seed=1)
    batch["tokens"] = batch["tokens"][:, :4]
    with torch.inference_mode():
        a = greedy_decode(on_cpu, params, batch, 77, GOLDEN_NEW)
        b = greedy_decode(build_model(cfg, dev), to_dev(params, dev),
                          batch_to(batch, dev), 77, GOLDEN_NEW)
    err = float((a[1] - b[1]).abs().max())
    print(f"serving golden: {arch} smoke_config float32, "
          f"{describe_batch(batch)}, {GOLDEN_NEW} greedy steps: tokens "
          f"equal {torch.equal(a[0], b[0])}; logits max abs diff "
          f"{err:.3e} (tolerance {atol}) of max |logit| "
          f"{float(a[1].abs().max()):.4f}")
    if not (torch.equal(a[0], b[0]) and err <= atol):
        raise AssertionError(f"serving golden {arch}: tokens differ or "
                             f"logits off by {err}, CPU vs card")
    return err


def zoo_goldens(dev):
    """Each zoo architecture's smoke golden: serving (tokens equal, prefill
    logits within GOLDEN_LOGIT_ATOL or ZOO_GOLDEN_ATOL; the
    encoder-decoder's through `encdec_serve_golden`) and scoring."""
    gaps = {}
    for arch in ZOO_ARCHS:
        atol = ZOO_GOLDEN_ATOL.get(arch, GOLDEN_LOGIT_ATOL)
        if zoo_config(arch, smoke=True).family == "audio":
            gaps[arch] = encdec_serve_golden(dev, arch, atol)
        else:
            gaps[arch] = serve_golden(dev, arch, atol)
        zoo_score_golden(dev, arch)
    return gaps


def zoo_build(dev, arch):
    """(model, bf16 params) at `zoo_config(arch)` on the card, drawn from a
    generator seeded with 0."""
    import torch
    from repro_torch.models.api import build_model
    cfg = zoo_config(arch)
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16)
    torch.cuda.synchronize()
    extra = (f", {cfg.n_experts} experts top-{cfg.top_k}" if cfg.is_moe
             else "")
    if cfg.family == "hybrid":
        extra += (f", {cfg.ssm_heads} SSM heads x {cfg.ssm_headdim}, state "
                  f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, periods of "
                  f"{cfg.attn_period} (attention at {cfg.attn_offset}, MoE "
                  f"every {cfg.moe_period})")
    print(f"zoo: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} query heads over {cfg.n_kv_heads} K/V heads x "
          f"{cfg.hd}, d_ff {cfg.d_ff}, {cfg.act}{extra}, vocab {cfg.vocab}: "
          f"{model.n_params():,} bf16 parameters drawn in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    return model, params


def zoo_checked_call(model, params, batch):
    """One more `Model.loss` call with every kernel launch held against
    its plain version on the inputs the path gives it: flash against
    `rounded_flash_bhsd` (FLASH_BF16_ULP, FLASH_F32_RTOL and its flip
    slack) and against the reference's function (FLASH_P_ROUND·max |v|
    more), the SSD scan against interpret=True within the derived bound
    of the full scan, the gates and ids bitwise.  Returns
    {kernel: (calls checked, worst share of its bound)}; raises beyond."""
    import torch
    from repro_torch.kernels.flash_attention.ref import rounded_flash_bhsd
    from repro_torch.kernels.moe_gating.ref import reference_gating
    from repro_torch.models import attention, moe, ssm
    bhsd = lambda x: x.transpose(1, 2).contiguous()
    worst = {"flash_attention": [0, 0.0], "ssd_scan": [0, 0.0],
             "gating_topk": [0, 0.0]}
    real_flash = attention.fa.flash_attention
    real_ssd = ssm.ssd_ops.ssd_scan
    real_gating = moe.fused_gating

    def note(name, share):
        worst[name][0] += 1
        worst[name][1] = max(worst[name][1], share)

    def flash(q, k, v, causal=True, interpret=False, **kw):
        got = real_flash(q, k, v, causal=causal, interpret=interpret, **kw)
        plain, slack = rounded_flash_bhsd(bhsd(q), bhsd(k), bhsd(v),
                                          causal=causal, kv_len=k.shape[1],
                                          with_slack=True)
        share = flash_within(bhsd(got), plain, slack)[1]
        ref = real_flash(q, k, v, causal=causal, interpret=True, **kw)
        v_max = bhsd(v).float().abs().amax(dim=(2, 3)).repeat_interleave(
            q.shape[2] // k.shape[2], dim=1)[..., None, None]
        note("flash_attention", max(share, flash_within(
            bhsd(got), bhsd(ref), FLASH_P_ROUND * v_max)[1]))
        return got

    def ssd(xdt, log_a, b, c, chunk=128, interpret=False):
        got = real_ssd(xdt, log_a, b, c, chunk=chunk, interpret=interpret)
        want = real_ssd(xdt, log_a, b, c, chunk=chunk, interpret=True)
        mags = real_ssd(xdt.abs(), log_a, b.abs(), c.abs(), chunk=chunk,
                        interpret=True)
        Q = min(chunk, xdt.shape[1])
        co = ssd_coefficients(Q, b.shape[-1], -(-xdt.shape[1] // Q))
        d = (got - want).abs()
        note("ssd_scan", float(torch.where(d > 0, d / (co["full"] * mags),
                                           0.0).max()))
        return got

    def gating(logits, k, interpret=False):
        gate, idx = real_gating(logits, k, interpret=interpret)
        want_gate, want_idx = reference_gating(logits, k)
        note("gating_topk", 0.0 if same_bits(gate, want_gate)
             and same_bits(idx, want_idx) else float("inf"))
        return gate, idx

    attention.fa.flash_attention, ssm.ssd_ops.ssd_scan, moe.fused_gating = \
        flash, ssd, gating
    try:
        model.loss(params, batch)
    finally:
        attention.fa.flash_attention, ssm.ssd_ops.ssd_scan, \
            moe.fused_gating = real_flash, real_ssd, real_gating
    out = {k: tuple(v) for k, v in worst.items()}
    if any(share > 1 for _, share in out.values()):
        raise AssertionError(f"zoo scoring {model.cfg.name}: a kernel call "
                             f"on the path is outside its bound: {out}")
    return out


def zoo_rounded_loss(model, params, batch):
    """The loss with every kernel's plain version (`rounded_flash_bhsd`,
    `split_intra_chunk`; the gating's is bitwise the kernel's), through
    the interpret=True model.  Launches nothing."""
    from repro_torch.kernels.flash_attention.ref import rounded_flash_bhsd
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import split_intra_chunk
    from repro_torch.models import attention
    from repro_torch.models.api import build_model
    bhsd = lambda x: x.transpose(1, 2).contiguous()

    def rounded_op(q, k, v, causal=True, **_):
        return bhsd(rounded_flash_bhsd(bhsd(q), bhsd(k), bhsd(v),
                                       causal=causal, kv_len=k.shape[1]))

    plain_model = build_model(model.cfg, model.device, interpret=True)
    real_flash, real_ssd = attention.fa.flash_attention, \
        ssd_ops.reference_intra_chunk
    attention.fa.flash_attention = rounded_op
    ssd_ops.reference_intra_chunk = split_intra_chunk
    try:
        return float(plain_model.loss(params, batch)[0])
    finally:
        attention.fa.flash_attention = real_flash
        ssd_ops.reference_intra_chunk = real_ssd


def zoo_score(dev, model, params):
    """`Model.loss` on [4, 4096] positions (`zoo_batch`: the VLM's 256
    vision rows and 3840 tokens; whisper's 1500 frames and its decoder's
    448 tokens) under `torch.inference_mode()`:
    a warm-up call, SCORE_CALLS timed calls (each kernel launched once per
    layer of its kind per call), one call on the batch's first row (the
    main path's shapes per row, a quarter of the plain versions' time)
    with every kernel launch held against its plain version on its own
    inputs (`zoo_checked_call`), the loss against the same model through
    the kernels' plain versions (L_rounded), one profiled call.  Returns
    the numbers and the launches.

    The loss is held within SCORE_LOSS_RTOL of L_rounded where the
    configuration has qk-norm (qwen3-14b), as `score_main_path` holds
    Qwen3-1.7B; without qk-norm L_rounded is not run (it only printed a
    gap; cut in PR 32 for the script's time).  Without qk-norm the
    random-weight scores reach O(1000)
    at these widths (the reference's initializer scales q and k by
    1/sqrt(heads)), the softmax is nearly an argmax, and the stack
    amplifies any admissible difference in one layer's output into the
    next layers' routing of attention: there the per-call checks hold the
    kernels, and the losses are printed."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    name = cfg.name
    batch = batch_to(zoo_batch(
        cfg, SCORE_BATCH, WHISPER_FRAMES if cfg.family == "audio" else
        SCORE_SEQ, torch.bfloat16), dev)
    scored = SCORE_BATCH * (batch["tokens"].shape[1] - 1)
    per_call = zoo_layer_counts(cfg)
    with torch.inference_mode():
        model.loss(params, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        zoo_reset()
        for _ in range(SCORE_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, metrics = model.loss(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launches = zoo_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {k: SCORE_CALLS * n for k, n in per_call.items()}
        if launches != want:
            raise AssertionError(f"zoo scoring {name}: launches {launches} "
                                 f"in {SCORE_CALLS} calls, want {want}")
        if not (np.isfinite(losses[0]) and len(set(losses)) == 1 and
                float(metrics["tokens"]) == scored):
            raise AssertionError(f"zoo scoring {name}: losses {losses}, "
                                 f"{float(metrics['tokens'])} tokens scored "
                                 f"(want {scored})")
        t0 = time.perf_counter()
        checked = zoo_checked_call(model, params,
                                   {k: v[:1] for k, v in batch.items()})
        check_wall = time.perf_counter() - t0
        if {k: n for k, (n, _) in checked.items()} != per_call:
            raise AssertionError(f"zoo scoring {name}: checked {checked}, "
                                 f"want {per_call} calls")
        rounded, plain_wall = None, 0.0
        if cfg.qk_norm:
            zoo_reset()
            t0 = time.perf_counter()
            rounded = zoo_rounded_loss(model, params, batch)
            plain_wall = time.perf_counter() - t0
            if any(zoo_launches().values()):
                raise AssertionError(f"zoo scoring {name}: the plain run "
                                     "launched a kernel")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.loss(params, batch)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    busy, by_name = device_activity(prof)
    gap = abs(losses[0] - rounded) / abs(rounded) if cfg.qk_norm else None
    held = (f"L_rounded (the kernels' plain versions) {rounded:.6f}, "
            f"relative difference {gap:.3e} (gated at {SCORE_LOSS_RTOL}); "
            f"the plain run {plain_wall:.2f} s" if cfg.qk_norm else
            "L_rounded not run (no qk-norm: it gated nothing; cut in PR 32 "
            "for the script's time)")
    n_tokens = sum(v.shape[0] * v.shape[1] for v in batch.values())
    ms = [w * 1e3 for w in walls]
    print(f"zoo scoring {name} ({describe_batch(batch)}): "
          f"{[round(m, 2) for m in ms]} ms per call "
          f"({n_tokens / min(walls):.1f} positions/s at the fastest); "
          f"launches "
          f"{launches} (= {SCORE_CALLS} calls x {per_call}); losses bitwise "
          f"equal across calls; peak device memory {peak:.2f} GiB; L_kernel "
          f"{losses[0]:.6f}, {held}; every kernel call of one more call "
          f"against its plain version on its own inputs (calls, worst share "
          f"of the bound): {checked}, {check_wall:.2f} s")
    for kname, (calls, secs) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])[:6]:
        print(f"  device {secs:8.4f} s {calls:8d} calls  {kname[:90]}")
    kernel_s = {k: sum(v[1] for n, v in by_name.items() if key in n)
                for k, key in (("flash_attention", "flash_fwd"),
                               ("ssd_scan", "ssd_intra_chunk"),
                               ("gating_topk", "gating_topk"))}
    print(f"zoo scoring {name} profiled call (card activity): "
          f"{prof_wall * 1e3:.1f} ms wall, device busy {busy * 1e3:.1f} ms, "
          f"idle share {1 - busy / prof_wall:.3f}, "
          f"{sum(c for c, _ in by_name.values())} kernels and copies; the "
          f"model kernels' device time "
          + ", ".join(f"{k} {s * 1e3:.3f} ms" for k, s in kernel_s.items()))
    if cfg.qk_norm and not gap <= SCORE_LOSS_RTOL:
        raise AssertionError(f"zoo scoring {name}: loss {losses[0]} through "
                             f"the kernels vs {rounded} through their plain "
                             "versions")
    return dict(ms=ms, tokens_per_s=n_tokens / min(walls), peak_gib=peak,
                idle=1 - busy / prof_wall, launches=launches)


def zoo_serve(dev, model, params):
    """`ServeEngine` with SERVE's traffic (8 requests of 1024 tokens, 4
    slots, 32 new tokens): a run with every kernel's launches equal to
    its layers x (prefills for ssd_scan; prefills + decode steps for
    gating_topk; none for flash, since prefill and decode take the plain
    attention, as the reference's).  The profiled repeat of PRs 30–31 was
    cut in PR 32 for the script's time.  (The router's equality with its
    plain version is `zoo_checked_call`'s, bitwise, and granite's serving
    phase runs the plain router end to end.)"""
    import numpy as np
    import torch
    cfg = model.cfg
    name = cfg.name
    per = zoo_layer_counts(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=SERVE["prompt_len"])
               for _ in range(SERVE_REQUESTS)]
    serve = lambda m: serve_once(m, params, prompts, SERVE, SERVE_NEW)
    torch.cuda.reset_peak_memory_stats()
    zoo_reset()
    runs = [serve(model)]
    st = runs[0]["stats"]
    want = {"flash_attention": 0,
            "ssd_scan": per["ssd_scan"] * st["prefills"],
            "gating_topk": per["gating_topk"] * (st["prefills"]
                                                 + st["decode_steps"])}
    runs[0]["launches"] = zoo_launches()
    if runs[0]["launches"] != want or st["prefills"] != SERVE_REQUESTS:
        raise AssertionError(f"zoo serving {name}: launches "
                             f"{runs[0]['launches']} for {st}, want {want}")
    for out in runs[0]["outputs"]:
        if len(out) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"zoo serving {name}: bad output {out}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print_serving_runs(runs, f"zoo serving {name}")
    print(f"zoo serving {name}: launches {runs[0]['launches']} (layers "
          f"{per} x prefills / + decode steps); every logit finite; "
          f"peak device memory {peak:.2f} GiB; first tokens "
          f"{[o[:4] for o in runs[0]['outputs'][:2]]}")
    r = runs[0]
    st = r["stats"]
    return dict(prefill_ms=r["prefill_s"] / st["prefills"] * 1e3,
                decode_ms=(r["wall"] - r["prefill_s"]) / st["decode_steps"]
                * 1e3,
                tokens_per_s=st["tokens"] / r["wall"], peak_gib=peak,
                launches=r["launches"])


def zoo_model_serve(dev, model, params):
    """The VLM's and the encoder-decoder's serving through `Model.prefill`
    and `decode_step` (`greedy_decode`): qwen2-vl-2b's 4 rows of a
    256-row vision prefix and a 1024-token prompt, then 64 steps from pos
    1280; whisper-small's 4 rows of 1500 frames and a 4-token prompt,
    then 128 steps.  A timed run with no kernel launched (prefill and
    decode take the plain attention, as the reference's), every logit
    finite.  (The profiled repeat of PR 31 was cut in PR 32 for the
    script's time.)"""
    import torch
    cfg = model.cfg
    name = cfg.name
    if cfg.family == "audio":
        kw = ZOO_AUDIO_SERVE
        batch = zoo_batch(cfg, kw["rows"], WHISPER_FRAMES, torch.bfloat16,
                          seed=2)
        max_seq = WHISPER_FRAMES
    else:
        kw = ZOO_PREFIX_SERVE
        batch = zoo_batch(cfg, kw["rows"], cfg.frontend_seq + kw["prompt"],
                          torch.bfloat16, seed=2)
        max_seq = cfg.frontend_seq + kw["prompt"] + kw["steps"]
    batch = batch_to(batch, dev)
    batch["tokens"] = batch["tokens"][:, :kw["prompt"]]
    run = lambda: greedy_decode(model, params, batch, max_seq, kw["steps"])
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        zoo_reset()
        tokens, logits, prefill_s, decode_s = run()
        launches = zoo_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(launches.values()) or not bool(torch.isfinite(logits).all()) \
            or not (tokens.shape == (kw["rows"], kw["steps"] + 1)
                    and bool(((0 <= tokens) & (tokens < cfg.vocab)).all())):
        raise AssertionError(f"zoo serving {name}: launches {launches}, "
                             f"tokens {tuple(tokens.shape)} or a logit not "
                             "finite")
    decode_ms = decode_s / kw["steps"] * 1e3
    gen = kw["rows"] * (kw["steps"] + 1)
    print(f"zoo serving {name} through Model.prefill and decode_step "
          f"({describe_batch(batch)}, {kw['steps']} greedy steps): prefill "
          f"{prefill_s * 1e3:.2f} ms, decode {decode_ms:.2f} ms per step "
          f"({gen / (prefill_s + decode_s):.1f} generated tokens/s); "
          f"launches {launches}; every logit finite; peak device memory "
          f"{peak:.2f} GiB; first tokens {tokens[:2, :6].tolist()}")
    return dict(prefill_ms=prefill_s * 1e3, decode_ms=decode_ms,
                tokens_per_s=gen / (prefill_s + decode_s), peak_gib=peak,
                launches=launches)


def zoo_section(dev, timings):
    """The goldens, the kernels at the zoo's shapes, then each
    architecture at full width: scored, and served where ZOO_SERVED says;
    the weights freed before the next."""
    import gc
    import torch
    t0 = time.perf_counter()
    zoo_goldens(dev)
    timings["zoo goldens"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flash, ssd, gating = zoo_kernel_checks(dev)
    timings["zoo kernel checks"] = time.perf_counter() - t0
    runs = {}
    for arch in ZOO_ARCHS:
        t0 = time.perf_counter()
        model, params = zoo_build(dev, arch)
        runs[arch] = {"score": zoo_score(dev, model, params)}
        if arch in ZOO_SERVED:
            runs[arch]["serve"] = zoo_serve(dev, model, params)
        if model.cfg.family in ("vlm", "audio"):
            runs[arch]["model serve"] = zoo_model_serve(dev, model, params)
        # the engine and its Recorder refer to each other: collect the
        # cycle, or the weights outlive this iteration
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        timings[f"zoo {arch}"] = time.perf_counter() - t0
    launches = {k: {f"{arch} {what}": r["launches"][k]
                    for arch, rs in runs.items() for what, r in rs.items()}
                for k in ("flash_attention", "ssd_scan", "gating_topk")}
    q = runs["qwen3-14b"]
    print(f"zoo main path qwen3-14b ({ZOO_LAYERS['qwen3-14b']} layers, "
          f"full width): scoring "
          f"{min(q['score']['ms']):.2f} ms per call, "
          f"{q['score']['tokens_per_s']:.1f} tokens/s, idle share "
          f"{q['score']['idle']:.3f}, peak {q['score']['peak_gib']:.2f} GiB; "
          f"serving prefill {q['serve']['prefill_ms']:.2f} ms per request, "
          f"decode {q['serve']['decode_ms']:.2f} ms per step, "
          f"{q['serve']['tokens_per_s']:.1f} tokens/s, peak "
          f"{q['serve']['peak_gib']:.2f} GiB; flash launches "
          f"{q['score']['launches']['flash_attention']} (= {SCORE_CALLS} "
          f"calls x {ZOO_LAYERS['qwen3-14b']} layers)")
    for arch in ("qwen2-vl-2b", "whisper-small"):
        r = runs[arch]
        print(f"zoo {arch} ({ZOO_LAYERS[arch]} layers, full width): scoring "
              f"{min(r['score']['ms']):.2f} ms per call, idle share "
              f"{r['score']['idle']:.3f}, flash launches "
              f"{r['score']['launches']['flash_attention']}; serving "
              f"through Model.prefill / decode_step: prefill "
              f"{r['model serve']['prefill_ms']:.2f} ms, decode "
              f"{r['model serve']['decode_ms']:.2f} ms per step")
    return dict(flash=flash, ssd=ssd, gating=gating, launches=launches)


def main():
    start = time.perf_counter()
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
    from repro_torch.kernels.flash_attention import kernel as flash_ker
    from repro_torch.kernels.moe_gating import kernel as gating_ker
    from repro_torch.kernels.nvcc import build_all
    from repro_torch.kernels.ssd_scan import kernel as ssd_ker
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    timings = {}

    t0 = time.perf_counter()
    libraries = (ker.LIBRARY, ssd_ker.LIBRARY, flash_ker.LIBRARY,
                 gating_ker.LIBRARY)
    build_all(libraries)
    timings["build"] = time.perf_counter() - t0
    for lib in libraries:
        info = lib.info
        print(f"build: {lib.name} in {info['seconds']:.2f} s "
              f"({'cached' if info['cached'] else 'nvcc'}); "
              + " | ".join(line.strip() for line in info["log"].splitlines()
                           if "registers" in line or "spill" in line))

    check_ssd_build(ssd_ker.LIBRARY)

    t0 = time.perf_counter()
    stats = check_kernel(dev)
    mc_stats = check_kernel_mc_shapes(dev)
    pod_stats = check_kernel_pod_shapes(dev)
    scenario_stats = check_kernel_scenario_shape(dev)
    resilience_stats = check_kernel_resilience_shape(dev)
    giant_chunk_stats = check_kernel_giant_chunk_shape(dev)
    timings["kernel check"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ssd_stats = check_ssd_kernel(dev)
    timings["ssd_scan check"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    flash_stats = check_flash_kernel(dev)
    timings["flash_attention check"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gating_stats = check_gating_kernel(dev)
    timings["gating_topk check"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    golden(dev)
    golden(dev, policies=(0, 0))
    timings["golden"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    launches = main_path(dev)
    timings["main path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    n_draws = check_threefry(dev)
    timings["threefry check"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mc_golden(dev)
    timings["MC golden"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mc_launches = mc_main_paths(dev)
    timings["MC main paths"] = time.perf_counter() - t0
    print(f"MC: {n_draws} Threefry draws checked; placement_score launches "
          f"{mc_launches}")

    t0 = time.perf_counter()
    pod_golden(dev)
    timings["pod golden"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pod_launches = {"fig17": pod_main_path(dev)}
    timings["pod main path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pod_launches["pod_sweep"] = pod_sweep_pair(dev)
    timings["pod sweep pair"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pod_launches["mc_pod"] = mc_pod_pair(dev)
    timings["mc pod pair"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    check_f5(dev)
    timings["F5 check"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    payoff_golden(dev)
    timings["payoff golden"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    study_launches = {"scenario_sweep": scenario_main_path(dev)}
    timings["scenario_sweep"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    study_launches["fig18"], study_stats = fig18_main_path(dev)
    timings["fig18"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    study_launches["design_frontier"], frontier_stats = \
        frontier_main_path(dev)
    study_stats.update(frontier_stats)
    timings["design frontier"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    table2()
    timings["table2"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fault_cases(dev)
    timings["fault cases"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    resilience_launches = resume_main_path(dev)
    timings["resume"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    resilience_launches["overhead_run"] = overhead_legs(dev)
    timings["overhead legs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    real_oom(dev)
    timings["real OOM"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    resilience_launches["resilient_mc_fig6"] = resilient_mc_path(dev)
    timings["resilient MC"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sharded_launches = {"giant_grid": giant_grid_path(dev)}
    timings["giant_grid"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sharded_launches["split"] = split_main_path(dev)
    timings["split"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    serve_golden(dev)
    timings["serving golden"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ssd_launches = serve_main_path(dev)
    timings["serving main path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    score_golden(dev)
    timings["scoring golden"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    flash_launches = score_main_path(dev)
    timings["scoring main path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    serve_golden(dev, "qwen3-1.7b")
    timings["dense serving golden"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dense_serve_main_path(dev)
    timings["dense serving main path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gap = serve_golden(dev, "granite-moe-1b-a400m", MOE_GOLDEN_LOGIT_ATOL)
    moe_golden_breakdown(dev, gap)
    timings["moe serving golden"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gating_launches = moe_serve_main_path(dev)
    timings["moe serving main path"] = time.perf_counter() - t0

    training_section(dev, timings)
    torch.cuda.empty_cache()
    dp_train_path(timings)
    t0 = time.perf_counter()
    tp_launches = tp_train_path(timings)
    tp_flash = flash_zoo_shape(dev, 8, 4, seed=17)
    tp_kernels = tp_kernel_checks(dev)
    timings["tp kernel shapes"] = time.perf_counter() - t0 - sum(
        v for k, v in timings.items() if k.startswith("tp train"))
    tp_serve = tp_serve_path(timings)
    sp_serve = sp_serve_path(timings)
    zoo = zoo_section(dev, timings)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in timings.items())
          + f"; script {time.perf_counter() - start:.1f}")

    print(json.dumps({"kernels": [
        dict(name="placement_score", route="cuda",
             source="src/repro_torch/csrc/placement_score.cu",
             replaces="src/repro/kernels/placement_score/kernel.py:73",
             launches=launches, library_ms=None, **stats,
             mc_launches=mc_launches, mc_shapes=mc_stats,
             pod_launches=pod_launches, pod_shapes=pod_stats,
             study_launches=study_launches, scenario_shape=scenario_stats,
             study_shapes=study_stats,
             resilience_launches=resilience_launches,
             resilience_chunk_shape=resilience_stats,
             sharded_launches=sharded_launches,
             giant_chunk_shape=giant_chunk_stats),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:52",
             launches=ssd_launches, library_ms=None,
             dispatch="bf16 with hd in {16,32,64,128} and st in "
                      "{16,32,64,128,256} (the serving path): tensor cores; "
                      "float32 and other bf16 shapes: CUDA cores",
             **ssd_stats, zoo_launches=zoo["launches"]["ssd_scan"],
             zoo_shape=zoo["ssd"],
             tp_serve_launches=tp_serve["launches"]["ssd_scan"],
             tp_serve_rank_shape=tp_serve["ssd"],
             sp_serve_launches=sp_serve["launches"]["ssd_scan"],
             sp_serve_rank_shapes=sp_serve["ssd"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:67",
             launches=flash_launches, **flash_stats,
             zoo_launches=zoo["launches"]["flash_attention"],
             zoo_shapes=zoo["flash"], tp_launches=tp_launches,
             tp_rank_shape=tp_flash,
             tp_path_shapes_max_abs_err={
                 k: v for k, v in tp_kernels.items() if "flash" in k},
             sp_smoke_launches=sp_serve["launches"]["flash_attention"]),
        dict(name="gating_topk", route="cuda",
             source="src/repro_torch/csrc/moe_gating.cu",
             replaces="src/repro/kernels/moe_gating/kernel.py:41",
             launches=gating_launches, library_ms=None, **gating_stats,
             zoo_launches=zoo["launches"]["gating_topk"],
             zoo_shapes=zoo["gating"],
             tp_path_shape_max_abs_err=tp_kernels[
                 "gating N 2056 E 32 k 8"],
             tp_serve_launches=tp_serve["launches"]["gating_topk"],
             tp_serve_rank_shapes=tp_serve["gating"],
             sp_serve_launches=sp_serve["launches"]["gating_topk"],
             sp_serve_rank_shapes=sp_serve["gating"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

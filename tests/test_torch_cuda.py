"""Tests of the port that need a CUDA card.

They import neither `jax` nor `repro`, so they run on the machine with
the card, where the parity tests' reference package is not installed
(`--noconftest`: the suite's conftest imports jax):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Without a card they skip.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (arrivals, hierarchy, prng,  # noqa: E402
                              quantiles)
from repro_torch.core.mc_sweep import MCAxes, mc_sweep  # noqa: E402
from repro_torch.core.sweep import SweepAxes, sweep  # noqa: E402
from repro_torch.kernels.placement_score import kernel, ops  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def kernel_inputs(seed, device, N=12, R=3000, X=300):
    """Random feeds (some rows feed-less), loads around the ratings, and
    rows exactly on the `+1e-4` slack."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    nfeeds = rng.integers(0, 5, (N, R)).astype(np.int32)
    feeds = rng.integers(0, X, (N, R, 4)).astype(np.int32)
    feeds = np.where(np.arange(4) < nfeeds[..., None], feeds, -1)
    cap = rng.choice([625.0, 2500.0], (N, X)).astype(f32)
    tot = (cap * rng.uniform(0, 1.1, (N, X))).astype(f32)
    row_cap = np.zeros((N, R, 4), f32)
    row_cap[..., 0] = rng.choice([0.0, 625.0, 2500.0], (N, R))
    row_load = (row_cap * rng.uniform(0, 1.05, (N, R, 4))).astype(f32)
    p = rng.choice([30.0, 180.0, 410.0, 1200.0], N).astype(f32)
    edge = rng.random((N, R)) < 0.2
    row_load[..., 0] = np.where(edge, (row_cap[..., 0] + f32(1e-4)) - p[:, None],
                                row_load[..., 0])
    arrays = dict(row_feeds=feeds.astype(np.int32), row_nfeeds=nfeeds,
                  row_cap=row_cap, row_load=row_load,
                  lineup_ha=(tot * rng.uniform(0, 1, (N, X))).astype(f32),
                  lineup_tot=tot, lineup_cap=cap, p_dep=p,
                  ha_frac=rng.choice([0.75, 0.8, 1.0], N).astype(f32),
                  is_ha=rng.random(N) < 0.6, is_block=rng.random(N) < 0.5)
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


@pytest.mark.parametrize("seed", range(3))
def test_kernel_matches_plain_version(cuda, seed):
    args = kernel_inputs(seed, cuda)
    before = kernel.placement_score.launches
    feas_k, score_k = ops.score_rows(**args)
    feas_p, score_p = ops.score_rows(**args, interpret=True)
    torch.cuda.synchronize()
    assert kernel.placement_score.launches == before + 1
    assert torch.equal(feas_k, feas_p)
    assert torch.equal(score_k, score_p)


def test_sweep_on_the_card_equals_the_cpu(cuda):
    axes = SweepAxes.zip(
        [hierarchy.get_design("10N/8"), hierarchy.get_design("3+1")],
        [arrivals.EnvelopeSpec(demand_scale=0.003, gpu_scenario="high")],
        policies=[1, 3], seeds=[5, 6])
    on_cpu, on_card = sweep(axes, device="cpu"), sweep(axes, device=cuda)
    assert on_card.event_steps == on_cpu.event_steps > 0
    for f in ("halls_active", "deployed_mw", "p90_stranding", "reg_rows",
              "final_lineup_stranding", "effective_dpm"):
        np.testing.assert_array_equal(getattr(on_card, f), getattr(on_cpu, f))


def test_threefry_on_the_card_equals_the_cpu(cuda):
    """Keys and draws at Fig. 7's shapes: 8 trials of 8 configurations,
    900 events, 100 rows."""
    def draws(device):
        keys = prng.split(prng.prng_key(list(range(8)), device), 8)
        keys = keys.reshape(-1, 2)
        ev = prng.fold_in(prng.split(keys)[:, 0][None],
                          torch.arange(900, device=device)[:, None])
        return keys, ev, prng.uniform(ev, 100)

    for a, b in zip(draws("cpu"), draws(cuda)):
        assert torch.equal(a, b.cpu())


def test_mc_sweep_on_the_card_equals_the_cpu(cuda):
    axes = MCAxes.product(designs=[hierarchy.get_design("10N/8"),
                                   hierarchy.get_design("3+1")],
                          policies=range(4), seeds=(7,))
    kw = dict(n_trials=2, n_events=150, year=2030, scenario="high")
    on_cpu, on_card = (mc_sweep(axes, device="cpu", **kw),
                       mc_sweep(axes, device=cuda, **kw))
    before = kernel.placement_score.launches
    again = mc_sweep(axes, device=cuda, **kw)
    assert kernel.placement_score.launches - before == on_card.event_steps
    for f in ("placed_a", "placed_b", "saturated", "lineup_stranding",
              "hall_stranding", "deployed_kw", "delivered_tps"):
        np.testing.assert_array_equal(getattr(on_card, f), getattr(on_cpu, f))
        np.testing.assert_array_equal(getattr(again, f), getattr(on_cpu, f))


@pytest.mark.parametrize("legacy", [False, True])
def test_pod_fleet_on_the_card_equals_the_cpu(cuda, legacy):
    """The pod fleet golden (10N/8 with pods of 3, 8+2 with pods of 5,
    seeds 3 and 4, scale 0.005, each under the four policies), split and
    through the per-event cond: every registry row and count, halls and
    placed fraction bitwise the CPU's, one launch per placement step."""
    combos = [(d, p, s, pol) for pol in range(4)
              for d, p, s in (("10N/8", 3, 3), ("8+2", 5, 4))]
    axes = SweepAxes.zip(
        [hierarchy.get_design(d) for d, *_ in combos],
        [arrivals.EnvelopeSpec(demand_scale=0.005, gpu_scenario="high",
                               pod_racks=p, pod_scale_arch=True)
         for _, p, _, _ in combos],
        policies=[c[3] for c in combos], seeds=[c[2] for c in combos])
    on_cpu = sweep(axes, device="cpu", legacy_pod_cond=legacy)
    before = kernel.placement_score.launches
    on_card = sweep(axes, device=cuda, legacy_pod_cond=legacy)
    assert kernel.placement_score.launches - before == on_card.event_steps
    assert on_card.pod_steps == on_cpu.pod_steps > 0
    for f in ("reg_rows", "reg_counts", "n_halls_built", "halls_active",
              "placed_fraction", "deployed_mw", "p90_stranding",
              "final_hall_stranding"):
        np.testing.assert_array_equal(getattr(on_card, f), getattr(on_cpu, f),
                                      err_msg=f)



@pytest.mark.parametrize("keep,want", [
    ((True, True, True, True), (0.2998046875, 0.6099609136581421)),
    ((True, False, True, True), (0.3994140625, 0.6400390863418579)),
])
def test_hist_quantiles_with_a_nan_on_the_card_equal_the_cpu(cuda, keep,
                                                            want):
    """A NaN value is binned into bucket 0 on the card as on the CPU
    (the float-to-int cast never sees it), masked in or out."""
    x = torch.tensor([0.2, float("nan"), 0.7, 0.4])
    keep = torch.tensor(keep)
    on_cpu = quantiles.hist_masked_quantiles(x, keep, (50.0, 90.0))
    on_card = quantiles.hist_masked_quantiles(x.to(cuda), keep.to(cuda),
                                              (50.0, 90.0))
    for a, b, w in zip(on_card, on_cpu, want):
        assert a.cpu().numpy().tobytes() == b.numpy().tobytes()
        assert b.numpy().tobytes() == np.float32(w).tobytes()

# ---- ssd_scan (Mamba2 SSD intra-chunk kernel) ----

def ssd_inputs(seed, device, B, S, nh, hd, st, dtype):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t = lambda a, dt: torch.as_tensor(a.astype(f32), device=device).to(dt)
    xdt = t(0.5 * rng.standard_normal((B, S, nh, hd)), dtype)
    log_a = t(-0.5 * np.logaddexp(rng.standard_normal((B, S, nh)), 0),
              torch.float32)
    b = t(0.5 * rng.standard_normal((B, S, st)), dtype)
    c = t(0.5 * rng.standard_normal((B, S, st)), dtype)
    return xdt, log_a, b, c


def ssd_within(got, want, majorants, co, which):
    """The bf16 tensor-core kernel's y and h within `split_coefficients`
    × the magnitude sums (derived in chip_smoke.py beside SSD_SUM_U); a
    and the prefix sums bitwise."""
    for g, w, t, c in ((got[0], want[0], majorants[0], co["y_" + which]),
                       (got[1], want[1], majorants[1], co["h_" + which])):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(((g - w).abs() <= c * t).all())
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


@pytest.mark.parametrize("B,S,nh,hd,st,Q,dtype", [
    (2, 64, 8, 16, 16, 8, torch.float32),         # smoke widths
    (2, 64, 8, 16, 16, 32, torch.bfloat16),
    (1, 128, 80, 64, 128, 128, torch.bfloat16),   # one full-width chunk
    (1, 256, 4, 64, 128, 256, torch.bfloat16),    # the default chunk
    (1, 96, 4, 8, 8, 32, torch.float32),
])
def test_ssd_kernel_equals_plain_version(cuda, B, S, nh, hd, st, Q, dtype):
    """float32 (the CUDA-core kernel): every rounding shared, bitwise.
    bf16 (the tensor cores): within the derived bounds of its plain
    version `split_intra_chunk` and of the reference's function."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    args = ssd_inputs(S + nh, cuda, B, S, nh, hd, st, dtype)
    before = ssd_kernel.ssd_intra_chunk.launches
    got = ssd_kernel.ssd_intra_chunk(*args, Q)
    want = ssd_ref.reference_intra_chunk(*args, Q)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_intra_chunk.launches == before + 1
    assert len(got) == 4
    if dtype == torch.float32:
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.float32
            assert torch.equal(g, w)
        return
    assert ssd_kernel.uses_tensor_cores(Q, hd, st, dtype)
    majorants = ssd_ref.intra_chunk_majorants(*args, Q)
    co = ssd_ref.split_coefficients(Q, st)
    ssd_within(got, ssd_ref.split_intra_chunk(*args, Q), majorants, co,
               "split")
    ssd_within(got, want, majorants, co, "ref")


@pytest.mark.parametrize("B,S,nh,hd,st,Q", [
    (1, 200, 6, 64, 128, 100),     # Q off a multiple of 64
    (2, 192, 5, 32, 32, 96),
    (1, 256, 4, 128, 128, 128),
    (1, 128, 6, 64, 256, 64),
    (1, 64, 3, 16, 64, 8),
])
def test_ssd_tensor_core_kernel_at_other_shapes(cuda, B, S, nh, hd, st, Q):
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    args = ssd_inputs(S * hd, cuda, B, S, nh, hd, st, torch.bfloat16)
    got = ssd_kernel.ssd_intra_chunk(*args, Q)
    torch.cuda.synchronize()
    majorants = ssd_ref.intra_chunk_majorants(*args, Q)
    co = ssd_ref.split_coefficients(Q, st)
    ssd_within(got, ssd_ref.split_intra_chunk(*args, Q), majorants, co,
               "split")
    ssd_within(got, ssd_ref.reference_intra_chunk(*args, Q), majorants, co,
               "ref")


def test_ssd_bf16_shapes_off_the_tensor_cores_are_bitwise(cuda):
    """bf16 at a head dim of 8: the CUDA-core kernel, bitwise."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
    args = ssd_inputs(8, cuda, 1, 256, 6, 8, 128, torch.bfloat16)
    assert not ssd_kernel.uses_tensor_cores(128, 8, 128, torch.bfloat16)
    got = ssd_kernel.ssd_intra_chunk(*args, 128)
    want = reference_intra_chunk(*args, 128)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ssd_dispatch_matches_the_source(cuda):
    """The wrapper's `uses_tensor_cores` is the library's rule."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    lib = ssd_kernel.LIBRARY.library()
    for Q in (1, 8, 64, 100, 128, 178, 193, 256):
        for hd in (1, 8, 16, 32, 64, 128, 256):
            for st in (8, 16, 32, 64, 128, 256):
                assert bool(lib.ssd_intra_chunk_uses_tensor_cores(
                    Q, hd, st)) == ssd_kernel.uses_tensor_cores(
                        Q, hd, st, torch.bfloat16), (Q, hd, st)


@pytest.mark.parametrize("S,chunk", [(1024, 128), (1000, 128), (100, 128)])
def test_ssd_scan_bf16_full_scan_within_its_bound(cuda, S, chunk):
    """The bf16 scan through the kernel against interpret=True within
    `split_coefficients`' full-scan bound of the scan on |xdt|, |b|, |c|,
    and the naive recurrence within 1e-4 of its largest value."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    args = ssd_inputs(S, cuda, 1, S, 8, 64, 128, torch.bfloat16)
    y = ssd_ops.ssd_scan(*args, chunk=chunk)
    want = ssd_ops.ssd_scan(*args, chunk=chunk, interpret=True)
    mags = ssd_ops.ssd_scan(args[0].abs(), args[1], args[2].abs(),
                            args[3].abs(), chunk=chunk, interpret=True)
    Q = min(chunk, S)
    co = ssd_ref.split_coefficients(Q, 128, -(-S // Q))
    assert bool(((y - want).abs() <= co["full"] * mags).all())
    naive = ssd_ref.reference_ssd(*args)
    assert float((y - naive).abs().max()) <= 1e-4 * float(naive.abs().max())


@pytest.mark.parametrize("S,chunk", [(8, 128), (100, 32), (1000, 128)])
def test_ssd_scan_short_and_padded_sequences(cuda, S, chunk):
    """S below the chunk (Q = S) and S off a chunk multiple (identity
    padding): the kernel path equals interpret=True bitwise and the
    naive recurrence to 1e-3."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import reference_ssd
    args = ssd_inputs(S, cuda, 1, S, 4, 16, 16, torch.float32)
    y = ssd_ops.ssd_scan(*args, chunk=chunk)
    assert torch.equal(y, ssd_ops.ssd_scan(*args, chunk=chunk,
                                           interpret=True))
    torch.testing.assert_close(y, reference_ssd(*args), rtol=0, atol=1e-3)


def test_ssd_kernel_rejects_an_unsupported_chunk(cuda):
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    args = ssd_inputs(0, cuda, 1, 512, 2, 64, 128, torch.bfloat16)
    before = ssd_kernel.ssd_intra_chunk.launches
    with pytest.raises(ValueError, match="chunk 512"):
        ssd_kernel.ssd_intra_chunk(*args, 512)
    assert ssd_kernel.ssd_intra_chunk.launches == before


def test_engine_on_the_card_launches_the_kernel(cuda):
    import dataclasses
    from repro_torch.configs.mamba2_2p7b import smoke_config
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(smoke_config(), use_flash_kernel=True)
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    engine = ServeEngine(model, params, batch_slots=2, max_seq=48,
                         prompt_len=8)
    rng = np.random.default_rng(0)
    for rid in range(5):
        engine.submit(Request(rid, rng.integers(0, cfg.vocab, size=8),
                              max_new_tokens=8))
    before = ssd_kernel.ssd_intra_chunk.launches
    engine.run_until_drained()
    torch.cuda.synchronize()
    assert engine.stats["prefills"] == 5
    assert ssd_kernel.ssd_intra_chunk.launches - before == 5 * cfg.n_layers
    assert torch.isfinite(engine.caches.h).all()


def test_ssd_kernel_shared_memory_formula(cuda):
    """The wrapper's shared-memory check uses the source's own count."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    lib = ssd_kernel.LIBRARY.library()
    for Q, hd, st, elem in ((128, 64, 128, 2), (128, 64, 128, 4),
                            (256, 64, 128, 2), (8, 16, 16, 4)):
        assert lib.ssd_intra_chunk_smem_bytes(Q, hd, st, elem) == \
            ssd_kernel.smem_bytes(Q, hd, st, elem)


# ---- flash_attention (dense scoring forward) ----

FLASH_RTOL = 1e-5      # float32: of the plain version's largest |value|
BF16_ULP = 2.0 ** -7   # bf16: one ulp of each value, plus the float32 term
P_ROUND = 2.0 ** -8    # bf16: p rounded to bf16, of max |v| (vs reference)


def flash_inputs(seed, device, B, S, H, Hk, hd, dtype):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                                   device=device).to(dtype)
    return t(B, S, H, hd), t(B, S, Hk, hd), t(B, S, Hk, hd)


def within(got, want, extra=0.0):
    """|got − want| ≤ BF16_ULP·|want| + FLASH_RTOL·max |want| + extra."""
    got, want = got.float(), want.float()
    bound = BF16_ULP * want.abs() + FLASH_RTOL * float(want.abs().max()) + \
        extra
    assert bool(((got - want).abs() <= bound).all()), \
        float(((got - want).abs() - bound).max())


def assert_flash_close(got, q, k, v, causal, **blocks):
    """float32: max |got − plain| ≤ 1e-5·max |plain| (the plain version,
    the reference's function, via interpret=True).  bf16: the kernel
    rounds p to bf16, so within one bf16 ulp plus the float32 term plus
    the flip slack of its own plain version (`rounded_flash_bhsd`), and
    within 2⁻⁸·max_head |v| more of the reference's function
    (chip_smoke.py derives both)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import rounded_flash_bhsd
    want = fops.flash_attention(q, k, v, causal=causal, interpret=True,
                                **blocks)
    if q.dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= FLASH_RTOL * float(want.abs().max()), err
        return
    bhsd = lambda x: x.transpose(1, 2).contiguous()
    plain, slack = rounded_flash_bhsd(bhsd(q), bhsd(k), bhsd(v),
                                      causal=causal, kv_len=q.shape[1],
                                      with_slack=True)
    within(bhsd(got), plain, slack)
    v_max = bhsd(v).float().abs().amax(dim=(2, 3)).repeat_interleave(
        q.shape[2] // k.shape[2], dim=1)[..., None, None]
    within(bhsd(got), bhsd(want), P_ROUND * v_max)


@pytest.mark.parametrize("B,S,H,Hk,hd,causal,dtype", [
    (2, 128, 4, 2, 32, True, torch.float32),
    (1, 96, 2, 2, 16, False, torch.float32),
    (2, 64, 4, 1, 64, True, torch.bfloat16),
    (1, 80, 8, 4, 32, True, torch.float32),       # S off the block
    (1, 200, 4, 2, 128, True, torch.bfloat16),    # two 128-key tiles, pad
    (2, 300, 4, 4, 128, False, torch.float32),
    (1, 8, 4, 2, 16, True, torch.float32),        # the smoke prefill's block
    (1, 1000, 16, 8, 128, True, torch.bfloat16),
    (1, 300, 8, 2, 128, True, torch.bfloat16),    # G 4: two blocks a group
    (1, 4097, 4, 2, 128, True, torch.bfloat16),   # S 4097, padded to 4224
    (2, 77, 4, 1, 64, False, torch.bfloat16),     # kv_len 77 < Skv 128
    (1, 96, 6, 2, 32, True, torch.bfloat16),      # G 3: one head a block
    (2, 100, 4, 4, 16, False, torch.bfloat16),    # G 1, hd 16
    (1, 447, 12, 12, 64, True, torch.bfloat16),   # whisper's decoder
    (1, 1024, 12, 2, 128, True, torch.bfloat16),  # qwen2-vl's G 6, Hk 2
])
def test_flash_kernel_matches_plain_version(cuda, B, S, H, Hk, hd, causal,
                                            dtype):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v = flash_inputs(S + hd, cuda, B, S, H, Hk, hd, dtype)
    before = fk.flash_attention_bhsd.launches
    got = fops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, S, H, hd)
    assert bool(torch.isfinite(got).all())
    assert_flash_close(got, q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [8, 16, 32, 64])
def test_flash_kernel_small_blocks(cuda, block, dtype):
    """float32: the online-softmax update per `block` keys, as the plain
    version.  bf16: tiles of 128 keys whatever the block, which only sets
    the padding."""
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v = flash_inputs(block, cuda, 2, 77, 4, 2, 64, dtype)
    for causal in (True, False):
        assert_flash_close(
            fops.flash_attention(q, k, v, causal=causal, block_q=block,
                                 block_k=block),
            q, k, v, causal, block_q=block, block_k=block)


def test_flash_kernel_rejects_an_unsupported_head_dim(cuda):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v = flash_inputs(0, cuda, 1, 64, 2, 1, 96, torch.bfloat16)
    before = fk.flash_attention_bhsd.launches
    with pytest.raises(ValueError, match="head dim 96"):
        fops.flash_attention(q, k, v)
    assert fk.flash_attention_bhsd.launches == before


def test_flash_kernel_raises_under_grad(cuda):
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v = flash_inputs(0, cuda, 1, 64, 2, 1, 64, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        fops.flash_attention(q.requires_grad_(), k, v)


def test_dense_loss_launches_the_kernel_once_per_layer(cuda):
    import dataclasses
    from repro_torch.configs.qwen3_1p7b import smoke_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(smoke_config(), use_flash_kernel=True)
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        torch.float32)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)),
        device=cuda)
    with torch.no_grad():
        before = fk.flash_attention_bhsd.launches
        loss, metrics = model.loss(params, {"tokens": tokens})
        assert fk.flash_attention_bhsd.launches - before == cfg.n_layers
        plain, _ = build_model(cfg, cuda, interpret=True).loss(
            params, {"tokens": tokens})
    assert float(metrics["tokens"]) == 2 * 39
    assert abs(float(loss) - float(plain)) <= 1e-5 * abs(float(plain))


# ---- moe_gating (the MoE router) ----

def gating_logits(seed, device, N, E, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((scale * rng.standard_normal((N, E)))
                           .astype(np.float32), device=device)


@pytest.mark.parametrize("N,E,k", [(128, 16, 2), (100, 64, 6), (256, 32, 8),
                                   (64, 8, 1), (1024, 32, 8), (4, 32, 8),
                                   (16384, 32, 8), (77, 256, 8),
                                   (300, 127, 3)])
def test_gating_kernel_equals_plain_version(cuda, N, E, k):
    """Same float32 operations in the same order: gates and ids bitwise."""
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.kernels.moe_gating import ops as gops
    from repro_torch.kernels.moe_gating.ref import reference_gating
    x = gating_logits(N + E, cuda, N, E, scale=2.0)
    before = gk.gating_topk.launches
    gate, idx = gops.fused_gating(x, k)
    want_gate, want_idx = reference_gating(x, k)
    torch.cuda.synchronize()
    assert gk.gating_topk.launches == before + 1
    assert gate.shape == (N, k) and idx.dtype == torch.int32
    assert torch.equal(idx, want_idx)
    assert torch.equal(gate, want_gate)


@pytest.mark.parametrize("N,E,k", [(4, 32, 8), (1024, 32, 8), (100, 64, 6),
                                   (77, 256, 8), (300, 127, 3), (64, 8, 1)])
def test_gating_kernel_on_non_finite_rows_equals_plain_version(cuda, N, E, k):
    """Rows with a NaN logit, a +inf logit and only −inf logits among
    ordinary ones: ids 0..k−1 and NaN gates, as the plain version gives
    them (NaN ranks above every number, the first NaN first); every gate
    and id bitwise the plain version's, NaNs included."""
    from repro_torch.kernels.moe_gating import ops as gops
    from repro_torch.kernels.moe_gating.ref import reference_gating
    x = gating_logits(N * E, cuda, N, E, scale=2.0)
    x[0::4, E // 2] = float("nan")
    x[1::4, E - 1] = float("inf")
    x[2::4] = float("-inf")
    bad = torch.arange(N, device=cuda) % 4 < 3
    gate, idx = gops.fused_gating(x, k)
    want_gate, want_idx = reference_gating(x, k)
    torch.cuda.synchronize()
    ids = torch.arange(k, dtype=torch.int32, device=cuda)
    assert torch.equal(idx[bad], ids.expand(int(bad.sum()), k))
    assert torch.isnan(gate[bad]).all() and torch.isfinite(gate[~bad]).all()
    assert torch.equal(idx, want_idx)
    assert torch.equal(gate.view(torch.int32), want_gate.view(torch.int32))


def test_gating_kernel_ties_go_to_the_lowest_index(cuda):
    from repro_torch.kernels.moe_gating import ops as gops
    x = torch.zeros(3, 32, device=cuda)
    x[1] = 1.5
    x[2, [20, 4, 11]] = 2.0
    gate, idx = gops.fused_gating(x, 8)
    assert idx[0].tolist() == idx[1].tolist() == list(range(8))
    assert idx[2].tolist() == [4, 11, 20, 0, 1, 2, 3, 5]
    assert torch.allclose(gate[0], torch.full((8,), 0.125, device=cuda))


def test_gating_kernel_refuses_what_it_does_not_take(cuda):
    """Refusals raise, and interpret=True takes the plain version; none
    of them launches the kernel."""
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.kernels.moe_gating import ops as gops
    from repro_torch.kernels.moe_gating.ref import reference_gating
    x = gating_logits(0, cuda, 64, 32)
    before = gk.gating_topk.launches
    with pytest.raises(ValueError, match="not contiguous"):
        gops.fused_gating(x.t(), 8)
    with pytest.raises(ValueError, match="top_k 9"):
        gops.fused_gating(x, 9)
    with pytest.raises(TypeError, match="float64"):
        gops.fused_gating(x.double(), 8)
    gate, idx = gops.fused_gating(x, 8, interpret=True)   # the plain version
    want_gate, want_idx = reference_gating(x, 8)
    assert torch.equal(gate, want_gate) and torch.equal(idx, want_idx)
    with pytest.raises(RuntimeError, match="no backward"):
        gops.fused_gating(x.requires_grad_(), 8)
    assert gk.gating_topk.launches == before


def test_moe_engine_launches_the_gating_kernel_per_layer_and_step(cuda):
    """Every prefill and decode step launches the kernel once per layer,
    and the tokens equal the plain router's on the card."""
    import dataclasses
    from repro_torch.configs.granite_moe_1b_a400m import smoke_config
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    outputs = []
    for flag in (True, False):
        cfg = dataclasses.replace(smoke_config(), use_flash_kernel=flag)
        model = build_model(cfg, cuda)
        params = model.init(torch.Generator(device=cuda).manual_seed(0),
                            torch.float32)
        engine = ServeEngine(model, params, batch_slots=2, max_seq=48,
                             prompt_len=8)
        rng = np.random.default_rng(0)
        reqs = [Request(rid, rng.integers(0, cfg.vocab, size=8),
                        max_new_tokens=8) for rid in range(5)]
        for r in reqs:
            engine.submit(r)
        before = gk.gating_topk.launches
        engine.run_until_drained()
        torch.cuda.synchronize()
        steps = engine.stats["prefills"] + engine.stats["decode_steps"]
        assert gk.gating_topk.launches - before == \
            (cfg.n_layers * steps if flag else 0)
        outputs.append([r.output for r in reqs])
    assert outputs[0] == outputs[1]


RESILIENT_FIELDS = ("halls_active", "deployed_mw", "p50_stranding",
                    "p90_stranding", "final_hall_stranding",
                    "final_lineup_stranding", "n_halls_built",
                    "final_deployed_mw", "placed_fraction", "act_month",
                    "reg_rows", "reg_counts", "total_capex",
                    "dollars_per_tps")


def test_resilient_sweep_resumes_bitwise_on_the_card(cuda, tmp_path):
    """Chunks of 3 with a kill after chunk 1, then the resume: every field
    bitwise the card's one-shot `sweep`, one launch per placement step of
    the chunk the resume computes."""
    from repro_torch.core.resilience import (FaultPlan, InjectedCrash,
                                             resilient_sweep)
    envs = [arrivals.EnvelopeSpec(demand_scale=0.004, gpu_scenario=sc,
                                  end_year=2028) for sc in ("med", "high")]
    axes = SweepAxes.product(designs=[hierarchy.get_design("4N/3"),
                                      hierarchy.get_design("3+1")],
                             envs=envs, seeds=(0, 1))
    one_shot = sweep(axes, device=cuda)
    with pytest.raises(InjectedCrash):
        resilient_sweep(axes, chunk_size=3, checkpoint_dir=str(tmp_path),
                        fault_plan=FaultPlan(crash_after=1), device=cuda)
    before = kernel.placement_score.launches
    res = resilient_sweep(axes, chunk_size=3, checkpoint_dir=str(tmp_path),
                          device=cuda)
    assert kernel.placement_score.launches - before == res.event_steps > 0
    assert (res.report.chunks_resumed, res.report.chunks_computed) == (2, 1)
    for f in RESILIENT_FIELDS:
        a, b = np.asarray(getattr(res, f)), np.asarray(getattr(one_shot, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_resilient_mc_sweep_chunks_bitwise_on_the_card(cuda):
    from repro_torch.core.resilience import resilient_mc_sweep
    axes = MCAxes.zip(designs=[hierarchy.get_design(n)
                               for n in ("4N/3", "3+1", "10N/8")],
                      seeds=[11, 12, 13])
    kw = dict(n_trials=2, n_events=80, year=2030, scenario="high",
              device=cuda)
    one_shot = mc_sweep(axes, **kw)
    res = resilient_mc_sweep(axes, chunk_size=2, **kw)
    assert res.report.n_chunks == 2 and not res.report.quarantined
    for f in ("lineup_stranding", "hall_stranding", "deployed_kw",
              "saturated", "placed_a", "placed_b", "rows_a", "counts_a",
              "rows_b", "counts_b"):
        a, b = getattr(res, f), getattr(one_shot, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_sharded_sweep_on_two_slabs_of_one_card_equals_the_cpu(cuda):
    """`sharded_sweep` over ``["cuda:0"] * 2`` (chunks of 3) against the
    CPU's one-shot `sweep`: every field bitwise, one launch per placement
    step of every slab; `sharded_mc_sweep` on a 1 × 2 mesh against the
    CPU's `mc_sweep`."""
    from repro_torch.core.mc_sweep import sharded_mc_sweep
    from repro_torch.core.sweep import sharded_sweep
    envs = [arrivals.EnvelopeSpec(demand_scale=0.004, gpu_scenario=sc,
                                  end_year=2028) for sc in ("med", "high")]
    axes = SweepAxes.product(designs=[hierarchy.get_design("4N/3"),
                                      hierarchy.get_design("3+1")],
                             envs=envs, policies=(3, 2), seeds=(0, 1))
    on_cpu = sweep(axes, device="cpu")
    before = kernel.placement_score.launches
    res = sharded_sweep(axes, devices=["cuda:0"] * 2, chunk_size=3)
    assert kernel.placement_score.launches - before == res.event_steps > 0
    for f in RESILIENT_FIELDS:
        a, b = np.asarray(getattr(res, f)), np.asarray(getattr(on_cpu, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    mc_axes = MCAxes.zip(designs=[hierarchy.get_design(n)
                                  for n in ("4N/3", "3+1", "10N/8")],
                         seeds=[11, 12, 13])
    kw = dict(n_trials=3, n_events=80, year=2030, scenario="high")
    mc_cpu = mc_sweep(mc_axes, device="cpu", **kw)
    mc_card = sharded_mc_sweep(mc_axes, devices=["cuda:0"] * 2,
                               mesh_shape=(1, 2), **kw)
    for f in ("lineup_stranding", "hall_stranding", "deployed_kw",
              "saturated", "placed_a", "placed_b", "rows_a", "counts_a",
              "rows_b", "counts_b"):
        a, b = getattr(mc_card, f), getattr(mc_cpu, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_kernel_at_the_giant_grid_chunk_shape(cuda):
    """The kernel at `giant_grid`'s chunk: 512 configurations of its
    geometry (4N/3 and 3+1 alternating, MED/HIGH traces at scale 0.01 to
    2028), 512 × 720 rows, bitwise its plain version."""
    from repro_torch.core.placement import Topology
    from repro_torch.core.sweep import _prepare
    pool = [arrivals.EnvelopeSpec(demand_scale=0.01, gpu_scenario=sc,
                                  end_year=2028) for sc in ("med", "high")]
    traces = [arrivals.generate_fleet_trace(e, s) for e in pool
              for s in (41, 42, 43, 44)]
    n = 512
    axes = SweepAxes.zip(
        designs=[hierarchy.get_design(("4N/3", "3+1")[i % 2])
                 for i in range(n)],
        envs=[pool[(i % 8) // 4] for i in range(n)],
        seeds=[41 + i % 4 for i in range(n)])
    jt = _prepare(axes, 0, [traces[i % 8] for i in range(n)], cuda).jt
    assert tuple(jt.row_cap.shape[:2]) == (512, 720)
    rng = np.random.default_rng(5)
    N, R = 512, 720
    X = jt.lineup_cap.shape[1]
    row_load = jt.row_cap * torch.as_tensor(
        rng.uniform(0, 1.05, (N, R, 4)), dtype=torch.float32, device=cuda)
    tot = jt.lineup_cap * torch.as_tensor(rng.uniform(0, 1.05, (N, X)),
                                          dtype=torch.float32, device=cuda)
    args = dict(row_feeds=jt.row_feeds, row_nfeeds=jt.row_nfeeds,
                row_cap=jt.row_cap, row_load=row_load.contiguous(),
                lineup_ha=(tot * 0.5).contiguous(),
                lineup_tot=tot.contiguous(), lineup_cap=jt.lineup_cap,
                p_dep=torch.full((N,), 420.0, device=cuda),
                ha_frac=jt.ha_frac,
                is_ha=torch.as_tensor(rng.random(N) < 0.7, device=cuda),
                is_block=jt.is_block)
    feas_k, score_k = ops.score_rows(**args)
    feas_p, score_p = ops.score_rows(**args, interpret=True)
    assert feas_k.any() and torch.equal(feas_k, feas_p)
    assert torch.equal(score_k, score_p)


def test_restore_without_a_device_lands_on_the_card(cuda, tmp_path):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    ckpt = Checkpointer(str(tmp_path))
    state = {"a": torch.arange(4.0), "b": np.arange(3, dtype=np.int32)}
    ckpt.save(1, state, blocking=True)
    out, _ = ckpt.restore(state)
    assert out["a"].device.type == out["b"].device.type == "cuda"
    assert out["a"].cpu().tolist() == [0.0, 1.0, 2.0, 3.0]
    out, _ = ckpt.restore(state, shardings={"a": "cuda:0", "b": "cpu"})
    assert (out["a"].device.type, out["b"].device.type) == ("cuda", "cpu")


# ---- training (no kernel: the reference trains with its kernels off) ----

def train_three_steps(arch, device, start):
    """Three train steps of `arch`'s smoke model in float32 from `start`
    (CPU tensors, copied): accum 1, accum 2, then the error-feedback
    compressor; each step's (params, opt_state, metrics) on the CPU."""
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import ef_compress_grads, ef_init
    from repro_torch.train.step import make_train_step

    def moved(tree, dev):
        leaves, treedef = tree_flatten(tree)
        return treedef.unflatten([t.to(dev, copy=True) for t in leaves])

    model = build_model(get_smoke_config(arch), device)
    params = moved(start, device)
    opt = adamw.init(params)
    box = {"r": ef_init(params)}

    def compressor(grads, opt_state):
        grads, box["r"] = ef_compress_grads(grads, box["r"])
        return grads, opt_state
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2)
    pipe = TokenPipeline(PipelineConfig(4, 32, model.cfg.vocab))
    out = []
    for step, fn in enumerate((make_train_step(model, cfg),
                               make_train_step(model, cfg, 2),
                               make_train_step(model, cfg,
                                               compressor=compressor))):
        batch = {"tokens": torch.as_tensor(pipe._batch_at(step),
                                           device=device)}
        params, opt, met = fn(params, opt, batch)
        out.append(moved((params, opt, met), "cpu"))
    return out


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b"])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Float32 (TF32 off), the same start on both devices.  Tolerances as
    `tests/test_torch_train.py` holds the port to `repro`: loss rtol
    1e-5, lr 1e-6, grad_norm 1e-4 (1e-3 through the int8 compressor);
    moments within 1e-3 (2e-2) of each leaf's largest element; parameters
    within 0.5·Σlr, all but 0.1% within 1e-2·Σlr.  No kernel launches."""
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models.api import build_model
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        start = build_model(get_smoke_config(arch), "cpu").init(
            torch.Generator().manual_seed(0), torch.float32)
        counters = (fk.flash_attention_bhsd, gk.gating_topk,
                    sk.ssd_intra_chunk)
        before = [c.launches for c in counters]
        card = train_three_steps(arch, cuda, start)
        assert [c.launches for c in counters] == before
        host = train_three_steps(arch, "cpu", start)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lr_sum = 0.0
    for step, ((p_c, o_c, m_c), (p_h, o_h, m_h)) in enumerate(zip(card,
                                                                  host)):
        lr_sum += float(m_h["lr"])
        assert float(m_c["loss"]) == pytest.approx(float(m_h["loss"]),
                                                   rel=1e-5)
        assert float(m_c["lr"]) == pytest.approx(float(m_h["lr"]), rel=1e-6)
        assert float(m_c["grad_norm"]) == pytest.approx(
            float(m_h["grad_norm"]), rel=1e-3 if step == 2 else 1e-4)
        tol = 2e-2 if step == 2 else 1e-3
        for a, b in zip(tree_flatten((o_c.mu, o_c.nu))[0],
                        tree_flatten((o_h.mu, o_h.nu))[0]):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())
        gap = torch.cat([(a - b).abs().flatten() for a, b in zip(
            tree_flatten(p_c)[0], tree_flatten(p_h)[0])]) / lr_sum
        assert float(gap.max()) <= 0.5
        assert float((gap > 1e-2).float().mean()) <= 1e-3


# ---- training over several ranks: two gloo ranks sharing the card ----

def test_two_gloo_ranks_on_the_card_match_the_cpu_ranks(cuda):
    """`compressed_psum` over two gloo ranks on card 0, bitwise the same
    call on two CPU ranks; qwen3's smoke model through three data-parallel
    steps (accum 1, accum 2, the EF compressor; ZeRO-1 moments) on the
    same ranks: the card's ranks end with bitwise equal parameters, and
    the card against the CPU ranks keeps
    `test_train_steps_on_the_card_match_the_cpu`'s tolerances."""
    import torch_dp_workers as W
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.models.params import leaves, unflatten
    from repro_torch.sharding.ranks import spawn_ranks
    model = build_model(get_smoke_config("qwen3-1.7b"), "cpu")
    flat = tree_flatten(model.init(torch.Generator().manual_seed(0),
                                   torch.float32))[0]
    start = unflatten((path, t.numpy()) for (path, _), t in
                      zip(leaves(model.spec), flat))
    card = spawn_ranks(W.card_rank, 2, "gloo", "cuda:0", (start,))
    host = spawn_ranks(W.card_rank, 2, "gloo", "cpu", (start,))
    for c, h in zip(card, host):
        assert c["psum"].numpy().tobytes() == h["psum"].numpy().tobytes()
    lr_sum = 0.0
    for step in range(3):
        a, b = card[0]["dp"][step], card[1]["dp"][step]
        assert all(torch.equal(x, y) for x, y in zip(a["params"],
                                                     b["params"]))
        h = host[0]["dp"][step]
        lr_sum += h["metrics"]["lr"]
        assert a["metrics"]["loss"] == pytest.approx(h["metrics"]["loss"],
                                                     rel=1e-5)
        assert a["metrics"]["grad_norm"] == pytest.approx(
            h["metrics"]["grad_norm"], rel=1e-3 if step == 2 else 1e-4)
        tol = 2e-2 if step == 2 else 1e-3
        for which in ("mu", "nu"):           # each leaf: both ranks' blocks
            for i in range(len(h[which])):
                blocks = [(card[r]["dp"][step][which][i],
                           host[r]["dp"][step][which][i]) for r in (0, 1)]
                largest = max(float(y.abs().max()) for _, (y, _, _) in blocks)
                for (x, _, bx), (y, _, by) in blocks:
                    assert bx == by
                    assert float((x - y).abs().max()) <= tol * max(largest,
                                                                   1e-30)
        gap = torch.cat([(x - y).abs().flatten() for x, y in
                         zip(a["params"], h["params"])]) / lr_sum
        assert float(gap.max()) <= 0.5
        assert float((gap > 1e-2).float().mean()) <= 1e-3


# ---- tensor parallelism: two gloo ranks sharing the card ----

@pytest.fixture(scope="module")
def tp_card_runs():
    """`torch_tp_workers.card_rank` on two gloo ranks of card 0, from
    qwen3's smoke float32 init."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch_tp_workers as TW
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.models.api import build_model
    from repro_torch.models.params import leaves, unflatten
    from repro_torch.sharding.ranks import spawn_ranks
    model = build_model(TW.smoke("qwen3-1.7b"), "cpu")
    flat = tree_flatten(model.init(torch.Generator().manual_seed(0),
                                   torch.float32))[0]
    start = unflatten((path, t.numpy()) for (path, _), t in
                      zip(leaves(model.spec), flat))
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 40))
    return spawn_ranks(TW.card_rank, 2, "gloo", "cuda:0", (start, tokens))


def test_tp_collectives_on_the_card_equal_the_cpu(tp_card_runs):
    """Each differentiable collective (all-gather, reduce-scatter,
    all-reduce, its conjugate) over two gloo ranks on card tensors: its
    output and its input's gradient bitwise the same call's on CPU
    tensors in the same ranks."""
    for res in tp_card_runs:
        for name, (y, g) in res["card"].items():
            cy, cg = res["cpu"][name]
            assert torch.equal(y, cy) and torch.equal(g, cg), name


def test_tp_scoring_with_flash_matches_the_plain_attention(tp_card_runs):
    """qwen3's smoke scoring loss under `base_rules(False)` on (1, 1, 2),
    float32: with the flash op each rank launches the kernel once per
    layer on its two q heads and one K/V head, and the loss is within
    1e-5 of the same call with the plain attention (no launch); both
    ranks give the same loss."""
    from repro_torch.configs.qwen3_1p7b import smoke_config
    layers = smoke_config().n_layers
    for res in tp_card_runs:
        (plain, n_plain), (flash, n_flash) = (res["losses"][False],
                                              res["losses"][True])
        assert n_plain == 0 and n_flash == layers
        assert abs(flash - plain) <= 1e-5 * abs(plain)
    assert tp_card_runs[0]["losses"] == tp_card_runs[1]["losses"]


# ---- serving over a model mesh: two gloo ranks sharing the card ----

def test_ssd_kernel_at_a_ranks_head_block(cuda):
    """bf16 at a rank's block of Mamba2's SSM heads under `base_rules` on
    two ranks: 40 of 80 heads x 64, state 128, chunk 128, the prefill's
    [4, 1024], on the tensor cores, within the derived bounds of its
    plain version and of the reference's function."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    args = ssd_inputs(40, cuda, 4, 1024, 40, 64, 128, torch.bfloat16)
    assert ssd_kernel.uses_tensor_cores(128, 64, 128, torch.bfloat16)
    before = ssd_kernel.ssd_intra_chunk.launches
    got = ssd_kernel.ssd_intra_chunk(*args, 128)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_intra_chunk.launches == before + 1
    majorants = ssd_ref.intra_chunk_majorants(*args, 128)
    co = ssd_ref.split_coefficients(128, 128, 8)
    ssd_within(got, ssd_ref.split_intra_chunk(*args, 128), majorants, co,
               "split")
    ssd_within(got, ssd_ref.reference_intra_chunk(*args, 128), majorants,
               co, "ref")


@pytest.fixture(scope="module")
def tp_serve_card_runs():
    """`torch_tp_serve_workers.card_rank` on two gloo ranks of card 0,
    from qwen3's and granite-moe's smoke float32 inits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch_tp_serve_workers as SW
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.models.api import build_model
    from repro_torch.models.params import leaves, unflatten
    from repro_torch.sharding.ranks import spawn_ranks
    start = {}
    for arch in ("qwen3-1.7b", "granite-moe-1b-a400m"):
        model = build_model(SW.smoke(arch), "cpu")
        flat = tree_flatten(model.init(torch.Generator().manual_seed(0),
                                       torch.float32))[0]
        start[arch] = unflatten((path, t.numpy()) for (path, _), t in
                                zip(leaves(model.spec), flat))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (SW.ROWS, SW.PROMPT))
    steps = [rng.integers(0, 512, (SW.ROWS, 1)) for _ in range(SW.STEPS)]
    return spawn_ranks(SW.card_rank, 2, "gloo", "cuda:0",
                       (start, tokens, steps))


def test_tp_serve_decode_32k_merge_matches_one_device(tp_serve_card_runs):
    """qwen3's smoke decode under `decode_32k`'s layout on two gloo ranks
    of the card (the KV sequence over "model", 8 positions a rank; the
    third step writes rank 1's first row), float32: the partial softmax
    merged over the ranks gives the one-device decode's logits within
    rtol = atol = 1e-5 plus 1e-5 of the largest |logit|, each step from
    the same caches; both ranks return the same bits."""
    runs = [r["decode_32k"] for r in tp_serve_card_runs]
    for res in runs:
        for got, want in zip(res["ranks"], res["one"]):
            atol = 1e-5 + 1e-5 * float(want.abs().max())
            assert torch.allclose(got, want, rtol=1e-5, atol=atol)
    assert all(torch.equal(a, b) for a, b in zip(runs[0]["ranks"],
                                                 runs[1]["ranks"]))


def test_tp_serve_gating_kernel_on_gathered_logits(tp_serve_card_runs):
    """granite-moe's smoke prefill and decode under `base_rules` on two
    gloo ranks of the card (2 of 4 experts a rank): each rank launches the
    gating kernel once per layer per call, on the router logits gathered
    over the ranks (all E columns); on the logits of an expert-parallel
    decode step the kernel's gates and ids are bitwise its plain
    version's."""
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.kernels.moe_gating.ref import reference_gating
    for res in tp_serve_card_runs:
        g = res["gating"]
        assert g["launches"] == [g["layers"]] * len(g["launches"])
        for x, k in g["logits"]:
            assert x.shape[-1] == g["experts"]
        x, k = g["logits"][-1]          # the last decode step's, [B, E]
        x = x.to("cuda")
        before = gk.gating_topk.launches
        gate, idx = gk.gating_topk(x, k)
        want_gate, want_idx = reference_gating(x, k)
        assert gk.gating_topk.launches == before + 1
        assert torch.equal(idx, want_idx)
        assert torch.equal(gate.view(torch.int32),
                           want_gate.view(torch.int32))


# ---- the model zoo: qwen3-14b, phi4-mini, nemotron, moonshot, Jamba ----

ZOO_ARCHS = ("qwen3-14b", "phi4-mini-3.8b", "nemotron-4-15b",
             "moonshot-v1-16b-a3b", "jamba-1.5-large-398b")


@pytest.mark.parametrize("H,Hk", [(40, 8), (24, 8), (48, 8), (16, 16),
                                  (64, 8)])
def test_flash_kernel_at_the_zoo_groups(cuda, H, Hk):
    """bf16 causal at hd 128 and the zoo's GQA groups (G 5, 3, 6, 1, 8:
    odd groups one head a block, even ones two), S 640 (five 128-key
    tiles): within the bounds of `assert_flash_close`."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v = flash_inputs(H * Hk, cuda, 2, 640, H, Hk, 128, torch.bfloat16)
    before = fk.flash_attention_bhsd.launches
    got = fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == before + 1
    assert got.shape == (2, 640, H, 128) and bool(torch.isfinite(got).all())
    assert_flash_close(got, q, k, v, True)


def test_ssd_kernel_at_jambas_mixer(cuda):
    """bf16 at Jamba's mixer: 256 heads x 64, state 16 (the wgmma N tile),
    chunk 128, S 1024, on the tensor cores, within the derived bounds of
    its plain version and of the reference's function."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    args = ssd_inputs(16, cuda, 1, 1024, 256, 64, 16, torch.bfloat16)
    assert ssd_kernel.uses_tensor_cores(128, 64, 16, torch.bfloat16)
    before = ssd_kernel.ssd_intra_chunk.launches
    got = ssd_kernel.ssd_intra_chunk(*args, 128)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_intra_chunk.launches == before + 1
    majorants = ssd_ref.intra_chunk_majorants(*args, 128)
    co = ssd_ref.split_coefficients(128, 16, 8)
    ssd_within(got, ssd_ref.split_intra_chunk(*args, 128), majorants, co,
               "split")
    ssd_within(got, ssd_ref.reference_intra_chunk(*args, 128), majorants,
               co, "ref")


def zoo_serve(model, params, n=5, prompt=8, new=8):
    from repro_torch.serve.engine import Request, ServeEngine
    engine = ServeEngine(model, params, batch_slots=2, max_seq=48,
                         prompt_len=prompt)
    rng = np.random.default_rng(0)
    reqs = [Request(rid, rng.integers(0, model.cfg.vocab, size=prompt),
                    max_new_tokens=new) for rid in range(n)]
    logits = []
    real = model.prefill

    def prefill(p, batch, max_seq):
        out = real(p, batch, max_seq)
        logits.append(out[0].float().cpu())
        return out
    model.prefill = prefill
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    return [r.output for r in reqs], dict(engine.stats), torch.cat(logits)


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_zoo_smoke_golden_on_the_card_equals_the_cpu(cuda, arch):
    """The smoke config in float32 (TF32 off), flag on, the same weights:
    tests/test_launchers.py's serving traffic gives the same tokens and
    stats on the card (the kernels) as on the CPU (their plain versions),
    prefill logits within 1e-4 (1e-3 for Jamba, whose smoke attention
    amplifies a float32 reordering ~100×: tests/test_torch_zoo.py); the
    loss within rtol 1e-5, each kernel launched once per layer of its
    kind."""
    import dataclasses
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import lm
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), use_flash_kernel=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_cpu = build_model(cfg, "cpu")
        params = on_cpu.init(torch.Generator().manual_seed(0), torch.float32)
        card_params = _to(params, cuda)
        host = zoo_serve(on_cpu, params)
        card = zoo_serve(build_model(cfg, cuda), card_params)
        tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
        counters = (fk.flash_attention_bhsd, sk.ssd_intra_chunk,
                    gk.gating_topk)
        with torch.no_grad():
            a = float(on_cpu.loss(params, {"tokens": torch.as_tensor(
                tokens)})[0])
            before = [c.launches for c in counters]
            b = float(build_model(cfg, cuda).loss(card_params, {
                "tokens": torch.as_tensor(tokens, device=cuda)})[0])
            launched = [c.launches - n for c, n in zip(counters, before)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert card[:2] == host[:2]
    atol = 1e-3 if cfg.family == "hybrid" else 1e-4
    assert float((card[2] - host[2]).abs().max()) <= atol
    assert abs(a - b) <= 1e-5 * abs(a)
    kinds = lm._layer_kinds(cfg) * (cfg.n_layers // len(lm._layer_kinds(cfg)))
    assert launched == [sum(m == "attn" for m, _ in kinds),
                        sum(m == "mamba" for m, _ in kinds),
                        sum(f == "moe" for _, f in kinds)]


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def greedy(model, params, batch, steps=8):
    """Model.prefill, then `steps` greedy decode steps: (tokens, logits)
    on the CPU."""
    logits, caches = model.prefill(params, batch, 64)
    pos = batch["tokens"].shape[1] + (batch["vision_embeds"].shape[1]
                                      if "vision_embeds" in batch else 0)
    out = [logits]
    for i in range(steps):
        tok = torch.argmax(out[-1], -1)[:, None]
        logits, caches = model.decode_step(params, tok, pos + i, caches)
        out.append(logits)
    logits = torch.stack(out, 1).float().cpu()
    return torch.argmax(logits, -1), logits


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-small"])
def test_vlm_and_encdec_smoke_goldens_on_the_card_equal_the_cpu(cuda, arch):
    """The smoke config in float32 (TF32 off), flag on, the same weights
    and inputs: the loss on the family's batch (qwen2-vl's 8-row vision
    prefix before 32 tokens; whisper's 40 frames and 32 decoder tokens)
    within rtol 1e-5, one flash launch per (decoder) layer; prefill with
    the prefix or the frames and 8 greedy decode steps give the same
    tokens, logits within 1e-4 (1e-3 for whisper, whose smoke encoder's
    scores reach O(70): tests/test_torch_encdec.py); the VLM's text
    prompts through the engine, the same tokens and stats."""
    import dataclasses
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), use_flash_kernel=True)
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(3)
    embeds = torch.randn((2, 40 if cfg.family == "audio" else 8, 64),
                         generator=gen)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32))),
             "frames" if cfg.family == "audio" else "vision_embeds": embeds}
    prompt = dict(batch, tokens=batch["tokens"][:, :4])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_cpu = build_model(cfg, "cpu")
        on_card = build_model(cfg, cuda)
        params = on_cpu.init(torch.Generator().manual_seed(0), torch.float32)
        card_params = _to(params, cuda)
        with torch.no_grad():
            a = float(on_cpu.loss(params, batch)[0])
            before = fk.flash_attention_bhsd.launches
            b = float(on_card.loss(card_params, _to(batch, cuda))[0])
            launched = fk.flash_attention_bhsd.launches - before
            host = greedy(on_cpu, params, prompt)
            card = greedy(on_card, card_params, _to(prompt, cuda))
        if cfg.family == "vlm":
            served = (zoo_serve(on_cpu, params),
                      zoo_serve(build_model(cfg, cuda), card_params))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(a - b) <= 1e-5 * abs(a)
    assert launched == cfg.n_layers
    assert torch.equal(card[0], host[0])
    atol = 1e-3 if cfg.family == "audio" else 1e-4
    assert float((card[1] - host[1]).abs().max()) <= atol
    if cfg.family == "vlm":
        assert served[1][:2] == served[0][:2]
        assert float((served[1][2] - served[0][2]).abs().max()) <= atol

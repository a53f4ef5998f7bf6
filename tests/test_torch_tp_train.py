"""Tensor, expert and FSDP parallelism in the port's loss and train step,
on gloo ranks of the CPU (`sharding.ranks.spawn_ranks`, one process per
rank, float32 at smoke sizes), held against `repro`'s single-device
jitted step on the global batch.

Two spawns, each running its layouts in turn (`tests/torch_tp_workers.py`
`LAYOUTS`), while `repro`'s references compile:

* W = 2: `base_rules(False)` on (1, 1, 2) (qwen3 and granite-moe, a
  step with accum 1 and one with accum 2, each from the start: a second
  update would compare the first's rounding, which Adam makes O(lr) for
  elements whose gradient is near 0, in one device's step as much as
  a layout's); granite-moe with vocab 511 on the same mesh,
  whose vocabulary does not divide and falls back to replicated; the
  (1, 1, 2) qwen3 tree resharded onto a survivors mesh of rank 0; the
  differentiable collectives.
* W = 4: `base_rules(False)` on (1, 2, 2) with ZeRO-1 moments, the same
  under `fsdp_rules`, `fsdp_rules(pure_dp_rules(False))` (the
  reference's optimized variants: the batch over data × model, the
  weights' `embed` over data) for qwen3, and qwen3 on (1, 1, 4), where
  its 2 K/V heads fall back to replicated and each rank has one q head.

qwen3 runs remat "full" in the port, so its ranks' collectives are
recomputed in the backward; `repro`'s smoke config runs none (the same
function).  The start: each config's parameters from the port's float32
init, the same numbers in both packages.

Tolerances, `tests/test_torch_dp_train.py`'s: a step against `repro`'s
on the global batch: loss within rtol 1e-5, `lr` 1e-6, `grad_norm`
1e-4; moments within `MOMENT_TOL` of each leaf's largest element;
parameters within 0.5·Σlr, all but 0.1% within 1e-2·Σlr (`PARAM_TOL`).
Every rank that holds a block of a leaf holds the same bits.  FSDP against
the same layout without its gather: the loss bitwise, `grad_norm`
within rtol 1e-6, the moments within 1e-6 of each leaf's largest
element, and with accum 1 the parameters too.  The reduction orders
differ in two places.  `adamw.global_norm` sums an FSDP leaf's squares
by block and all-reduces them, where without FSDP it sums the whole
leaf's.  With accum 2 FSDP sums each microbatch's gradient over the
data ranks (its gather's backward) and then accumulates, where without
FSDP the step accumulates and then sums; Adam turns those last bits into
up to 3.3e-4·lr for elements whose gradient is near 0, so there the
parameters are held to `PARAM_TOL` in units of lr, as against `repro`.
`reshard`: bitwise; the loss on the survivors' mesh within rtol 1e-5 of
`repro`'s.
"""
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp_workers as DPW  # noqa: E402
import torch_tp_workers as W  # noqa: E402
from repro.configs.base import get_smoke_config as r_smoke  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.train.step import make_train_step as r_make_step  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import leaves, unflatten  # noqa: E402
from repro_torch.sharding import axes as ax  # noqa: E402
from repro_torch.sharding.ranks import spawn_ranks  # noqa: E402

MOMENT_TOL = 1e-3
PARAM_TOL = dict(most=1e-2, share=1e-3, every=0.5)   # × Σlr
CONFIGS = [(arch, None) for arch in DPW.ARCHS] + [
    ("granite-moe-1b-a400m", W.ODD_VOCAB)]
TOKENS = (4, 32)


def start_params():
    """(arch, vocab) → the port's float32 init (seed 0) as numpy."""
    out = {}
    for arch, vocab in CONFIGS:
        model = build_model(W.smoke(arch, vocab), "cpu")
        flat = tree_flatten(model.init(torch.Generator().manual_seed(0),
                                       torch.float32))[0]
        out[arch, vocab] = unflatten((path, t.numpy()) for (path, _), t in
                                     zip(leaves(model.spec), flat))
    return out


def leaf_gap(want_tree, got):
    """The largest |got − want| of any leaf over that leaf's largest
    |want|."""
    want = jax.tree.leaves(want_tree)
    assert len(want) == len(got)
    return max(float(np.abs(g.numpy() - np.asarray(w)).max() /
                     max(np.abs(np.asarray(w)).max(), 1e-30))
               for w, g in zip(want, got))


def reference(start, tokens):
    """repro's jitted steps of each layout's configs on its global
    batches, and its loss of qwen3's start on `tokens`."""
    out = {}
    jitted = {}
    for name, (_, _, _, archs, steps, vocab) in W.LAYOUTS.items():
        for arch in archs:
            cfg = r_smoke(arch)
            if vocab:
                cfg = replace(cfg, vocab=vocab)
            rm = RModel(cfg)
            snaps = []
            for s in range(steps):
                p = jax.tree.map(jnp.asarray, start[arch, vocab])
                o = r_adamw.init(p)
                key = (arch, vocab, s)
                if key not in jitted:
                    jitted[key] = jax.jit(r_make_step(
                        rm, r_adamw.AdamWConfig(**DPW.OPT),
                        accum_steps=s + 1))
                batch = {"tokens": jnp.asarray(W.global_batch(cfg.vocab,
                                                              s))}
                p, o, m = jitted[key](p, o, batch)
                snaps.append(jax.tree.map(np.asarray, (p, o, m)))
            out[name, arch] = snaps
    rm = RModel(r_smoke("qwen3-1.7b"))
    out["loss"] = float(jax.jit(rm.loss)(
        jax.tree.map(jnp.asarray, start["qwen3-1.7b", None]),
        {"tokens": jnp.asarray(tokens)})[0])
    return out


@pytest.fixture(scope="module")
def runs():
    """(repro's numbers, world → each rank's results)."""
    start = start_params()
    tokens = DPW.global_batch(512, 9, 1)[:TOKENS[0]]
    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(spawn_ranks, W.tp_world_rank, w, "gloo",
                                  "cpu", (start, tokens)) for w in (2, 4)}
        ref = reference(start, tokens)
        return ref, {w: f.result() for w, f in futures.items()}


def cases():
    for name, (_, _, _, archs, steps, _) in W.LAYOUTS.items():
        for arch in archs:
            for step in range(steps):
                yield name, arch, step


@pytest.mark.parametrize("name,arch,step", list(cases()))
def test_step_matches_repro_on_the_global_batch(runs, name, arch, step):
    """Step 0 accum 1, step 1 accum 2, each from the start."""
    world = W.LAYOUTS[name][0]
    r_params, r_opt, r_met = runs[0][name, arch][step]
    snap = runs[1][world][0][name][arch][step]
    met = snap["metrics"]
    assert sorted(met) == sorted(r_met)
    assert met["loss"] == pytest.approx(float(r_met["loss"]), rel=1e-5)
    assert met["grad_norm"] == pytest.approx(float(r_met["grad_norm"]),
                                             rel=1e-4)
    assert met["lr"] == pytest.approx(float(r_met["lr"]), rel=1e-6)
    if "tokens" in met:
        assert met["tokens"] == float(r_met["tokens"])
    assert snap["step"] == int(r_opt.step) == 1
    assert leaf_gap(r_opt.mu, snap["mu"]) <= MOMENT_TOL
    assert leaf_gap(r_opt.nu, snap["nu"]) <= MOMENT_TOL
    lr_sum = met["lr"]
    gap = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel() for
                          w, g in zip(jax.tree.leaves(r_params),
                                      snap["params"])]) / lr_sum
    assert gap.max() <= PARAM_TOL["every"]
    assert (gap > PARAM_TOL["most"]).mean() <= PARAM_TOL["share"]


@pytest.mark.parametrize("name", list(W.LAYOUTS))
def test_ranks_holding_a_block_hold_the_same_bits(runs, name):
    """The replicated leaves are bitwise equal on every rank, and each
    block on every rank that holds it; the metrics are the same."""
    world, _, _, archs, steps, _ = W.LAYOUTS[name]
    for arch in archs:
        for step in range(steps):
            snaps = [r[name][arch][step] for r in runs[1][world]]
            seen = {}
            for snap in snaps:
                assert snap["metrics"] == snaps[0]["metrics"]
                for i, (local, bounds) in enumerate(snap["local"]):
                    if (i, bounds) in seen:
                        assert torch.equal(seen[i, bounds], local)
                    seen[i, bounds] = local


@pytest.mark.parametrize("name", list(W.LAYOUTS))
def test_each_rank_holds_the_rules_block_of_each_leaf(runs, name):
    """A leaf the rules shard is a block on every rank, never whole; one
    whose mapping does not divide is whole (`divisible_spec`)."""
    world, shape, rules, archs, _, vocab = W.LAYOUTS[name]
    sizes = dict(zip(W.NAMES, shape))
    for arch in archs:
        model = build_model(W.smoke(arch, vocab), "cpu")
        defs = [p for _, p in leaves(model.spec)]
        n_sharded = 0
        for res in runs[1][world]:
            for (local, _), pd in zip(res[name][arch][-1]["local"], defs):
                spec = ax.divisible_spec(ax.spec_for(pd.axes, rules),
                                         pd.shape, type("M", (), {
                                             "axis_names": W.NAMES,
                                             "devices": np.empty(shape)})())
                ways = int(np.prod([sizes[a] for e in spec
                                    for a in ax._names(e)]))
                assert local.numel() * ways == int(np.prod(pd.shape))
                n_sharded += ways > 1
        assert n_sharded > 0


def test_vocab_that_does_not_divide_is_replicated(runs):
    res = runs[1][2][0]["odd_vocab"]["granite-moe-1b-a400m"][0]
    model = build_model(W.smoke("granite-moe-1b-a400m", W.ODD_VOCAB), "cpu")
    paths = [path for path, _ in leaves(model.spec)]
    for path in ("embed/tok", "embed/head"):
        local, bounds = res["local"][paths.index(path)]
        assert W.ODD_VOCAB in local.shape
    local, _ = res["local"][paths.index("blocks/ffn/wi0")]
    assert local.shape[1] == 2        # 4 experts over 2 ranks


def test_kv_heads_fall_back_with_one_q_head_per_rank(runs):
    res = runs[1][4][0]["kv_fallback"]["qwen3-1.7b"][0]
    model = build_model(W.smoke("qwen3-1.7b"), "cpu")
    paths = [path for path, _ in leaves(model.spec)]
    assert res["local"][paths.index("blocks/mixer/q")][0].shape[2] == 1
    assert res["local"][paths.index("blocks/mixer/k")][0].shape[2] == 2


@pytest.mark.parametrize("arch", DPW.ARCHS)
@pytest.mark.parametrize("step", [0, 1])
def test_fsdp_matches_the_layout_without_its_gather(runs, arch, step):
    for r in runs[1][4]:
        got, want = r["fsdp"][arch][step], r["dp2_tp2"][arch][step]
        assert got["metrics"]["loss"] == want["metrics"]["loss"]
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-6)
        for which in ("mu", "nu") if step else ("params", "mu", "nu"):
            for a, b in zip(got[which], want[which]):
                assert float((a - b).abs().max()) <= 1e-6 * float(
                    b.abs().max())
        if step:
            gap = torch.cat([(a - b).abs().flatten() for a, b in zip(
                got["params"], want["params"])]) / want["metrics"]["lr"]
            assert float(gap.max()) <= PARAM_TOL["every"]
            assert float((gap > PARAM_TOL["most"]).float().mean()) <= \
                PARAM_TOL["share"]


def test_collectives_and_their_transposes(runs):
    """Over two ranks, rank r's input x·(r+1) and output gradient
    1 + arange·10^r."""
    x0 = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    xs = [x0 * (r + 1) for r in range(2)]
    res = [r["collectives"] for r in runs[1][2]]

    def g(shape, r):
        n = int(np.prod(shape))
        return 1.0 + torch.arange(n, dtype=torch.float32).reshape(shape) * (
            10.0 ** r)
    for r in range(2):
        y, gx = res[r]["all_gather"]
        assert torch.equal(y, torch.cat(xs, dim=1))
        total = g((3, 8), 0) + g((3, 8), 1)
        assert torch.equal(gx, total[:, 4 * r:4 * r + 4])
        y, gx = res[r]["reduce_scatter"]
        assert torch.equal(y, (xs[0] + xs[1])[:, 2 * r:2 * r + 2])
        assert torch.equal(gx, torch.cat([g((3, 2), 0), g((3, 2), 1)], 1))
        y, gx = res[r]["all_reduce"]
        assert torch.equal(y, xs[0] + xs[1])
        assert torch.equal(gx, g((3, 4), r))
        y, gx = res[r]["copy_to"]
        assert torch.equal(y, xs[r])
        assert torch.equal(gx, g((3, 4), 0) + g((3, 4), 1))


def test_reshard_of_a_tensor_parallel_tree_onto_the_survivors(runs):
    e = runs[1][2][0]["survivors"]
    assert e["equal"] and all(e["equal"])
    assert all(n == 0 for n in runs[1][2][1]["survivors"]["sizes"])
    assert e["loss"] == pytest.approx(runs[0]["loss"], rel=1e-5)

"""The port's second wide model axis: `Model.prefill`, `Model.decode_step`,
`Model.loss` and `make_train_step(mesh=, rules=)` under
`sequence_parallel_rules(False)` on a mesh whose "data" axis is 2 (the
reference dry-run's long_500k layout: heads, K/V heads and SSM mixers
over "data"; the residual, MLP, experts, vocabulary and KV sequence over
"model"; the batch whole on every rank) and under `fsdp_rules` over
those rules (Jamba's), on gloo ranks of the CPU
(`sharding.ranks.spawn_ranks`, float32 weights at smoke sizes), held
against `repro`'s one-device entry points under `jax.jit`.

Two spawns (`tests/torch_sp_serve_workers.py` `SERVE`, `TRAIN`), while
`repro`'s references compile and run:

* W = 4, (1, 2, 2): mamba2, qwen3 and Jamba, qwen3 with 3 K/V heads
  (they do not divide over "data": each rank holds all three and its q
  heads [0, 3) or [3, 6) read [0, 2) or [1, 3), unevenly grouped) and
  the uneven-heads Mamba2 (3 heads of 32) under the rules; Jamba under
  `fsdp_rules` over them; the KV cache blocks [B, 8 of 16 positions,
  its K/V heads, hd], the prompt at 0-5 and the steps at 6, 7, 8, so the
  last writes into "model" rank 1's slice.
* W = 2, (1, 2, 1): the same, the heads over "data" and the residual
  whole.

Each serves a prompt of 4 rows × 6 tokens and 3 decode steps of given
tokens, each step from the reference's caches before it, carried to the
rank's blocks (`convert.caches_from_numpy(..., shardings=)`); Mamba2 and
Jamba score the global batch (the kernels' ops on: their plain versions
on the CPU) and take one train step.

Tolerances, `tests/test_torch_tp_serve.py`'s: logits within rtol = atol
= 1e-5 plus 1e-5 of the largest |logit|, Jamba's within atol 1e-3 (its
smoke attention has no qk-norm and amplifies float32 reorderings); the
bfloat16 caches within one bfloat16 ulp plus that atol, the float32 SSM
state within the same tolerances; every cache leaf is the rules' block
(2-D where both axes divide it), and ranks that hold the same block
hold the same bits.  The steps within `tests/test_torch_tp_train.py`'s
bounds (the loss rtol 1e-5, `grad_norm` 1e-4, the moments 1e-3 of each
leaf's largest, the parameters all but 0.1% within 1e-2·lr and within
0.5·lr where the reference's first moment exceeds the moments' bound:
Adam moves each element by about lr whatever its gradient, so where the
moment lies within its bound of 0 the update's sign is not fixed by
it).  Jamba's moments within 1e-2 (`AMPLIFIED_MOMENT_TOL`): on this
batch the port's one-device step is already 5.0e-4 (mu) and 9.9e-4 (nu)
of a leaf's largest from the reference's, and up to 0.93·lr in a
parameter whose gradient is near 0, its attention amplifying float32
reorderings as in the logits.  After the step each leaf's block is
bitwise equal on every rank that holds it.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp_workers as DPW  # noqa: E402
import torch_sp_serve_workers as W  # noqa: E402
import torch_tp_serve_workers as TPSW  # noqa: E402
import torch_tp_workers as TPW  # noqa: E402
from repro.configs.base import get_smoke_config as r_smoke  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.train.step import make_train_step as r_make_step  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import leaves, unflatten  # noqa: E402
from repro_torch.sharding import axes as ax  # noqa: E402
from repro_torch.sharding.ranks import spawn_ranks  # noqa: E402
from dataclasses import replace  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
AMPLIFIED_TOL = dict(rtol=1e-5, atol=1e-3)
LOGIT_RTOL = 1e-5
MOMENT_TOL = 1e-3
# Jamba's: its port's one-device step is already 5.0e-4 (mu) and 9.9e-4
# (nu) of a leaf's largest from the reference's on this batch
AMPLIFIED_MOMENT_TOL = 1e-2
PARAM_TOL = dict(most=1e-2, share=1e-3, every=0.5)   # × lr
TRAIN_ARCHS = ("mamba2-2.7b", W.JAMBA)


def tol(arch):
    return AMPLIFIED_TOL if arch == W.JAMBA else TOL


def moment_tol(arch):
    return AMPLIFIED_MOMENT_TOL if arch == W.JAMBA else MOMENT_TOL


def r_config(arch):
    if arch == TPSW.UNEVEN:
        return replace(r_smoke("mamba2-2.7b"), d_model=48, ssm_headdim=32)
    if arch == TPSW.KV3:
        return replace(r_smoke("qwen3-1.7b"), n_heads=6, n_kv_heads=3)
    return r_smoke(arch)


def plain(tree):
    """A cache tree of numpy leaves with `repro`'s NamedTuples as tuples,
    so that a rank unpickles it without `repro`."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(plain(v) for v in tree)
    return np.asarray(tree)


def cache_leaves(tree):
    """The leaves of a cache tree in `cache_blocks`' order: dict keys
    sorted, then the NamedTuple's fields."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in cache_leaves(tree[k])]
    if isinstance(tree, tuple) and not (
            tree and all(a is None or isinstance(a, str) for a in tree)):
        return [x for v in tree for x in cache_leaves(v)]
    return [tree]


def start_params():
    """arch → the port's float32 init (seed 0) as numpy."""
    out = {}
    for arch in W.SERVE_ARCHS:
        model = build_model(TPSW.smoke(arch), "cpu")
        flat = tree_flatten(model.init(torch.Generator().manual_seed(0),
                                       torch.float32))[0]
        out[arch] = unflatten((path, t.numpy()) for (path, _), t in
                              zip(leaves(model.spec), flat))
    return out


def inputs():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (TPSW.ROWS, TPSW.PROMPT))
    steps = [rng.integers(0, 512, (TPSW.ROWS, 1)) for _ in
             range(TPSW.STEPS)]
    return tokens, steps


def train_batch():
    return TPW.global_batch(512, 0)


def reference(start, tokens, steps):
    """arch → {"logits": [prefill, step 1, …], "caches": [after prefill,
    after step 1, …]} of `repro`'s one-device chain under `jax.jit` (one
    jitted prefill and decode step per arch), and ("train", arch) the
    loss and one step of Mamba2 and Jamba on the global batch."""
    out = {}
    for arch in W.SERVE_ARCHS:
        rm = RModel(r_config(arch))
        prefill = jax.jit(rm.prefill, static_argnums=2)
        decode = jax.jit(rm.decode_step)
        p = jax.tree.map(jnp.asarray, start[arch])
        logits, caches = prefill(p, {"tokens": jnp.asarray(tokens)},
                                 TPSW.MAX_SEQ)
        ls, cs = [np.asarray(logits)], [plain(caches)]
        for i, tok in enumerate(steps):
            logits, caches = decode(p, jnp.asarray(tok), TPSW.PROMPT + i,
                                    caches)
            ls.append(np.asarray(logits))
            cs.append(plain(caches))
        out[arch] = dict(logits=ls, caches=cs)
    batch = {"tokens": jnp.asarray(train_batch())}
    for arch in TRAIN_ARCHS:
        rm = RModel(r_smoke(arch))
        p = jax.tree.map(jnp.asarray, start[arch])
        loss = float(jax.jit(rm.loss)(p, batch)[0])
        step = jax.jit(r_make_step(rm, r_adamw.AdamWConfig(**DPW.OPT)))
        out["train", arch] = (loss, jax.tree.map(
            np.asarray, step(p, r_adamw.init(p), batch)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(repro's numbers, world → each rank's results).  The ranks start,
    train and prefill while `repro`'s references compile and run; they
    read the caches the decode steps start from once the fixture has
    written them."""
    start = start_params()
    tokens, steps = inputs()
    path = str(tmp_path_factory.mktemp("refs") / "refs.pt")
    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(
            spawn_ranks, W.sp_world_rank, w, "gloo", "cpu",
            (start, tokens, steps, path, train_batch())) for w in (2, 4)}
        ref = None
        try:
            ref = reference(start, tokens, steps)
        finally:       # an empty file stops the ranks if repro failed
            torch.save({} if ref is None else {
                arch: ref[arch]["caches"][:-1] for arch in W.SERVE_ARCHS},
                path + ".part")
            os.replace(path + ".part", path)
        return ref, {w: f.result() for w, f in futures.items()}


def serve_cases():
    return [(name, arch) for name, (_, _, _, archs) in W.SERVE.items()
            for arch in archs]


def train_cases():
    return [(name, arch) for name, (_, _, _, archs) in W.TRAIN.items()
            for arch in archs]


def rank_results(runs, name, arch):
    return [r[name, arch] for r in runs[1][W.SERVE[name][0]]]


def stand_in(shape):
    """An object with the mesh's axis names and shape, for `axes`."""
    return type("M", (), {"axis_names": W.NAMES,
                          "devices": np.empty(shape)})()


def blocks_of(res):
    return [res["prefill"][1]] + [s[1] for s in res["steps"]]


@pytest.mark.parametrize("rules,shape,arch", [
    (W.SP, (1, 2, 2), "mamba2-2.7b"), (W.SP, (1, 2, 2), "qwen3-1.7b"),
    (W.SP, (1, 2, 2), W.JAMBA), (W.SP, (1, 2, 1), "mamba2-2.7b"),
    (W.SP, (1, 2, 1), "qwen3-1.7b"), (W.SP, (1, 2, 1), W.JAMBA),
    (W.FSDP_SP, (1, 2, 2), W.JAMBA), (W.FSDP_SP, (1, 2, 1), W.JAMBA)],
    ids=["sp-mamba2", "sp-qwen3", "sp-jamba", "sp_data_only-mamba2",
         "sp_data_only-qwen3", "sp_data_only-jamba", "fsdp_sp-jamba",
         "fsdp_sp_data_only-jamba"])
def test_check_layout_accepts_the_second_wide_axis(rules, shape, arch):
    """`Model.check_layout` passes, and the mixers' axis is "data"."""
    model = build_model(TPSW.smoke(arch), "cpu")
    model.check_layout(rules, stand_in(shape))
    assert ax.mixer_axis(rules, stand_in(shape)) == "data"
    assert ax.model_axis(rules, stand_in(shape)) == (
        "model" if shape[2] > 1 else None)


@pytest.mark.parametrize("name,arch", serve_cases())
def test_logits_match_repro(runs, name, arch):
    """The prefill's and each decode step's logits, every row on every
    rank, whole over the vocabulary."""
    want = runs[0][arch]["logits"]
    for res in rank_results(runs, name, arch):
        assert res["rows"] == (0, TPSW.ROWS)
        got = [res["prefill"][0]] + [s[0] for s in res["steps"]]
        assert len(got) == len(want) == TPSW.STEPS + 1
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            kw = dict(tol(arch))
            kw["atol"] += LOGIT_RTOL * float(np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), w, **kw)


@pytest.mark.parametrize("name,arch", serve_cases())
def test_cache_blocks_match_repro(runs, name, arch):
    """Each rank's block of every cache leaf against the same block of
    the reference's, after the prefill and after each step."""
    want = runs[0][arch]["caches"]
    extra = tol(arch)["atol"]
    for res in rank_results(runs, name, arch):
        for got, ref in zip(blocks_of(res), want):
            ref = cache_leaves(ref)
            assert len(got) == len(ref)
            for (path, local, bounds, shape), r in zip(got, ref):
                r = np.asarray(r, np.float32)
                assert shape == r.shape, path
                r = r[tuple(slice(a, b) for a, b in bounds)]
                g = local.float().numpy()
                if local.dtype == torch.bfloat16:
                    assert np.all(np.abs(g - r) <= 2.0 ** -7 * np.abs(r)
                                  + extra), path
                else:
                    assert local.dtype == torch.float32, path
                    np.testing.assert_allclose(g, r, **tol(arch))


@pytest.mark.parametrize("name,arch", serve_cases())
def test_cache_blocks_are_the_rules_blocks(runs, name, arch):
    """Every rank holds the rules' block of each cache leaf at its mesh
    coordinate (the mappings that divide the leaf, `divisible_spec`): on
    (1, 2, 2) a K/V leaf is split over "model" by positions and, where
    the K/V heads divide, over "data" by heads, the 2-D block
    [B, S/2, Hk/2, hd]; an SSM state whose heads divide is split over
    "data"; the conv state is whole."""
    _, shape, rules, _ = W.SERVE[name]
    mesh = stand_in(shape)
    axes = cache_leaves(build_model(TPSW.smoke(arch), "cpu").cache_axes())
    cfg = TPSW.smoke(arch)
    for rank, res in enumerate(rank_results(runs, name, arch)):
        coord = np.unravel_index(rank, shape)
        for (path, local, bounds, full), a in zip(res["prefill"][1], axes):
            spec = ax.divisible_spec(ax.spec_for(a, rules), full, mesh)
            want, ways = [], []
            for d, n in enumerate(full):
                entry = spec[d] if d < len(spec) else None
                idx, w = 0, 1
                for m in ax._names(entry):
                    i = W.NAMES.index(m)
                    idx, w = idx * shape[i] + coord[i], w * shape[i]
                want.append((idx * n // w, (idx + 1) * n // w))
                ways.append(w)
            assert bounds == tuple(want), path
            assert tuple(local.shape) == tuple(b - a for a, b in want)
            leaf = path.rsplit("/", 1)[-1]
            if leaf in ("k", "v"):
                heads_divide = cfg.n_kv_heads % shape[1] == 0
                assert ways == [1, 1, shape[2], shape[1] if heads_divide
                                else 1, 1], path
            elif leaf == "h":
                assert ways == [1, 1, shape[1] if cfg.ssm_heads % shape[1]
                                == 0 else 1, 1, 1], path
            else:
                assert ways == [1] * len(full), path


@pytest.mark.parametrize("name,arch", serve_cases())
def test_shared_blocks_and_logits_are_bitwise_equal(runs, name, arch):
    """Ranks that hold the same block of a cache leaf (every rank, for a
    leaf the rules replicate) hold the same bits, after the prefill and
    each step, and every rank returns the same logits."""
    results = rank_results(runs, name, arch)
    for t in range(TPSW.STEPS + 1):
        seen, logits = {}, None
        for res in results:
            got = ([res["prefill"][0]] + [s[0] for s in res["steps"]])[t]
            if logits is not None:
                assert torch.equal(logits, got)
            logits = got
            for path, local, bounds, _ in blocks_of(res)[t]:
                if (path, bounds) in seen:
                    assert torch.equal(seen[path, bounds], local), path
                seen[path, bounds] = local


def test_steps_cross_into_the_next_model_rank_slice(runs):
    """On (1, 2, 2) "model" rank r holds cache positions [8r, 8r + 8) of
    its "data" rank's K/V heads; the third step (position 8) writes the
    first row of "model" rank 1's slice, which matches the reference's,
    and leaves "model" rank 0's slice as it was."""
    res = rank_results(runs, "sp", "qwen3-1.7b")
    want = np.asarray(cache_leaves(runs[0]["qwen3-1.7b"]["caches"][-1])[0],
                      np.float32)
    for rank, r in enumerate(res):
        last = {p: (loc, b) for p, loc, b, _ in blocks_of(r)[-1]}
        before = {p: loc for p, loc, _, _ in blocks_of(r)[-2]}
        local, bounds = last["k"]
        m = rank % 2
        assert bounds[2] == (8 * m, 8 * m + 8)
        if m == 0:
            assert torch.equal(local, before["k"])
        else:
            assert bool(local[:, :, 0].abs().sum() > 0)
            assert bool(local[:, :, 1:].abs().sum() == 0)
            h0, h1 = bounds[3]
            got = local[:, :, 0].float().numpy()
            w = want[:, :, 8, h0:h1]
            assert np.all(np.abs(got - w) <= 2.0 ** -7 * np.abs(w) + 1e-5)


@pytest.mark.parametrize("name,arch", train_cases())
def test_loss_and_train_step_match_repro(runs, name, arch):
    """The scoring loss (the kernels' ops on) and one train step on the
    global batch against `repro`'s; the gradients of the mixers' leaves
    that are whole on "data" summed over it, the others not."""
    r_loss, (r_params, r_opt, r_met) = runs[0]["train", arch]
    results = [r["train", name, arch] for r in runs[1][W.TRAIN[name][0]]]
    for snap in results:
        met = snap["metrics"]
        assert snap["loss"] == pytest.approx(r_loss, rel=1e-5)
        assert met["loss"] == pytest.approx(float(r_met["loss"]), rel=1e-5)
        assert met["grad_norm"] == pytest.approx(float(r_met["grad_norm"]),
                                                 rel=1e-4)
        assert met["lr"] == pytest.approx(float(r_met["lr"]), rel=1e-6)
        for which, tree in (("mu", r_opt.mu), ("nu", r_opt.nu)):
            for w, g in zip(jax.tree.leaves(tree), snap[which]):
                w = np.asarray(w)
                assert float(np.abs(g.numpy() - w).max()) <= moment_tol(
                    arch) * max(float(np.abs(w).max()), 1e-30)
        gap = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel() for
                              w, g in zip(jax.tree.leaves(r_params),
                                          snap["params"])]) / met["lr"]
        signed = np.concatenate([
            (np.abs(np.asarray(m)) > moment_tol(arch) * max(
                float(np.abs(np.asarray(m)).max()), 1e-30)).ravel()
            for m in jax.tree.leaves(r_opt.mu)])
        assert gap[signed].max() <= PARAM_TOL["every"]
        assert (gap > PARAM_TOL["most"]).mean() <= PARAM_TOL["share"]


@pytest.mark.parametrize("name,arch", train_cases())
def test_train_step_blocks_are_bitwise_equal_across_ranks(runs, name, arch):
    """After the step every rank that holds a block of a leaf holds the
    same bits (a replicated leaf: every rank), and the rules shard some
    leaf over "data"."""
    results = [r["train", name, arch] for r in runs[1][W.TRAIN[name][0]]]
    seen, n_sharded = {}, 0
    for snap in results:
        for i, (local, bounds) in enumerate(snap["local"]):
            if (i, bounds) in seen:
                assert torch.equal(seen[i, bounds], local)
            seen[i, bounds] = local
            n_sharded += local.numel() < snap["params"][i].numel()
    assert n_sharded > 0

"""Serving over a model mesh in the port: `Model.prefill` and
`Model.decode_step` under tensor and expert parallelism, the KV cache's
sequence over "model" and the SSM mixers over a wide "model" axis, on
gloo ranks of the CPU (`sharding.ranks.spawn_ranks`, one process per
rank, float32 weights at smoke sizes), held against `repro`'s one-device
entry points under `jax.jit`; and Mamba2's loss and train step under
`base_rules(False)` against `repro`'s one-device step.

Two spawns, each running its layouts in turn (`tests/
torch_tp_serve_workers.py` `SERVE`, `TRAIN`), after `repro`'s
references, which the decode steps start from:

* W = 2, (1, 1, 2): `base_rules(False)` for mamba2, qwen3, granite-moe
  and Jamba; qwen3 under `decode_32k`'s layout (the reference dry-run's:
  `seq_kv` over "model", `kv_heads` replicated; 16 cache positions, 8 a
  rank, the prompt at 0-5 and the steps at 6, 7, 8, so the last writes
  into rank 1's slice); `sequence_parallel_rules(False)` for Jamba and
  qwen3 (the heads and SSM mixers on "data", of size 1: whole on every
  rank); the uneven-heads Mamba2 (d_model 48, 3 heads of 32: `ssm_inner`
  splits over 2 ranks, the heads do not); qwen3 with `base_rules`' K/V
  weights split and the KV sequence over "model" (each rank gathers
  the K/V heads before writing its slice); Mamba2's loss and one step.
* W = 4, (1, 2, 2): the same under `base_rules(False)` and
  `decode_32k`'s layout, the batch's 4 rows over "data"; qwen3 and
  mamba2 under `fsdp_rules(base_rules(False))` (the weights' `embed`
  blocks over "data", gathered where each layer and the head use them).

The prompt is 4 rows × 6 tokens, then 3 decode steps of given tokens;
each step starts from the reference's caches before it, carried to the
rank's blocks (`convert.caches_from_numpy(..., shardings=)`).  The
kernels' ops are on in the port (their plain versions on the CPU), off
in `repro` (its smoke setting), as `tests/test_torch_zoo.py` runs them.

Tolerances, `tests/test_torch_zoo.py`'s:

* logits within rtol = atol = 1e-5 plus 1e-5 of the largest |logit|
  (`LOGIT_RTOL`: a float32 sum errs in proportion to the magnitudes it
  adds); Jamba's and granite-moe's within atol 1e-3 (`AMPLIFIED_TOL`:
  their smoke attention has no qk-norm, its scores reach O(50–100) and
  amplify float32 reorderings ~100×, the reference alone included; on
  these inputs the port's one-device granite decode is already 1.2e-4
  from the reference's at the third step).  Measured against the port's
  one-device run: ≤ 4.9e-6 (2.6e-5 Jamba) on logits up to 4.3.
* bfloat16 caches (K/V, the conv state) within one bfloat16 ulp plus
  the float32 atol (|a − b| ≤ 2⁻⁷·|b| + 1e-5; + 1e-3 for the two
  above), the float32 SSM state within `TOL` (`AMPLIFIED_TOL` for
  Jamba).
* Every rank's cache leaf is the rules' block of the reference's
  (`divisible_spec`), and ranks that hold the same block of a leaf, or
  the same rows of the logits, hold the same bits.
* Mamba2's step, `tests/test_torch_tp_train.py`'s: the loss within rtol
  1e-5, `grad_norm` 1e-4, `lr` 1e-6, the moments within 1e-3 of each
  leaf's largest element, the parameters within 0.5·lr and all but 0.1%
  within 1e-2·lr; the scoring loss within rtol 1e-5.
"""
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp_workers as DPW  # noqa: E402
import torch_tp_serve_workers as W  # noqa: E402
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

# smoke attention without qk-norm: scores of O(50-100)
AMPLIFIED = ("jamba-1.5-large-398b", "granite-moe-1b-a400m")
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_RTOL = 1e-5
AMPLIFIED_TOL = dict(rtol=1e-5, atol=1e-3)
MOMENT_TOL = 1e-3
PARAM_TOL = dict(most=1e-2, share=1e-3, every=0.5)   # × lr
SERVE_ARCHS = W.ARCHS + (W.UNEVEN,)


def tol(arch):
    return AMPLIFIED_TOL if arch in AMPLIFIED else TOL


def r_config(arch):
    if arch == W.UNEVEN:
        return replace(r_smoke("mamba2-2.7b"), d_model=48, ssm_headdim=32)
    return r_smoke(arch)


class Jitted:
    """`repro`'s serving entry points under `jax.jit`
    (`tests/test_torch_zoo.py`'s)."""

    def __init__(self, rm):
        self.prefill = jax.jit(rm.prefill, static_argnums=2)
        self.decode_step = jax.jit(rm.decode_step)


def plain(tree):
    """A cache tree of numpy leaves with `repro`'s NamedTuples as tuples,
    so that a rank unpickles it without `repro`."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(plain(v) for v in tree)
    return np.asarray(tree)


def cache_leaves(tree):
    """The leaves of a cache tree in `torch_tp_serve_workers.cache_blocks`'
    order: dict keys sorted, then the NamedTuple's fields."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in cache_leaves(tree[k])]
    if isinstance(tree, tuple) and not (
            tree and all(a is None or isinstance(a, str) for a in tree)):
        return [x for v in tree for x in cache_leaves(v)]
    return [tree]


def start_params():
    """arch → the port's float32 init (seed 0) as numpy."""
    out = {}
    for arch in SERVE_ARCHS:
        model = build_model(W.smoke(arch), "cpu")
        flat = tree_flatten(model.init(torch.Generator().manual_seed(0),
                                       torch.float32))[0]
        out[arch] = unflatten((path, t.numpy()) for (path, _), t in
                              zip(leaves(model.spec), flat))
    return out


def inputs():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (W.ROWS, W.PROMPT))
    steps = [rng.integers(0, 512, (W.ROWS, 1)) for _ in range(W.STEPS)]
    return tokens, steps


def reference(start, tokens, steps):
    """arch → {"logits": [prefill, step 1, …], "caches": [after prefill,
    after step 1, …]} of `repro`'s one-device chain, and ("train") its
    loss and one step of Mamba2 on the global batch."""
    out = {}
    for arch in SERVE_ARCHS:
        j = Jitted(RModel(r_config(arch)))
        p = jax.tree.map(jnp.asarray, start[arch])
        logits, caches = j.prefill(p, {"tokens": jnp.asarray(tokens)},
                                   W.MAX_SEQ)
        ls, cs = [np.asarray(logits)], [plain(caches)]
        for i, tok in enumerate(steps):
            logits, caches = j.decode_step(p, jnp.asarray(tok),
                                           W.PROMPT + i, caches)
            ls.append(np.asarray(logits))
            cs.append(plain(caches))
        out[arch] = dict(logits=ls, caches=cs)
    rm = RModel(r_smoke(W.TRAIN_ARCH))
    p = jax.tree.map(jnp.asarray, start[W.TRAIN_ARCH])
    batch = {"tokens": jnp.asarray(TPW.global_batch(512, 0))}
    loss = float(jax.jit(rm.loss)(p, batch)[0])
    step = jax.jit(r_make_step(rm, r_adamw.AdamWConfig(**DPW.OPT)))
    out["train"] = (loss, jax.tree.map(np.asarray,
                                       step(p, r_adamw.init(p), batch)))
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
            spawn, w, (start, tokens, steps, path, start[W.TRAIN_ARCH],
                       TPW.global_batch(512, 0))) for w in (2, 4)}
        ref = None
        try:
            ref = reference(start, tokens, steps)
        finally:       # an empty file stops the ranks if repro failed
            torch.save({} if ref is None else {
                arch: ref[arch]["caches"][:-1] for arch in SERVE_ARCHS},
                path + ".part")
            os.replace(path + ".part", path)
        return ref, {w: f.result() for w, f in futures.items()}


def spawn(world, args):
    return spawn_ranks(W.serve_world_rank, world, "gloo", "cpu", args)


def serve_cases():
    return [(name, arch) for name, (_, _, _, archs) in W.SERVE.items()
            for arch in archs]


def rank_results(runs, name, arch):
    return [r[name, arch] for r in runs[1][W.SERVE[name][0]]]


def stand_in(shape):
    """An object with the mesh's axis names and shape, for `axes`."""
    return type("M", (), {"axis_names": W.NAMES,
                          "devices": np.empty(shape)})()


@pytest.mark.parametrize("name,arch", serve_cases())
def test_logits_match_repro(runs, name, arch):
    """The prefill's and each decode step's logits, on every rank its
    rows of the batch, whole over the vocabulary."""
    want = runs[0][arch]["logits"]
    for res in rank_results(runs, name, arch):
        lo, hi = res["rows"]
        got = [res["prefill"][0]] + [s[0] for s in res["steps"]]
        assert len(got) == len(want) == W.STEPS + 1
        for g, w in zip(got, want):
            w = w[lo:hi]
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            kw = dict(tol(arch))
            kw["atol"] += LOGIT_RTOL * float(np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), w, **kw)


def blocks_of(res):
    return [res["prefill"][1]] + [s[1] for s in res["steps"]]


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
    """Every rank holds the rules' block of each cache leaf (the mappings
    that divide the leaf, `divisible_spec`), at its mesh coordinate; the
    rules shard at least one leaf, except the uneven-heads Mamba2's on
    (1, 1, 2): its 3 heads do not divide, so its state is whole, as the
    conv state always is."""
    _, shape, rules, _ = W.SERVE[name]
    mesh = stand_in(shape)
    axes = cache_leaves(build_model(W.smoke(arch), "cpu").cache_axes())
    n_sharded = 0
    for rank, res in enumerate(rank_results(runs, name, arch)):
        coord = np.unravel_index(rank, shape)
        for (path, local, bounds, full), a in zip(res["prefill"][1], axes):
            spec = ax.divisible_spec(ax.spec_for(a, rules), full, mesh)
            want = []
            for d, n in enumerate(full):
                entry = spec[d] if d < len(spec) else None
                idx, ways = 0, 1
                for m in ax._names(entry):
                    i = W.NAMES.index(m)
                    idx, ways = idx * shape[i] + coord[i], ways * shape[i]
                want.append((idx * n // ways, (idx + 1) * n // ways))
                n_sharded += ways > 1
            assert bounds == tuple(want), path
            assert tuple(local.shape) == tuple(b - a for a, b in want)
    assert (n_sharded == 0) == (name == "uneven_heads")


@pytest.mark.parametrize("name,arch", serve_cases())
def test_shared_blocks_and_logits_are_bitwise_equal(runs, name, arch):
    """Ranks that hold the same block of a cache leaf (every rank, for a
    leaf the rules replicate) hold the same bits, after the prefill and
    each step; ranks that serve the same rows return the same logits."""
    results = rank_results(runs, name, arch)
    _, shape, rules, _ = W.SERVE[name]
    for t in range(W.STEPS + 1):
        seen, rows = {}, {}
        for res in results:
            logits = ([res["prefill"][0]] + [s[0] for s in res["steps"]])[t]
            if res["rows"] in rows:
                assert torch.equal(rows[res["rows"]], logits)
            rows[res["rows"]] = logits
            for path, local, bounds, _ in blocks_of(res)[t]:
                if (path, bounds) in seen:
                    assert torch.equal(seen[path, bounds], local), path
                seen[path, bounds] = local
        n_batch = int(np.prod([dict(zip(W.NAMES, shape))[a]
                               for a in ax.batch_axes(rules)]))
        assert len(rows) == n_batch


def test_decode_32k_steps_cross_into_the_next_rank_slice(runs):
    """Under `decode_32k`'s layout rank r holds cache positions
    [8r, 8r + 8); the third step (position 8) writes rank 1's first row,
    which matches the reference's, and rank 0's slice is unchanged by
    it."""
    res = rank_results(runs, "decode_32k", "qwen3-1.7b")
    k_of = {r: {path: (local, bounds) for path, local, bounds, _ in
                blocks_of(res[r])[-1]} for r in range(2)}
    before = {path: local for path, local, _, _ in blocks_of(res[0])[-2]}
    local1, bounds1 = k_of[1]["k"]
    assert bounds1[2] == (8, 16) and k_of[0]["k"][1][2] == (0, 8)
    assert bool(local1[:, :, 0].abs().sum() > 0)
    assert bool(local1[:, :, 1:].abs().sum() == 0)
    assert torch.equal(k_of[0]["k"][0], before["k"])
    want = np.asarray(cache_leaves(runs[0]["qwen3-1.7b"]["caches"][-1])[0],
                      np.float32)[:, :, 8]
    got = local1[:, :, 0].float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-5)


@pytest.mark.parametrize("name", list(W.TRAIN))
def test_mamba2_loss_and_train_step_match_repro(runs, name):
    """Mamba2's scoring loss and one train step under `base_rules(False)`
    (the SSM mixer's blocks over "model", its gate norm's all-reduced
    mean square, the replicated b/c projections' gradients summed over
    the axis) against `repro`'s on the global batch; every rank that
    holds a block of a leaf holds the same bits."""
    r_loss, (r_params, r_opt, r_met) = runs[0]["train"]
    results = [r["train", name] for r in runs[1][W.TRAIN[name][0]]]
    for snap in results:
        met = snap["metrics"]
        assert snap["loss"] == pytest.approx(r_loss, rel=1e-5)
        assert met["loss"] == pytest.approx(float(r_met["loss"]), rel=1e-5)
        assert met["grad_norm"] == pytest.approx(float(r_met["grad_norm"]),
                                                 rel=1e-4)
        assert met["lr"] == pytest.approx(float(r_met["lr"]), rel=1e-6)
        for which, tree in (("mu", r_opt.mu), ("nu", r_opt.nu)):
            want = jax.tree.leaves(tree)
            for w, g in zip(want, snap[which]):
                w = np.asarray(w)
                assert float(np.abs(g.numpy() - w).max()) <= MOMENT_TOL * \
                    max(float(np.abs(w).max()), 1e-30)
        gap = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel() for
                              w, g in zip(jax.tree.leaves(r_params),
                                          snap["params"])]) / met["lr"]
        assert gap.max() <= PARAM_TOL["every"]
        assert (gap > PARAM_TOL["most"]).mean() <= PARAM_TOL["share"]
    seen, n_sharded = {}, 0
    for snap in results:
        for i, (local, bounds) in enumerate(snap["local"]):
            if (i, bounds) in seen:
                assert torch.equal(seen[i, bounds], local)
            seen[i, bounds] = local
            n_sharded += local.numel() < snap["params"][i].numel()
    assert n_sharded > 0


@pytest.mark.parametrize("rules,shape,arch,raises", [
    (ax.sequence_parallel_rules(False), (1, 2, 2), "jamba-1.5-large-398b",
     False),
    (ax.pure_dp_rules(True), (2, 2, 1), "qwen3-1.7b", True),
    (ax.base_rules(False), (1, 1, 2), "whisper-small", True)],
    ids=["sequence_parallel_data2", "pure_dp_multi_pod", "encdec_base"])
def test_next_slice_layouts_still_raise(rules, shape, arch, raises):
    """The sequence over "pod" and the encoder-decoder under a layout
    wider than the batch raise `NotImplementedError` naming the next
    slices; the second wide model axis (`sequence_parallel_rules` with
    "data" 2, `tests/test_torch_sp_serve.py`) now passes the check."""
    model = build_model(W.smoke(arch), "cpu")
    if not raises:
        model.check_layout(rules, stand_in(shape))
        return
    with pytest.raises(NotImplementedError) as exc:
        model.check_layout(rules, stand_in(shape))
    assert ax.NEXT_SLICE in str(exc.value)

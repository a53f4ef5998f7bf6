"""Training over several ranks: the port's data-parallel train step with
ZeRO-1 moments, `compressed_psum`, the GPipe pipeline and elastic
resharding, on gloo ranks of the CPU (`sharding.ranks.spawn_ranks`, one
process per rank, float32 at smoke sizes), held against `repro`.

One spawn per layout, each running everything of its world
(`tests/torch_dp_workers.py`): W = 1 and W = 2 under
`pure_dp_rules(False)` on (1, W, 1), W = 4 under `base_rules(True)` on
(2, 2, 1); the three spawns run while `repro`'s jitted references
compile.  The start: each arch's parameters from the port's float32
init, the same numbers in both packages.  The global batch is the
ranks' `TokenPipeline` blocks concatenated in rank order.

Tolerances, `tests/test_torch_train.py`'s, each beside its assertion:

* W = 1 against the one-process `make_train_step`: bitwise.
* A step against `repro`'s jitted single-device step on the global
  batch: loss within rtol 1e-5, `lr` 1e-6, `grad_norm` 1e-4 (1e-3
  through the int8 compressor); moments within `MOMENT_TOL` of each
  leaf's largest element; parameters within 0.5·Σlr, all but 0.1% within
  1e-2·Σlr (`PARAM_TOL`).
* Every rank's parameters: bitwise equal.  `compressed_psum`: bitwise
  `jax.vmap` of `repro`'s over the stacked inputs.  `reshard`: bitwise.
* The pipeline: outputs within 1e-5 of the sequential stack and of
  `repro`'s `lax.scan`, gradients within 1e-4 (`tests/test_pipeline.py`'s).
* The loss on a survivors mesh: rtol 1e-5 of `repro`'s jitted loss.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp_workers as W  # noqa: E402
from repro.configs.base import get_smoke_config as r_smoke  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.optim import compression as r_comp  # noqa: E402
from repro.sharding import axes as r_ax  # noqa: E402
from repro.train.step import make_train_step as r_make_step  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import leaves, unflatten  # noqa: E402
from repro_torch.sharding import axes as ax  # noqa: E402
from repro_torch.sharding.ranks import spawn_ranks  # noqa: E402

MOMENT_TOL = (1e-3, 1e-3, 2e-2)
GRAD_NORM_RTOL = (1e-4, 1e-4, 1e-3)
PARAM_TOL = dict(most=1e-2, share=1e-3, every=0.5)   # × Σlr
PIPE = dict(L=8, L_grad=4, d=16, B=8, B_grad=4)


def start_params():
    """arch → the port's float32 init (seed 0) as numpy."""
    out = {}
    for arch in W.ARCHS:
        model = build_model(get_smoke_config(arch), "cpu")
        flat = tree_flatten(model.init(torch.Generator().manual_seed(0),
                                       torch.float32))[0]
        out[arch] = unflatten((path, t.numpy()) for (path, _), t in
                              zip(leaves(model.spec), flat))
    return out


def pipe_inputs():
    """`tests/test_pipeline.py`'s stacks from numpy: (w, b, x) for the
    forward and for the gradients."""
    rng = np.random.default_rng(0)

    def stack(L, B):
        return ((rng.standard_normal((L, PIPE["d"], PIPE["d"])) * 0.3)
                .astype(np.float32), np.zeros((L, PIPE["d"]), np.float32),
                rng.standard_normal((B, PIPE["d"])).astype(np.float32))
    return stack(PIPE["L"], PIPE["B"]), stack(PIPE["L_grad"], PIPE["B_grad"])


def scan_layers(w, b, x):
    """`repro`'s sequential stack: `tests/test_pipeline.py`'s lax.scan."""
    def body(x, p):
        return jnp.tanh(x @ p["w"] + p["b"]), None
    y, _ = jax.lax.scan(body, x, {"w": w, "b": b})
    return y


def reference(start, tokens, fwd, bwd):
    """repro's numbers: the three jitted steps per arch on each world's
    global batches, `compressed_psum` under vmap, the pipeline's
    sequential stack and its gradients, the survivors' loss."""
    out = {"steps": {}, "psum": {}}
    for arch in W.ARCHS:
        rm = RModel(r_smoke(arch))
        cfg = r_adamw.AdamWConfig(**W.OPT)

        def with_ef(p, o, r, batch, rm=rm, cfg=cfg):
            box = {}

            def compressor(g, o):
                g, box["r"] = r_comp.ef_compress_grads(g, r)
                return g, o
            p, o, m = r_make_step(rm, cfg, compressor=compressor)(p, o,
                                                                  batch)
            return p, o, box["r"], m
        fns = (jax.jit(r_make_step(rm, cfg)),
               jax.jit(r_make_step(rm, cfg, accum_steps=2)), jax.jit(with_ef))
        for world in (2, 4):
            p = jax.tree.map(jnp.asarray, start[arch])
            o = r_adamw.init(p)
            steps = []
            for s in range(3):
                batch = {"tokens": jnp.asarray(W.global_batch(
                    rm.cfg.vocab, s, world))}
                if s < 2:
                    p, o, m = fns[s](p, o, batch)
                else:
                    p, o, _, m = fns[2](p, o, r_comp.ef_init(p), batch)
                steps.append(jax.tree.map(np.asarray, (p, o, m)))
            out["steps"][arch, world] = steps
        if arch == "qwen3-1.7b":
            out["loss"] = float(jax.jit(rm.loss)(
                jax.tree.map(jnp.asarray, start[arch]),
                {"tokens": jnp.asarray(tokens)})[0])
    for world in (2, 4):
        stacked = jnp.asarray(np.stack(W.psum_inputs(world)))
        out["psum"][world] = np.asarray(jax.vmap(
            lambda a: r_comp.compressed_psum(a, "pod"),
            axis_name="pod")(stacked))
    out["pipe"] = np.asarray(scan_layers(*map(jnp.asarray, fwd)))
    w, b, x = map(jnp.asarray, bwd)
    out["pipe_grads"] = [np.asarray(g) for g in jax.grad(
        lambda w, b: jnp.sum(scan_layers(w, b, x) ** 2), argnums=(0, 1))(
            w, b)]
    return out


@pytest.fixture(scope="module")
def runs():
    """(start, repro's numbers, world → each rank's results)."""
    start = start_params()
    fwd, bwd = pipe_inputs()
    tokens = W.global_batch(512, 9, 1)[:4]
    with ThreadPoolExecutor(3) as pool:
        futures = {1: pool.submit(spawn_ranks, W.one_rank, 1, "gloo", "cpu",
                                  (start,))}
        for world in (2, 4):
            futures[world] = pool.submit(spawn_ranks, W.world_rank, world,
                                         "gloo", "cpu",
                                         (start, tokens, fwd, bwd))
        ref = reference(start, tokens, fwd, bwd)
        return start, ref, {w: f.result() for w, f in futures.items()}


# ---- W = 1 ----

@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("step", [0, 1, 2])
def test_one_rank_is_bitwise_the_one_process_step(runs, arch, step):
    got = runs[2][1][0]["dp"][arch][step]
    want = runs[2][1][0]["plain"][arch][step]
    assert got["metrics"] == want["metrics"]
    assert all(torch.equal(a, b) for a, b in zip(got["params"],
                                                 want["params"]))
    for which in ("mu", "nu"):
        assert all(torch.equal(a, b) for (a, _, _), b in
                   zip(got[which], want[which]))


# ---- W = 2 (pure data parallel) and W = 4 (base rules, (2, 2, 1)) ----

def full_moments(rank_snaps, which):
    """Each moment leaf assembled from the ranks' blocks."""
    out = []
    for i, (local, _, _) in enumerate(rank_snaps[0][which]):
        shape = [max(s[which][i][2][d][1] for s in rank_snaps)
                 for d in range(local.dim())]
        full = torch.zeros(shape)
        for s in rank_snaps:
            blk, _, bounds = s[which][i]
            full[tuple(slice(a, b) for a, b in bounds)] = blk
        out.append(full)
    return out


def leaf_gap(want_tree, got):
    want = jax.tree.leaves(want_tree)
    assert len(want) == len(got)
    return max(float(np.abs(g.numpy() - np.asarray(w)).max() /
                     max(np.abs(np.asarray(w)).max(), 1e-30))
               for w, g in zip(want, got))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("step", [0, 1, 2])
def test_dp_step_matches_repro_on_the_global_batch(runs, world, arch, step):
    """Step 0 accum 1, step 1 accum 2, step 2 the EF compressor."""
    r_params, r_opt, r_met = runs[1]["steps"][arch, world][step]
    snaps = [r["dp"][arch][step] for r in runs[2][world]]
    met = snaps[0]["metrics"]
    assert sorted(met) == sorted(r_met)
    assert met["loss"] == pytest.approx(float(r_met["loss"]), rel=1e-5)
    assert met["grad_norm"] == pytest.approx(float(r_met["grad_norm"]),
                                             rel=GRAD_NORM_RTOL[step])
    assert met["lr"] == pytest.approx(float(r_met["lr"]), rel=1e-6)
    if "tokens" in met:         # summed over the ranks: the global count
        assert met["tokens"] == float(r_met["tokens"]) == \
            W.ROWS * W.SEQ
    assert snaps[0]["step"] == int(r_opt.step) == step + 1
    assert leaf_gap(r_opt.mu, full_moments(snaps, "mu")) <= MOMENT_TOL[step]
    assert leaf_gap(r_opt.nu, full_moments(snaps, "nu")) <= MOMENT_TOL[step]
    lr_sum = sum(runs[2][world][0]["dp"][arch][s]["metrics"]["lr"]
                 for s in range(step + 1))
    want = jax.tree.leaves(r_params)
    gap = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel() for
                          w, g in zip(want, snaps[0]["params"])]) / lr_sum
    assert gap.max() <= PARAM_TOL["every"]
    assert (gap > PARAM_TOL["most"]).mean() <= PARAM_TOL["share"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_every_rank_ends_with_the_same_params(runs, world, arch):
    ranks_ = runs[2][world]
    for step in range(3):
        first = ranks_[0]["dp"][arch][step]
        for r in ranks_[1:]:
            snap = r["dp"][arch][step]
            assert snap["metrics"] == first["metrics"]
            assert all(torch.equal(a, b) for a, b in
                       zip(snap["params"], first["params"]))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_each_moment_block_is_the_opt_rules_embed_block(runs, world, arch):
    """Each rank holds, of each moment leaf, the block that `opt_rules`
    gives it: the leaf's `embed` dimension cut into `world` blocks (the
    (pod, data) index major first is the rank), where it divides; the
    whole leaf elsewhere."""
    model = build_model(get_smoke_config(arch), "cpu")
    shape, _ = W.LAYOUTS[world]
    r_rules = r_ax.opt_rules(r_ax.base_rules(True) if world == 4 else
                             r_ax.pure_dp_rules(False), True)
    axes = [(p.axes, p.shape) for _, p in leaves(model.spec)]
    n_sharded = 0
    for rank, res in enumerate(runs[2][world]):
        for which in ("mu", "nu"):
            for (blk, spec, bounds), (a, dims) in zip(
                    res["dp"][arch][2][which], axes):
                mesh = type("M", (), {"axis_names": W.NAMES,
                                      "devices": np.empty(shape)})()
                assert spec == tuple(r_ax.divisible_spec(
                    r_ax.spec_for(a, r_rules), dims, mesh))
                want = [(0, n) for n in dims]
                if "embed" in a and dims[a.index("embed")] % world == 0:
                    d, w = a.index("embed"), dims[a.index("embed")] // world
                    want[d] = (rank * w, (rank + 1) * w)
                    n_sharded += 1
                assert list(bounds) == want
                assert tuple(blk.shape) == tuple(b - a_ for a_, b in want)
    assert n_sharded > 0


@pytest.mark.parametrize("world", [2, 4])
def test_refused_layouts_raise_not_implemented(runs, world):
    """Tensor parallelism over "model", FSDP, an SSM model under a wide
    "model" axis and sequence parallelism over a wide "data" axis now
    run, and one step's loss is the one-process step's on the same
    global batch; `pure_dp_rules(True)` still raises, naming the next
    slices."""
    cases = runs[2][world][0]["refused"]
    runs_now = {"model axis", "fsdp", "ssm under model",
                "sequence parallel"}
    assert len(cases) == {2: 2, 4: 5}[world]
    for name, message, loss, one in cases:
        if name in runs_now:
            assert message is None, message
            assert loss == pytest.approx(one, rel=1e-5)
        else:
            assert message is not None and "item 11b" in message, name
            assert ax.NEXT_SLICE in message, name


# ---- compressed_psum ----

@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_is_bitwise_repro(runs, world):
    want = runs[1]["psum"][world]
    for rank, res in enumerate(runs[2][world]):
        got = res["psum"].numpy()
        assert got.dtype == np.float32
        assert got.tobytes() == want[rank].tobytes()


# ---- the pipeline (4 stages) ----

def test_pipeline_matches_the_sequential_stack(runs):
    fwd, _ = pipe_inputs()
    w, b, x = map(torch.as_tensor, fwd)
    seq = x
    for i in range(w.shape[0]):
        seq = torch.tanh(seq @ w[i] + b[i])
    for res in runs[2][4]:
        out = res["pipeline"]["out"]
        np.testing.assert_allclose(out.numpy(), seq.numpy(), atol=1e-5)
        np.testing.assert_allclose(out.numpy(), runs[1]["pipe"], atol=1e-5)


def test_pipeline_gradients_match_repro(runs):
    """Each stage's gradient lives in its own block of the stacked
    leaves; their sum over the ranks is the whole gradient."""
    gw = sum(r["pipeline"]["gw"] for r in runs[2][4])
    gb = sum(r["pipeline"]["gb"] for r in runs[2][4])
    for got, want in zip((gw, gb), runs[1]["pipe_grads"]):
        np.testing.assert_allclose(got.reshape(want.shape).numpy(), want,
                                   atol=1e-4)
    for rank, res in enumerate(runs[2][4]):
        others = [k for k in range(4) if k != rank]
        assert float(res["pipeline"]["gw"][others].abs().max()) == 0.0


# ---- elastic ----

def test_reshard_onto_the_survivors_is_bitwise(runs):
    e = runs[2][2][0]["elastic"]
    assert e["params_equal"] and all(e["params_equal"])
    assert e["mu_equal"] and all(e["mu_equal"])
    assert all(n == 0 for n in runs[2][2][1]["elastic"]["sizes"])


def test_loss_on_the_survivors_mesh_matches_repro(runs):
    got = runs[2][2][0]["elastic"]["loss"]
    assert got == pytest.approx(runs[1]["loss"], rel=1e-5)

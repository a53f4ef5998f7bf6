"""Parity of the port's training path (`repro_torch.data.pipeline`,
`optim.adamw`, `optim.compression`, `train.step`, the remat of
`models.lm`) with `repro`'s, on the CPU at smoke sizes.

Inputs come from numpy with fixed seeds; parameters from `repro`'s
`Model.init` (float32), carried over with `convert.params_from_numpy`,
and the optimizer state with `convert.adamw_state_from_numpy`.  The
reference's steps run under `jax.jit`, as its launcher runs them, each
compiled once per module.

Tolerances, each beside its assertion:

* The pipeline's batches and the int8 codes of exact halves: bitwise.
* The schedule: two float32 ulps (`torch.cos` against XLA's).
* A train step against the jitted reference: loss within rtol 1e-5,
  `lr` 1e-6, `grad_norm` 1e-4 (the reduction orders differ) and 1e-3
  through the int8 compressor; every moment leaf within `MOMENT_TOL` of
  its largest element: 1e-3 for the steps on unquantized gradients, 2e-2
  for the step through the compressor, where an element on a rounding
  boundary moves by one quantization step (1/127 of its leaf's largest).
  The reference itself moves by up to 8.4e-3 (MoE) and 6.0e-3 (Mamba2) on
  that step between its jitted and its eager run from the same state.
  Parameters: Adam's first steps move an element by about lr·sign(g), so
  they are held to the summed learning rates Σlr: every element within
  0.5·Σlr (a step taken the other way is 2·lr) and all but 0.1% of the
  tree's elements within 1e-2·Σlr (`PARAM_TOL`; the MoE model's step
  through the compressor has 0.03% beyond, the largest at 0.15·Σlr).
* Remat: the gradients of "none", "full" and "dots" bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs.base import get_smoke_config as r_smoke  # noqa: E402
from repro.data import pipeline as r_pipe  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.optim import compression as r_comp  # noqa: E402
from repro.train.step import make_train_step as r_make_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import leaves, unflatten  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import compression as t_comp  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m", "mamba2-2.7b")
# step 1: accum 1; step 2: accum 2; step 3: the error-feedback compressor
MOMENT_TOL = (1e-3, 1e-3, 2e-2)
GRAD_NORM_RTOL = (1e-4, 1e-4, 1e-3)
PARAM_TOL = dict(most=1e-2, share=1e-3, every=0.5)   # × Σlr
OPT = dict(lr=1e-2, warmup_steps=2)
BATCH, SEQ = 4, 32


def leaf_gap(want, got):
    """max over leaves of max|got − want| / max|want|."""
    want, _ = jax.tree.flatten(want)
    got, _ = tree_flatten(got)
    assert len(want) == len(got)
    gaps = []
    for w, g in zip(want, got):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert w.shape == g.shape
        gaps.append(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)))
    return max(gaps)


def params_within(want, got, lr_sum):
    """`PARAM_TOL` over every parameter leaf (see the module docstring)."""
    want, _ = jax.tree.flatten(want)
    got, _ = tree_flatten(got)
    gap = np.concatenate([
        np.abs(g.float().numpy() - np.asarray(w, np.float32)).ravel()
        for w, g in zip(want, got)]) / lr_sum
    assert gap.max() <= PARAM_TOL["every"]
    assert (gap > PARAM_TOL["most"]).mean() <= PARAM_TOL["share"]


# ---- the pipeline ----

def token_file(tmp_path, n=1000):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(5).integers(0, 700, n).astype(np.int32) \
        .tofile(path)
    return str(path)


@pytest.mark.parametrize("source", ["synthetic", "memmap"])
@pytest.mark.parametrize("shard", [0, 1])
def test_pipeline_batches_are_bitwise_the_reference(tmp_path, source, shard):
    kw = dict(batch=3, seq=16, vocab=500, seed=4, shard_id=shard,
              num_shards=2,
              token_file=token_file(tmp_path) if source == "memmap" else None)
    want = r_pipe.TokenPipeline(r_pipe.PipelineConfig(**kw))
    got = t_pipe.TokenPipeline(t_pipe.PipelineConfig(**kw))
    for step in range(25):    # 25 × 2 × 51 tokens wrap the 1000-token file
        a, b = want._batch_at(step), got._batch_at(step)
        assert b.dtype == np.int32 and b.shape == (3, 17)
        np.testing.assert_array_equal(b, a)


def test_pipeline_prefetch_and_resume_match_the_reference():
    cfg = dict(batch=2, seq=8, vocab=100, seed=1)
    ref = r_pipe.TokenPipeline(r_pipe.PipelineConfig(**cfg))
    pipe = t_pipe.TokenPipeline(t_pipe.PipelineConfig(**cfg)).start()
    it = iter(pipe)
    batches = [next(it) for _ in range(3)]
    pipe.stop()
    assert pipe.state_dict() == {"step": 3}
    for step, b in enumerate(batches):
        np.testing.assert_array_equal(b["tokens"], ref._batch_at(step))
    resumed = t_pipe.TokenPipeline(t_pipe.PipelineConfig(**cfg))
    resumed.load_state_dict({"step": 7})
    it = iter(resumed)
    for step in (7, 8):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      ref._batch_at(step))
    assert resumed.state_dict() == {"step": 8}   # counted on the next draw


# ---- AdamW ----

@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10000, 20000])
def test_schedule_matches_repro(step):
    cfg = adamw.AdamWConfig(lr=3e-3)
    want = np.float32(r_adamw.schedule(r_adamw.AdamWConfig(lr=3e-3),
                                       jnp.asarray(step, jnp.int32)))
    got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    # two float32 ulps: torch.cos and XLA's cos may round apart
    assert abs(float(got) - float(want)) <= 2 * np.spacing(want)


def random_tree(seed, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (8, 16), "b": {"c": (5,), "d": (3, 4, 2)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        x = (rng.standard_normal(s) * scale).astype(np.float32)
        return torch.tensor(x).to(dtype)
    return make(shapes)


def to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


def test_global_norm_over_mixed_leaves_matches_repro():
    tree = {"x": random_tree(0, torch.bfloat16),
            "y": random_tree(1, torch.float32)}
    want = float(r_adamw.global_norm(to_jax(tree)))
    got = adamw.global_norm(tree)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)   # sum order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clipped", [False, True])
def test_update_matches_repro(dtype, clipped):
    """5 steps from the same tree; the gradients' norm is ~200 (clipped to
    1) or ~0.2 (not clipped)."""
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=8)
    params = random_tree(0, dtype)
    r_params = to_jax(params)
    state, r_state = adamw.init(params), r_adamw.init(r_params)
    for step in range(5):
        grads = random_tree(10 + step, dtype, 20.0 if clipped else 0.02)
        r_params, r_state, r_met = r_adamw.update(
            r_adamw.AdamWConfig(**cfg), to_jax(grads), r_state, r_params)
        params, state, met = adamw.update(adamw.AdamWConfig(**cfg), grads,
                                          state, params)
        assert (float(r_met["grad_norm"]) > 1) == clipped
        assert float(met["grad_norm"]) == pytest.approx(
            float(r_met["grad_norm"]), rel=1e-6)
        assert float(met["lr"]) == float(r_met["lr"])
        assert int(state.step) == int(r_state.step) == step + 1
        assert state.step.dtype == torch.int32
        # float32: a few ulps of each leaf's largest element (fused or
        # unfused products); bfloat16 parameters: one bf16 rounding step
        # of the largest element, where float32 results straddle a tie
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
        assert leaf_gap(r_params, params) <= tol
        assert leaf_gap(r_state.mu, state.mu) <= 1e-6
        assert leaf_gap(r_state.nu, state.nu) <= 1e-6
        assert all(p.dtype == dtype for p in tree_flatten(params)[0])
        assert all(m.dtype == torch.float32
                   for m in tree_flatten(state.mu)[0])


def test_update_writes_in_place_and_keeps_the_state_layout():
    params = random_tree(0, torch.bfloat16)
    state = adamw.init(params)
    before = [p.data_ptr() for p in tree_flatten(params)[0]]
    new, new_state, _ = adamw.update(adamw.AdamWConfig(), random_tree(
        1, torch.bfloat16), state, params)
    assert [p.data_ptr() for p in tree_flatten(new)[0]] == before
    assert new_state.mu is state.mu and new_state.nu is state.nu
    assert adamw.AdamWState._fields == r_adamw.AdamWState._fields
    assert str(tree_flatten((params, new_state))[1]) == str(
        jax.tree.structure((to_jax(params), r_adamw.init(to_jax(params)))))


def test_adamw_state_crosses_over_from_repro():
    model = build_model(get_smoke_config("qwen3-1.7b"), "cpu")
    rng = np.random.default_rng(1)

    def tree():
        return unflatten(
            (path, rng.standard_normal(p.shape).astype(np.float32))
            for path, p in leaves(model.spec))
    r_state = r_adamw.AdamWState(np.int32(7), tree(), tree())
    state = convert.adamw_state_from_numpy(r_state, model.spec, "cpu")
    assert state.step.dtype == torch.int32 and int(state.step) == 7
    assert leaf_gap(r_state.mu, state.mu) == 0
    assert leaf_gap(r_state.nu, state.nu) == 0
    with pytest.raises(ValueError, match="integer scalar"):
        convert.adamw_state_from_numpy(
            (np.zeros(2), r_state.mu, r_state.nu), model.spec, "cpu")


# ---- compression ----

def ef_compressor(box):
    """The error-feedback compressor as `make_train_step` takes it: the
    residual lives in `box["r"]`, beside the step."""
    def compressor(grads, opt_state):
        grads, box["r"] = t_comp.ef_compress_grads(grads, box["r"])
        return grads, opt_state
    return compressor


def test_quantize_rounds_exact_halves_to_even():
    # amax 127 (+1e-12, below its ulp) makes the scale exactly 1, so x/scale
    # keeps the halves exact
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                 np.float32)
    q, scale = t_comp._quantize(torch.from_numpy(x))
    rq, rscale = r_comp._quantize(jnp.asarray(x))
    assert float(scale) == float(rscale) == 1.0
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(q.numpy(), [127, 0, 2, 2, 0, -2, 4, -126])
    np.testing.assert_array_equal(t_comp._dequantize(q, scale).numpy(),
                                  np.asarray(r_comp._dequantize(rq, rscale)))


def test_ef_compress_grads_matches_repro_over_20_steps():
    rng = np.random.default_rng(3)
    shapes = {"w": (64, 64), "b": (17,)}
    res = t_comp.ef_init({k: torch.zeros(s) for k, s in shapes.items()})
    r_res = r_comp.ef_init({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(20):
        g = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
             for k, s in shapes.items()}
        gc, res = t_comp.ef_compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, res)
        r_gc, r_res = r_comp.ef_compress_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, r_res)
        # float32 add, max, divide, round, multiply: the same IEEE steps;
        # a fused multiply-subtract in XLA would move the residual by an ulp
        assert leaf_gap(r_gc, gc) <= 1e-6
        assert leaf_gap(r_res, res) <= 1e-6


def test_ef_residual_preserves_signal_as_in_repro():
    """`tests/test_reliability.py`'s case on the port, same gradients."""
    key = jax.random.PRNGKey(0)
    res = t_comp.ef_init({"w": torch.zeros(64, 64)})
    r_res = r_comp.ef_init({"w": jnp.zeros((64, 64))})
    for i in range(20):
        g = np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                         (64, 64))) * 1e-3
        _, res = t_comp.ef_compress_grads({"w": torch.from_numpy(g)}, res)
        _, r_res = r_comp.ef_compress_grads({"w": jnp.asarray(g)}, r_res)
    assert float(res["w"].abs().max()) < 1e-3
    assert leaf_gap(r_res, res) <= 1e-6


def test_compressed_training_still_converges_as_in_repro():
    """`tests/test_reliability.py`'s compressed training on the port: 8
    steps on a fixed batch (bf16 parameters, as there), losses within
    one bfloat16 rounding step of the reference's, and falling."""
    key = jax.random.PRNGKey(0)
    rm = RModel(r_smoke("qwen3-1.7b"))
    rp = rm.init(key)
    model = build_model(get_smoke_config("qwen3-1.7b"), "cpu")
    params = convert.params_from_numpy(jax.tree.map(np.asarray, rp),
                                       model.spec, "cpu", torch.bfloat16)
    tokens = np.array(jax.random.randint(key, (4, 32), 0, 512))
    r_opt_cfg = r_adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)

    @jax.jit
    def r_step(params, opt, res):
        (loss, _), grads = jax.value_and_grad(
            rm.loss, has_aux=True)(params, {"tokens": jnp.asarray(tokens)})
        grads, res = r_comp.ef_compress_grads(grads, res)
        params, opt, _ = r_adamw.update(r_opt_cfg, grads, opt, params)
        return params, opt, res, loss

    step = make_train_step(model, opt_cfg, compressor=ef_compressor(
        {"r": t_comp.ef_init(params)}))
    r_state = (rp, r_adamw.init(rp), r_comp.ef_init(rp))
    opt = adamw.init(params)
    r_losses, losses = [], []
    for _ in range(8):
        *r_state, r_loss = r_step(*r_state)
        r_losses.append(float(r_loss))
        params, opt, met = step(params, opt, {"tokens": torch.as_tensor(
            tokens)})
        losses.append(float(met["loss"]))
    assert r_losses[-1] < r_losses[0] and losses[-1] < losses[0]
    # bf16 parameters: the two packages' bf16 products round apart and
    # the gap grows with the steps (to 1.3e-3 by the eighth); the losses
    # stay within one bfloat16 rounding step, 2⁻⁸ relative
    np.testing.assert_allclose(losses, r_losses, rtol=2.0 ** -8)


# ---- the train step ----

@pytest.fixture(scope="module")
def ref_runs():
    """arch → the reference's three jitted steps from its float32 init:
    [(params, opt_state, metrics) as numpy], plus the start and batches."""
    out = {}
    for arch in ARCHS:
        rm = RModel(r_smoke(arch))
        params = rm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
        opt = r_adamw.init(params)
        start = jax.tree.map(np.asarray, (params, opt))
        cfg = r_adamw.AdamWConfig(**OPT)
        pipe = r_pipe.TokenPipeline(r_pipe.PipelineConfig(BATCH, SEQ,
                                                          rm.cfg.vocab))
        batches = [pipe._batch_at(s) for s in range(3)]

        def with_ef(p, o, r, b):
            box = {}

            def compressor(g, o):
                g, box["r"] = r_comp.ef_compress_grads(g, r)
                return g, o
            p, o, m = r_make_step(rm, cfg, compressor=compressor)(p, o, b)
            return p, o, box["r"], m

        steps = []
        p, o = params, opt
        for s, fn in enumerate((r_make_step(rm, cfg),
                                r_make_step(rm, cfg, accum_steps=2))):
            p, o, m = jax.jit(fn)(p, o, {"tokens": jnp.asarray(batches[s])})
            steps.append(jax.tree.map(np.asarray, (p, o, m)))
        p, o, _, m = jax.jit(with_ef)(p, o, r_comp.ef_init(p),
                                      {"tokens": jnp.asarray(batches[2])})
        steps.append(jax.tree.map(np.asarray, (p, o, m)))
        out[arch] = (start, batches, steps)
    return out


@pytest.fixture(scope="module")
def port_runs(ref_runs):
    """arch → the port's three steps from the same state and batches."""
    out = {}
    for arch, ((r_params, r_opt), batches, _) in ref_runs.items():
        model = build_model(get_smoke_config(arch), "cpu")
        params = convert.params_from_numpy(r_params, model.spec, "cpu")
        opt = convert.adamw_state_from_numpy(r_opt, model.spec, "cpu")
        cfg = adamw.AdamWConfig(**OPT)
        fns = (make_train_step(model, cfg),
               make_train_step(model, cfg, accum_steps=2),
               make_train_step(model, cfg, compressor=ef_compressor(
                   {"r": t_comp.ef_init(params)})))
        steps = []
        for fn, b in zip(fns, batches):
            params, opt, met = fn(params, opt, {"tokens": torch.as_tensor(b)})
            steps.append(tuple(
                tree_flatten(x)[1].unflatten([t.clone() for t in
                                              tree_flatten(x)[0]])
                for x in (params, opt, met)))
        out[arch] = steps
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", [0, 1, 2])
def test_train_step_matches_repro(ref_runs, port_runs, arch, step):
    r_params, r_opt, r_met = ref_runs[arch][2][step]
    params, opt, met = port_runs[arch][step]
    assert sorted(met) == sorted(r_met)
    if step == 1:
        assert sorted(met) == ["grad_norm", "loss", "lr"]  # accum: loss only
    assert float(met["loss"]) == pytest.approx(float(r_met["loss"]),
                                               rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(
        float(r_met["grad_norm"]), rel=GRAD_NORM_RTOL[step])
    assert float(met["lr"]) == pytest.approx(float(r_met["lr"]), rel=1e-6)
    assert int(opt.step) == int(r_opt.step) == step + 1
    assert leaf_gap(r_opt.mu, opt.mu) <= MOMENT_TOL[step]
    assert leaf_gap(r_opt.nu, opt.nu) <= MOMENT_TOL[step]
    params_within(r_params, params, sum(float(port_runs[arch][s][2]["lr"])
                                        for s in range(step + 1)))


def test_accumulated_gradients_are_float32():
    """With bf16 parameters one step's gradients keep bf16 and the
    accumulated ones are float32, as the reference's float32 zeros make
    them: seen by the compressor between the gradients and the update."""
    model = build_model(get_smoke_config("qwen3-1.7b"), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.as_tensor(t_pipe.TokenPipeline(
        t_pipe.PipelineConfig(4, 16, 512))._batch_at(0))}
    seen = {}

    def spy(grads, opt_state):
        seen[len(seen)] = {g.dtype for g in tree_flatten(grads)[0]}
        return grads, opt_state
    for accum in (1, 2):
        make_train_step(model, adamw.AdamWConfig(), accum, spy)(
            params, adamw.init(params), batch)
    assert seen == {0: {torch.bfloat16}, 1: {torch.float32}}


class MatmulCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n["mm"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.n["bmm"] += 1
        return func(*args, **(kwargs or {}))


def grads_under(arch, remat):
    """(gradients, matrix products run by the backward pass) of one loss."""
    base = get_smoke_config(arch)
    model = build_model(dataclasses.replace(base, remat=remat), "cpu")
    params = build_model(base, "cpu").init(torch.Generator().manual_seed(0),
                                           torch.float32)
    flat, treedef = tree_flatten(params)
    leaves = [p.requires_grad_() for p in flat]
    tokens = np.random.default_rng(0).integers(0, base.vocab, (2, 33))
    loss, _ = model.loss(treedef.unflatten(leaves),
                         {"tokens": torch.as_tensor(tokens,
                                                    dtype=torch.int32)})
    count = MatmulCount()
    with count:
        grads = torch.autograd.grad(loss, leaves)
    return grads, count.n


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bitwise_equal(arch):
    """"full" recomputes every product of a layer in the backward pass,
    "dots" only the products with batch dimensions (attention, experts,
    groups), "none" none; the gradients are the same bits."""
    none, n_none = grads_under(arch, "none")
    for remat in ("full", "dots"):
        grads, n = grads_under(arch, remat)
        assert all(torch.equal(a, b) for a, b in zip(none, grads)), remat
        if remat == "full":
            assert n["mm"] > n_none["mm"] and n["bmm"] > n_none["bmm"]
        else:
            assert n["mm"] == n_none["mm"] and n["bmm"] > n_none["bmm"]


def test_remat_is_off_without_grad_mode(monkeypatch):
    """Scoring and serving run no checkpoint, whatever `cfg.remat`."""
    def fail(*args, **kwargs):
        raise AssertionError("checkpoint called without grad mode")
    monkeypatch.setattr(t_lm.ckpt, "checkpoint", fail)
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), remat="full")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), torch.float32)
    with torch.no_grad():
        model.loss(params, {"tokens": torch.zeros(1, 8, dtype=torch.int64)})
    with pytest.raises(ValueError, match="unknown remat"):
        build_model(dataclasses.replace(cfg, remat="some"), "cpu").loss(
            params, {"tokens": torch.zeros(1, 8, dtype=torch.int64)})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_raises_with_the_kernels_on(arch):
    """The kernels have no backward: the step raises, with no fallback."""
    cfg = dataclasses.replace(get_smoke_config(arch), use_flash_kernel=True)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), torch.float32)
    step = make_train_step(model, adamw.AdamWConfig())
    with pytest.raises(RuntimeError, match="has no backward"):
        step(params, adamw.init(params),
             {"tokens": torch.zeros(2, 16, dtype=torch.int32)})

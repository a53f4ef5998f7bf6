"""Parity of the port's other dense and MoE configurations and of the
hybrid family with `repro`'s: qwen3-14b, phi4-mini-3.8b, nemotron-4-15b
(squared-ReLU), moonshot-v1-16b-a3b (64 experts, top-6) and
jamba-1.5-large-398b (Mamba + attention periods with MoE), each at its
`smoke_config()`, on the CPU.

Parameters come from `repro`'s `Model.init` (float32) and cross over
through `convert.params_from_numpy`, the hybrid's nested
``blocks/sub{i}/…`` leaves included; tokens come from numpy with fixed
seeds.  `repro` runs op by op with `use_flash_kernel=False` (its
smoke configurations' setting), as its own tests run it; the port runs
with the flag on, where the CPU takes each kernel's plain version, and
off.

Tolerances:

* float32, rtol = atol = 1e-5 (`TOL`, as the earlier families use):
  losses, the dense and MoE configurations' caches, and each hybrid
  sub-layer from the reference's own input (`LAYER_RTOL` = 1e-5 of the
  output's largest magnitude).  Logits add 1e-5 of the largest |logit|
  to the atol (`LOGIT_RTOL`): a float32 sum errs in proportion to the
  magnitudes it adds, not to its result, and small logits are sums of
  large terms (measured, decode from equal caches: 2.0e-5 on logits up
  to 2.8 for nemotron's squared ReLU, 1.2e-5 for moonshot).
* The hybrid's logits and SSM states carried through the whole stack:
  atol 1e-3 (`HYBRID_TOL`, measured 2.9e-4 on logits up to 4.0).  Its
  smoke attention has no qk-norm, and the reference's initializer scales
  q and k by 1/sqrt(heads) (the fan-in of a stacked ``[d, H, hd]`` leaf
  is its second-to-last axis), so its scores reach O(50) and the softmax
  is nearly an argmax: a float32 reordering of ~1e-6 relative in the
  layer before moves the attention block's output ~100× as much.
  `test_hybrid_attention_amplifies_float32_noise_in_repro` shows the
  reference alone doing so; every sub-layer from the reference's input
  stays within `LAYER_RTOL`.
* bfloat16 K/V caches within one bfloat16 ulp plus the float32 atol
  (|a − b| ≤ 2⁻⁷·|b| + 1e-5), or plus `HYBRID_TOL` in the hybrid.
* Token streams and `stats` of the serving engine: exact.
* Jamba's train step, two steps through `make_train_step` against
  `jax.jit` of `repro`'s, each from the reference's state before it
  (`convert.adamw_state_from_numpy`): the loss within rtol 1e-5, `lr`
  1e-6, every moment leaf within 1e-3 of its largest element, every
  parameter within 0.5·lr and all but 0.1% within 1e-2·lr
  (tests/test_torch_train.py's tolerances).  Each step starts from the
  reference's state because the same attention amplifies float32 noise
  in the gradients (at equal parameters they differ by up to 1.0e-4 of
  a leaf's largest, at q and k; 5e-6 for the Mamba2 smoke model), and an
  element whose gradient lies within that noise of zero takes Adam's
  ±lr first step either way: carried into step 2, that moved 0.31% of
  the parameters beyond 1e-2·lr.  Remat "full" and "none" give the same
  gradients, bitwise.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import base as r_base  # noqa: E402
from repro.data import pipeline as r_pipe  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.serve.engine import Request as RRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro.train.step import make_train_step as r_make_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

ARCHS = ("qwen3-14b", "phi4-mini-3.8b", "nemotron-4-15b",
         "moonshot-v1-16b-a3b", "jamba-1.5-large-398b")
HYBRID = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_RTOL = 1e-5
HYBRID_TOL = dict(rtol=1e-5, atol=1e-3)
LAYER_RTOL = 1e-5
# tests/test_launchers.py::test_serve_launcher's traffic
SERVE_KW = dict(batch_slots=2, max_seq=48, prompt_len=8)
OPT = dict(lr=1e-2, warmup_steps=2)
MOMENT_TOL = 1e-3
PARAM_TOL = dict(most=1e-2, share=1e-3, every=0.5)   # × lr


class Jitted:
    """`repro`'s Model with its entry points under `jax.jit`: the same
    functions compiled whole (op by op, the smoke Jamba takes seconds per
    call to dispatch); `ServeEngine` takes it in the Model's place."""

    def __init__(self, rm):
        self.cfg = rm.cfg
        self.init_caches = rm.init_caches
        self.loss = jax.jit(rm.loss)
        self.prefill = jax.jit(rm.prefill, static_argnums=2)
        self.decode_step = jax.jit(rm.decode_step)


@pytest.fixture(scope="module")
def ref():
    """arch → (repro's Model, jitted, its float32 params), made once per
    arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rm = RModel(r_base.get_smoke_config(arch))
            init = jax.jit(lambda key: rm.init(key, dtype=jnp.float32))
            cache[arch] = Jitted(rm), init(jax.random.PRNGKey(0))
        return cache[arch]
    return get


def port(arch, params, flash=True, **overrides):
    cfg = dataclasses.replace(t_base.get_smoke_config(arch),
                              use_flash_kernel=flash, **overrides)
    model = build_model(cfg, "cpu")
    tree = jax.tree.map(np.asarray, params)
    return model, convert.params_from_numpy(tree, model.spec, "cpu")


def tol(arch):
    return HYBRID_TOL if arch == HYBRID else TOL


def logits_close(arch, got, want):
    """Logits within `tol(arch)` plus LOGIT_RTOL of the largest |logit|."""
    want = np.asarray(want, np.float32)
    kw = dict(tol(arch))
    kw["atol"] += LOGIT_RTOL * float(np.abs(want).max())
    close(got, want, **kw)


def close(got, want, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(kw or TOL))


def close_bf16(got, want, atol=1e-5):
    """One bfloat16 rounding step of `want`, plus `atol`."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + atol)


def tokens(seed, B, S):
    return np.random.default_rng(seed).integers(0, 512, (B, S))


def cache_items(t_caches, r_caches):
    """(path, port leaf, reference leaf) of two cache trees, after
    checking that they have the same structure: the same dict keys, the
    same NamedTuple types by name and fields."""
    if isinstance(r_caches, dict):
        assert isinstance(t_caches, dict)
        assert sorted(t_caches) == sorted(r_caches)
        for k in sorted(r_caches):
            for path, a, b in cache_items(t_caches[k], r_caches[k]):
                yield f"{k}/{path}", a, b
        return
    assert type(t_caches).__name__ == type(r_caches).__name__
    assert t_caches._fields == r_caches._fields
    for name, a, b in zip(r_caches._fields, t_caches, r_caches):
        yield name, a, b


def caches_close(arch, t_caches, r_caches):
    atol = tol(arch)["atol"]
    n = 0
    for path, a, b in cache_items(t_caches, r_caches):
        assert tuple(a.shape) == b.shape, path
        if b.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16, path
            close_bf16(a, b, atol)
        else:
            assert a.dtype == torch.float32, path
            close(a, b, **tol(arch))
        n += 1
    return n


# ---- configurations ----

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_repro_s_and_count_its_parameters(arch):
    """`CONFIG` and `smoke_config()` equal the reference's field by field
    (`fsdp` included); the full spec's parameter count without
    materializing it; `build_model` on the smoke config."""
    for name in ("get_config", "get_smoke_config"):
        got, want = getattr(t_base, name)(arch), getattr(r_base, name)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert t_base.get_config(arch).fsdp == (arch == HYBRID)
    assert build_model(t_base.get_config(arch), "cpu").n_params() == \
        RModel(r_base.get_config(arch)).n_params()
    assert build_model(t_base.get_smoke_config(arch), "cpu").n_params() == \
        RModel(r_base.get_smoke_config(arch)).n_params()


def test_hybrid_layer_kinds_and_spec_are_repro_s():
    """The period of the published Jamba (attention at 3 of 8, MoE on the
    odd sub-layers) and of its smoke config, and every spec leaf."""
    for cfg in (t_base.get_config(HYBRID), t_base.get_smoke_config(HYBRID)):
        assert t_lm._layer_kinds(cfg) == r_lm._layer_kinds(cfg)
    assert t_lm._layer_kinds(t_base.get_config(HYBRID))[3] == ("attn", "moe")
    assert [f for _, f in t_lm._layer_kinds(t_base.get_config(HYBRID))] == \
        ["mlp", "moe"] * 4
    cfg = t_base.get_smoke_config(HYBRID)
    r_spec = jax.tree.map(lambda p: p.shape, r_lm.lm_spec(cfg),
                          is_leaf=lambda p: hasattr(p, "shape"))
    t_spec = {path: p.shape for path, p in
              convert.leaves(t_lm.lm_spec(cfg))}
    flat = dict(convert._flatten(r_spec))
    assert flat == t_spec
    assert set(t_lm.lm_spec(cfg)["blocks"]) == {"sub0", "sub1", "sub2",
                                                 "sub3"}
    assert t_spec["blocks/sub1/mixer/q"][0] == cfg.n_layers // 4


def test_mlp_spec_takes_a_d_ff():
    cfg = t_base.get_smoke_config("nemotron-4-15b")
    assert t_layers.mlp_spec(cfg)["wi"].shape == (96, 256)
    assert t_layers.mlp_spec(cfg, 40)["wo"].shape == (40, 96)
    assert r_layers.mlp_spec(cfg, 40)["wo"].shape == (40, 96)


def test_sq_relu_bf16_rounds_as_repro():
    """`jnp.square(jax.nn.relu(·))` in bf16 rounds once, as
    `torch.square(F.relu(·))` does: bitwise on the same pre-activations,
    eagerly and under `jit`."""
    a = np.random.default_rng(3).standard_normal((512, 256)) \
        .astype(np.float32) * 3
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    want = np.asarray(jnp.square(jax.nn.relu(ja)), np.float32)
    jitted = jax.jit(lambda v: jnp.square(jax.nn.relu(v)))(ja)
    np.testing.assert_array_equal(np.asarray(jitted, np.float32), want)
    got = torch.square(torch.relu(torch.from_numpy(a).to(torch.bfloat16)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---- the scoring forward ----

@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_repro(ref, arch, flash):
    """The port with the flag on (the flash and SSD kernels' plain
    versions, the gating op's) and off, each against `repro`'s loss with
    the flag off (the kernels' function; the plain versions are held to
    its Pallas kernels in tests/test_torch_flash_attention.py,
    test_torch_ssd_scan.py and test_torch_moe_gating.py)."""
    rm, r_params = ref(arch)
    model, params = port(arch, r_params, flash)
    batch = tokens(11, 2, 24)
    r_loss, r_met = rm.loss(r_params, {"tokens": jnp.asarray(batch)})
    with torch.no_grad():
        loss, met = model.loss(params, {"tokens": torch.from_numpy(batch)})
    close(loss, r_loss)
    close(met["aux_loss"], r_met["aux_loss"])
    assert float(met["tokens"]) == float(r_met["tokens"]) == 2 * 23
    assert (float(met["aux_loss"]) > 0) == (arch in ("moonshot-v1-16b-a3b",
                                                     HYBRID))


def test_hybrid_sub_layers_match_repro_from_its_input(ref):
    """Each of the smoke Jamba's 8 sub-layers (2 periods × mamba/mlp,
    attn/moe, mamba/mlp, mamba/moe) on the reference's own input: output
    within LAYER_RTOL of its largest magnitude, aux losses at TOL."""
    _, r_params = ref(HYBRID)
    model, params = port(HYBRID, r_params, flash=False)
    cfg = model.cfg
    x = r_layers.embed_tokens(r_params["embed"], jnp.asarray(tokens(4, 2, 24)))
    pos = jnp.broadcast_to(jnp.arange(24)[None], (2, 24))

    @functools.cache
    def block(mixer, ffn):
        def fn(p, x, pos):
            y, _, aux = r_lm._apply_block(cfg, mixer, ffn, p, x,
                                          positions=pos, mode="train")
            return y, aux
        return jax.jit(fn)
    n = 0
    for period in range(2):
        p_t = t_lm._layer(params["blocks"], period)
        for i, (mixer, ffn) in enumerate(r_lm._layer_kinds(cfg)):
            p_r = jax.tree.map(lambda a: a[period],
                               r_params["blocks"][f"sub{i}"])
            y_r, aux_r = block(mixer, ffn)(p_r, x, pos)
            with torch.no_grad():
                y_t, _, aux_t = t_lm._apply_block(
                    cfg, mixer, ffn, p_t[f"sub{i}"],
                    torch.from_numpy(np.array(x)),
                    positions=torch.from_numpy(np.array(pos)), mode="train")
            want = np.asarray(y_r)
            assert np.abs(y_t.numpy() - want).max() <= \
                LAYER_RTOL * np.abs(want).max()
            if ffn == "moe":
                close(aux_t, aux_r)
            else:
                assert aux_t is None and float(aux_r) == 0.0
            x, n = y_r, n + 1
    assert n == cfg.n_layers


def test_hybrid_attention_amplifies_float32_noise_in_repro(ref):
    """Why HYBRID_TOL: in `repro` alone, the smoke Jamba's first attention
    block moves its output by more than 30× a perturbation of its input of
    the size of a float32 reordering (1e-6 of the input's largest
    magnitude), and the logits move past TOL's atol."""
    rm, r_params = ref(HYBRID)
    cfg = rm.cfg
    toks = jnp.asarray(tokens(0, 2, 24))
    x0 = r_layers.embed_tokens(r_params["embed"], toks)
    pos = jnp.broadcast_to(jnp.arange(24)[None], (2, 24))
    sub = lambda i: jax.tree.map(lambda a: a[0], r_params["blocks"][f"sub{i}"])
    x1, _, _ = r_lm._apply_block(cfg, "mamba", "mlp", sub(0), x0,
                                 positions=pos, mode="train")
    eps = np.random.default_rng(1).standard_normal(x1.shape) \
        .astype(np.float32)
    eps *= 1e-6 * float(jnp.abs(x1).max()) / np.abs(eps).max()

    def attn_block(x):
        h = r_layers.rms_norm(x, sub(1)["norm1"], cfg.norm_eps)
        return x + r_lm.attn.attention(cfg, sub(1)["mixer"], h, pos)
    attn_block = jax.jit(attn_block)
    moved = float(jnp.abs(attn_block(x1 + eps) - attn_block(x1)).max())
    assert moved > 30 * np.abs(eps).max()

    def logits(x):
        for period in range(2):
            for i, (mixer, ffn) in enumerate(r_lm._layer_kinds(cfg)):
                if (period, i) == (0, 0):
                    continue
                p = jax.tree.map(lambda a: a[period],
                                 r_params["blocks"][f"sub{i}"])
                x, _, _ = r_lm._apply_block(cfg, mixer, ffn, p, x,
                                            positions=pos, mode="train")
        return r_layers.unembed(cfg, r_params["embed"], x, cfg.norm_eps)
    logits = jax.jit(logits)
    gap = float(jnp.abs(logits(x1 + eps) - logits(x1)).max())
    assert TOL["atol"] < gap <= HYBRID_TOL["atol"]


# ---- serving ----

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match_repro(ref, arch):
    """Prefill logits and every cache leaf (the hybrid's dict of
    `KVCache` and `SSMCache` by sub-layer, as the reference's), then 4
    decode steps, each from the reference's caches carried over with
    `convert.caches_from_numpy`: a K/V element that rounded to the other
    bfloat16 neighbour in prefill would otherwise move every later step
    by far more than TOL."""
    rm, r_params = ref(arch)
    model, params = port(arch, r_params)
    batch = tokens(1, 2, 10)
    l_r, c_r = rm.prefill(r_params, {"tokens": jnp.asarray(batch)}, 32)
    l_t, c_t = model.prefill(params, {"tokens": torch.from_numpy(batch)}, 32)
    assert l_t.dtype == torch.float32 and l_t.shape == (2, 512)
    logits_close(arch, l_t, l_r)
    n_leaves = caches_close(arch, c_t, c_r)
    assert n_leaves == (8 if arch == HYBRID else 2)
    if arch == HYBRID:
        assert [type(c_t[k]).__name__ for k in sorted(c_t)] == \
            ["SSMCache", "KVCache", "SSMCache", "SSMCache"]
        assert c_t["sub1"].k.shape == (2, 2, 32, 2, 16)     # [periods, …]
        assert c_t["sub0"].h.dtype == torch.float32
    for step in range(4):
        tok = np.asarray(jnp.argmax(l_r, -1))[:, None]
        c_t = convert.caches_from_numpy(jax.tree.map(np.asarray, c_r), c_t)
        l_r, c_r = rm.decode_step(r_params, jnp.asarray(tok), 10 + step, c_r)
        l_t, c_t = model.decode_step(params, torch.tensor(tok), 10 + step,
                                     c_t)
        logits_close(arch, l_t, l_r)
        caches_close(arch, c_t, c_r)


def test_caches_from_numpy_checks_the_tree(ref):
    rm, r_params = ref(HYBRID)
    model, _ = port(HYBRID, r_params)
    like = model.init_caches(2, 16)
    tree = jax.tree.map(np.asarray, rm.init_caches(2, 16))
    got = convert.caches_from_numpy(tree, like)
    assert [(type(got[k]).__name__, got[k].conv.dtype, got[k].h.dtype)
            for k in ("sub0", "sub2")] == \
        [("SSMCache", torch.bfloat16, torch.float32)] * 2
    assert got["sub1"].k.dtype == torch.bfloat16
    with pytest.raises(KeyError, match="sub-layers"):
        convert.caches_from_numpy({"sub0": tree["sub0"]}, like)
    with pytest.raises(ValueError, match="shape"):
        convert.caches_from_numpy(
            tree, model.init_caches(2, 8))


def serve(engine, req_cls, n=5, prompt=8, new=8):
    rng = np.random.default_rng(0)
    reqs = [req_cls(rid, rng.integers(0, 512, size=prompt),
                    max_new_tokens=new) for rid in range(n)]
    for r in reqs:
        engine.submit(r)
    steps = engine.run_until_drained()
    return steps, [r.output for r in reqs], [r.done for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_repro(ref, arch):
    """tests/test_launchers.py's traffic (5 requests, 2 slots, 8 new
    tokens): the same token streams and stats; the engine copies the
    hybrid's cache dict into its slots leaf by leaf."""
    rm, r_params = ref(arch)
    r_engine = RServeEngine(rm, r_params, **SERVE_KW)
    r_out = serve(r_engine, RRequest)
    model, params = port(arch, r_params)
    engine = t_engine.ServeEngine(model, params, **SERVE_KW)
    assert serve(engine, t_engine.Request) == r_out
    assert engine.stats == r_engine.stats
    assert engine.stats["prefills"] == 5
    assert all(r_out[2])


def test_engine_cache_pairs_walk_any_tree():
    a = {"sub0": t_lm.attn.KVCache(torch.zeros(1), torch.ones(1)),
         "sub1": t_lm.ssm_lib.SSMCache(torch.zeros(2), torch.ones(2))}
    pairs = list(t_engine._cache_pairs(a, a))
    assert [x is y for x, y in pairs] == [True] * 4
    with pytest.raises(ValueError, match="cache trees differ"):
        list(t_engine._cache_pairs(a, {"sub0": a["sub0"]}))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_each_architecture_on_the_cpu(capsys, arch):
    stats = t_launch.main(["--arch", arch, "--requests", "3", "--slots",
                           "2", "--max-new", "4", "--prompt-len", "8",
                           "--max-seq", "32", "--device", "cpu"])
    assert stats["prefills"] == 3
    assert stats["tokens"] >= 3 * (8 + 3)
    assert f"arch={arch} device=cpu" in capsys.readouterr().out


# ---- training the hybrid ----

@pytest.fixture(scope="module")
def hybrid_ref_steps(ref):
    """Two steps of the smoke Jamba through `jax.jit` of `repro`'s step
    from its float32 init: [(params, opt_state) before step 1, after step
    1, after step 2] as numpy, the batches and each step's metrics."""
    _, params = ref(HYBRID)
    state = (params, r_adamw.init(params))
    step = jax.jit(r_make_step(RModel(r_base.get_smoke_config(HYBRID)),
                               r_adamw.AdamWConfig(**OPT)))
    pipe = r_pipe.TokenPipeline(r_pipe.PipelineConfig(4, 16, 512))
    batches = [pipe._batch_at(s) for s in range(2)]
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for b in batches:
        *state, m = step(*state, {"tokens": jnp.asarray(b)})
        states.append(jax.tree.map(np.asarray, tuple(state)))
        metrics.append(jax.tree.map(np.asarray, m))
    return states, batches, metrics


def leaf_gap(want, got):
    """max over leaves of max|got − want| / max|want|."""
    want, _ = jax.tree.flatten(want)
    got, _ = tree_flatten(got)
    assert len(want) == len(got)
    return max(float(np.abs(g.float().numpy() - np.asarray(w)).max()
                     / max(np.abs(np.asarray(w)).max(), 1e-30))
               for w, g in zip(want, got))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_hybrid_train_steps_match_repro(hybrid_ref_steps, remat):
    """Each of the two steps from the reference's state before it,
    carried over with `convert`: the second from moments and a step count
    of 1, so the bias corrections and the moments' decay are exercised."""
    states, batches, metrics = hybrid_ref_steps
    model = build_model(dataclasses.replace(
        t_base.get_smoke_config(HYBRID), remat=remat), "cpu")
    step = make_train_step(model, adamw.AdamWConfig(**OPT))
    for s in range(2):
        r_params, r_opt = states[s]
        params = convert.params_from_numpy(r_params, model.spec, "cpu")
        opt = convert.adamw_state_from_numpy(r_opt, model.spec, "cpu")
        params, opt, met = step(params, opt,
                                {"tokens": torch.as_tensor(batches[s])})
        w_params, w_opt = states[s + 1]
        assert float(met["loss"]) == pytest.approx(
            float(metrics[s]["loss"]), rel=1e-5)
        assert float(met["lr"]) == pytest.approx(float(metrics[s]["lr"]),
                                                 rel=1e-6)
        assert int(opt.step) == s + 1
        assert leaf_gap(w_opt.mu, opt.mu) <= MOMENT_TOL
        assert leaf_gap(w_opt.nu, opt.nu) <= MOMENT_TOL
        want, _ = jax.tree.flatten(w_params)
        got, _ = tree_flatten(params)
        gap = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel()
                              for w, g in zip(want, got)]) / float(met["lr"])
        assert gap.max() <= PARAM_TOL["every"]
        assert (gap > PARAM_TOL["most"]).mean() <= PARAM_TOL["share"]


def test_hybrid_remat_wraps_each_period(monkeypatch, ref):
    """Under grad mode remat "full" checkpoints each period once (2 for
    the smoke Jamba's 8 layers) and gives "none"'s gradients, bitwise."""
    _, r_params = ref(HYBRID)
    batch = {"tokens": torch.as_tensor(tokens(5, 2, 17))}
    grads, calls = {}, []
    real = t_lm.ckpt.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)
    monkeypatch.setattr(t_lm.ckpt, "checkpoint", counted)
    for remat in ("none", "full"):
        model, params = port(HYBRID, r_params, flash=False, remat=remat)
        flat, treedef = tree_flatten(params)
        leaves = [p.requires_grad_() for p in flat]
        loss, _ = model.loss(treedef.unflatten(leaves), batch)
        grads[remat] = torch.autograd.grad(loss, leaves)
    assert len(calls) == 2
    assert all(torch.equal(a, b) for a, b in zip(grads["none"],
                                                  grads["full"]))

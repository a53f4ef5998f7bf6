"""Parity of the port's VLM family (qwen2-vl-2b: the dense stack with
M-RoPE and a prefix of precomputed vision embeddings) with `repro`'s, at
its `smoke_config()` on the CPU.

Parameters come from `repro`'s `Model.init` (float32) and cross over
through `convert.params_from_numpy`; tokens and vision embeddings come
from numpy with fixed seeds.  `repro` runs its entry points under
`jax.jit` with `use_flash_kernel=False` (its smoke configuration's
setting); the port runs with the flag on, where the CPU takes the flash
kernel's plain version, and off.

The reference builds M-RoPE's three position streams as one stream three
times (`lm._positions3_default`), where M-RoPE gives RoPE's numbers, so
the model's parity cannot tell a wrong `apply_mrope` from `apply_rope`:
`test_apply_mrope_matches_repro_on_distinct_streams` holds it alone, and
`test_distinct_position_streams_reach_the_attention` patches distinct
streams into both packages' stacks.

Tolerances:

* `apply_mrope`: float32 rounding, rtol = atol = 1e-6 (`ROPE_TOL`; the
  angles, cos and sin are elementwise: measured ≤ 2.4e-7 against the
  eager reference on values up to 3.7, as this test runs it).
* float32 losses: rtol = atol = 1e-5 (`TOL`, as the other families).
  Logits and K/V caches add 1e-5 of their largest magnitude to the atol
  (`LOGIT_RTOL`, as tests/test_torch_zoo.py): a float32 sum errs in
  proportion to the magnitudes it adds, and the smoke attention has no
  qk-norm, so the second layer's K/V (up to ~21) carry the first layer's
  reorderings amplified (measured 1.8e-5–3.3e-5, 1.6e-6 of the largest;
  the first layer's 2.9e-7 of it; logits 4.2e-6–1.0e-5 on |logit| ≤ 3.4).
* Gradients (flag off), each leaf within `GRAD_RTOL` = 1e-4 of its
  largest element: the smoke attention without qk-norm amplifies float32
  reorderings in the backward pass (tests/test_torch_zoo.py measured up
  to 1.0e-4 of a leaf's largest at q and k for Jamba's).
* Token streams and `stats` of the serving engine, and a resumed
  training run against the uninterrupted one: exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import base as r_base  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro.serve.engine import Request as RRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402

ARCH = "qwen2-vl-2b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_RTOL = 1e-5
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_RTOL = 1e-4
SV = 8            # the smoke config's frontend_seq
# tests/test_launchers.py::test_serve_launcher's traffic
SERVE_KW = dict(batch_slots=2, max_seq=48, prompt_len=8)


class Jitted:
    """`repro`'s Model with its entry points under `jax.jit`."""

    def __init__(self, rm):
        self.cfg = rm.cfg
        self.init_caches = rm.init_caches
        self.loss = jax.jit(rm.loss)
        self.prefill = jax.jit(rm.prefill, static_argnums=2)
        self.decode_step = jax.jit(rm.decode_step)


@pytest.fixture(scope="module")
def ref():
    """(repro's jitted Model, its float32 params), made once."""
    rm = RModel(r_base.get_smoke_config(ARCH))
    params = jax.jit(lambda key: rm.init(key, dtype=jnp.float32))(
        jax.random.PRNGKey(0))
    return Jitted(rm), params


def port(params, flash=True, **overrides):
    cfg = dataclasses.replace(t_base.get_smoke_config(ARCH),
                              use_flash_kernel=flash, **overrides)
    model = build_model(cfg, "cpu")
    tree = jax.tree.map(np.asarray, params)
    return model, convert.params_from_numpy(tree, model.spec, "cpu")


def close(got, want, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(kw or TOL))


def logits_close(got, want):
    """Within TOL plus LOGIT_RTOL of the largest |want| (logits, caches)."""
    want = np.asarray(want, np.float32)
    close(got, want, rtol=TOL["rtol"],
          atol=TOL["atol"] + LOGIT_RTOL * float(np.abs(want).max()))


def batch(seed, B, S, vision=True):
    """{"tokens" [B,S]} and, with `vision`, "vision_embeds" [B,SV,d]
    unit normals, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 512, (B, S))}
    if vision:
        out["vision_embeds"] = rng.standard_normal((B, SV, 64)) \
            .astype(np.float32)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# ---- the configuration ----

def test_config_is_repro_s_and_counts_its_parameters():
    """`CONFIG` and `smoke_config()` field by field; the dense layer kinds;
    the parameter counts of both specs (the full one without
    materializing it)."""
    for name in ("get_config", "get_smoke_config"):
        got, want = getattr(t_base, name)(ARCH), getattr(r_base, name)(ARCH)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full = t_base.get_config(ARCH)
    assert full.mrope_sections == (16, 24, 24) and full.hd == 128
    assert t_lm._layer_kinds(full) == r_lm._layer_kinds(full) == \
        [("attn", "mlp")]
    assert build_model(full, "cpu").n_params() == \
        RModel(r_base.get_config(ARCH)).n_params()
    assert build_model(t_base.get_smoke_config(ARCH), "cpu").n_params() == \
        RModel(r_base.get_smoke_config(ARCH)).n_params()


# ---- M-RoPE ----

@pytest.mark.parametrize("hd,sections", [(16, (2, 3, 3)), (128, (16, 24, 24)),
                                         (8, (2, 3, 3))])
def test_apply_mrope_matches_repro_on_distinct_streams(hd, sections):
    """Three distinct streams (t constant, h and w ramps of other slopes)
    at the smoke sections, the published ones and sections longer than
    hd/2 (cut to hd/2 bands, as the reference cuts them): within ROPE_TOL
    of `repro`'s, and away from RoPE's on the t stream alone."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    s = np.arange(12)
    pos3 = np.stack([np.full((2, 12), 5), np.stack([s, 2 * s]),
                     np.stack([3 * s + 1, s // 2])]).astype(np.int32)
    want = np.asarray(r_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                           sections, 1e6))
    got = t_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                               sections, 1e6)
    assert got.dtype == torch.float32
    close(got, want, **ROPE_TOL)
    rope = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[0]),
                               1e6)
    assert float((got - rope).abs().max()) > 1e-2


def test_apply_mrope_of_one_stream_is_rope_and_keeps_the_type():
    """One stream three times (the reference's positions3) gives RoPE's
    numbers; bfloat16 in, bfloat16 out, rotated in float32."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 9, 4, 16)).astype(np.float32))
    pos = torch.arange(9)[None].expand(2, 9)
    pos3 = t_lm._positions3(t_base.get_smoke_config(ARCH), pos)
    assert pos3.shape == (3, 2, 9)
    close(t_layers.apply_mrope(x, pos3, (2, 3, 3)),
          t_layers.apply_rope(x, pos, 1e6).numpy(), **ROPE_TOL)
    got = t_layers.apply_mrope(x.bfloat16(), pos3, (2, 3, 3))
    assert got.dtype == torch.bfloat16
    assert t_lm._positions3(t_base.get_smoke_config("qwen3-1.7b"),
                            pos) is None


def test_apply_mrope_refuses_sections_shorter_than_the_bands():
    with pytest.raises(ValueError, match="frequency bands"):
        t_layers.apply_mrope(torch.zeros(1, 2, 1, 16),
                             torch.zeros(3, 1, 2, dtype=torch.int64),
                             (2, 2, 2))


def test_distinct_position_streams_reach_the_attention(ref, monkeypatch):
    """Both packages' stacks given the same distinct (t, h, w) streams
    (the functions that make their default streams patched): the losses
    agree at TOL and differ from the one-stream loss, so `positions3`
    reaches M-RoPE in every layer of the port's scoring forward."""
    rm, r_params = ref
    model, params = port(r_params, flash=False)
    b = batch(21, 2, 16)

    def streams(pos, xp):
        return xp.stack([pos * 0 + 3, pos, (pos * 7) % 11])

    monkeypatch.setattr(r_lm, "_positions3_default",
                        lambda pos: streams(pos, jnp))
    r_loss, _ = jax.jit(lambda p, bb: r_lm.lm_loss(rm.cfg, p, bb))(
        r_params, to_jax(b))
    monkeypatch.setattr(t_lm, "_positions3",
                        lambda cfg, pos: streams(pos, torch))
    with torch.no_grad():
        loss, _ = model.loss(params, to_torch(b))
        monkeypatch.undo()
        plain, _ = model.loss(params, to_torch(b))
    close(loss, r_loss)
    assert abs(float(loss) - float(plain)) > 1e-4


# ---- scoring with the vision prefix ----

@pytest.mark.parametrize("flash", [True, False])
def test_loss_with_vision_embeds_matches_repro(ref, flash):
    """`Model.loss` on tokens [2, 24] after an 8-row vision prefix: the
    loss at TOL, no loss on the prefix (tokens counted 2 × 23), and the
    prefix moves it."""
    rm, r_params = ref
    model, params = port(r_params, flash)
    b = batch(11, 2, 24)
    r_loss, r_met = rm.loss(r_params, to_jax(b))
    with torch.no_grad():
        loss, met = model.loss(params, to_torch(b))
        text, _ = model.loss(params, {"tokens": torch.as_tensor(
            b["tokens"])})
    close(loss, r_loss)
    assert float(met["tokens"]) == float(r_met["tokens"]) == 2 * 23
    assert float(met["aux_loss"]) == 0.0
    assert abs(float(loss) - float(text)) > 1e-4


def test_forward_hidden_spans_the_prefix(ref):
    """The hidden states run over SV + S positions, the prefix first."""
    _, r_params = ref
    model, params = port(r_params)
    b = to_torch(batch(2, 2, 10))
    with torch.no_grad():
        hidden, _ = t_lm.forward_hidden(model.cfg, params, b["tokens"],
                                        b["vision_embeds"])
        logits, _ = t_lm.forward_train(model.cfg, params, b["tokens"],
                                       b["vision_embeds"])
    want, _ = jax.jit(lambda p, t, v: r_lm.forward_train(
        r_base.get_smoke_config(ARCH), p, t, v))(
        r_params, jnp.asarray(b["tokens"].numpy()),
        jnp.asarray(b["vision_embeds"].numpy()))
    assert hidden.shape == (2, SV + 10, 64)
    logits_close(logits, want)


def test_loss_gradient_matches_repro(ref):
    """Flag off: every leaf of the port's gradient (autograd) within
    GRAD_RTOL of its largest element of `jax.grad`'s, prefix included."""
    rm, r_params = ref
    model, params = port(r_params, flash=False)
    b = batch(12, 2, 17)
    r_grads = jax.jit(jax.grad(lambda p, bb: rm.loss(p, bb)[0]))(
        r_params, to_jax(b))
    flat, treedef = tree_flatten(params)
    leaves = [p.requires_grad_() for p in flat]
    loss, _ = model.loss(treedef.unflatten(leaves), to_torch(b))
    grads = torch.autograd.grad(loss, leaves)
    want, _ = jax.tree.flatten(r_grads)
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= GRAD_RTOL * np.abs(w).max()


# ---- serving ----

def caches_close(got, want):
    assert type(got).__name__ == type(want).__name__ == "KVCache"
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        logits_close(a, b)


def test_prefill_with_the_prefix_and_decode_match_repro(ref):
    """`Model.prefill` of 10 tokens after the 8-row prefix (float32
    caches, as the reference's `prefill` builds them from its params'
    type via `init_caches`' dtype), then 3 decode steps from pos SV + 10,
    each from the reference's caches carried over with `convert`."""
    rm, r_params = ref
    model, params = port(r_params)
    b = batch(1, 2, 10)
    r_caches = rm.init_caches(2, 32, jnp.float32)
    l_r, c_r, s_r = jax.jit(
        lambda p, t, v, c: r_lm.prefill(rm.cfg, p, t, 32, v, c))(
        r_params, jnp.asarray(b["tokens"]), jnp.asarray(b["vision_embeds"]),
        r_caches)
    t = to_torch(b)
    l_t, c_t, s_t = t_lm.prefill(model.cfg, params, t["tokens"], 32,
                                 t["vision_embeds"],
                                 model.init_caches(2, 32, torch.float32))
    assert s_t == int(s_r) == SV + 10
    logits_close(l_t, l_r)
    caches_close(c_t, c_r)
    for step in range(3):
        tok = np.asarray(jnp.argmax(l_r, -1))[:, None]
        c_t = convert.caches_from_numpy(jax.tree.map(np.asarray, c_r), c_t)
        l_r, c_r = rm.decode_step(r_params, jnp.asarray(tok), SV + 10 + step,
                                  c_r)
        l_t, c_t = model.decode_step(params, torch.tensor(tok),
                                     SV + 10 + step, c_t)
        logits_close(l_t, l_r)
        caches_close(c_t, c_r)


def test_model_prefill_passes_the_vision_embeds(ref):
    """`Model.prefill` reads `batch["vision_embeds"]` (bfloat16 caches,
    the default): the same last-position logits as `lm.prefill` given the
    prefix, other than without it."""
    _, r_params = ref
    model, params = port(r_params)
    t = to_torch(batch(3, 2, 6))
    logits, caches = model.prefill(params, t, 24)
    want, _, _ = t_lm.prefill(model.cfg, params, t["tokens"], 24,
                              t["vision_embeds"])
    text, _ = model.prefill(params, {"tokens": t["tokens"]}, 24)
    assert caches.k.dtype == torch.bfloat16
    assert torch.equal(logits, want)
    assert float((logits - text).abs().max()) > 1e-3


def serve(engine, req_cls, n=5, prompt=8, new=8):
    rng = np.random.default_rng(0)
    reqs = [req_cls(rid, rng.integers(0, 512, size=prompt),
                    max_new_tokens=new) for rid in range(n)]
    for r in reqs:
        engine.submit(r)
    steps = engine.run_until_drained()
    return steps, [r.output for r in reqs], [r.done for r in reqs]


def test_serve_engine_on_text_prompts_matches_repro(ref):
    """tests/test_launchers.py's traffic (5 requests, 2 slots, 8 new
    tokens) on text prompts, as the reference's engine serves the VLM:
    the same token streams and stats."""
    rm, r_params = ref
    r_engine = RServeEngine(rm, r_params, **SERVE_KW)
    r_out = serve(r_engine, RRequest)
    model, params = port(r_params)
    engine = t_engine.ServeEngine(model, params, **SERVE_KW)
    assert serve(engine, t_engine.Request) == r_out
    assert engine.stats == r_engine.stats
    assert all(r_out[2])


# ---- training through the launcher ----

def test_train_launcher_resume(tmp_path):
    """tests/test_launchers.py's resume on qwen2-vl-2b (tokens only, as the
    reference's launcher trains it): 6 steps, then `--resume` to 9 runs
    3, exactly steps 7–9 of an uninterrupted 9-step run."""
    small = ["--arch", ARCH, "--batch", "2", "--seq", "32", "--ckpt-every",
             "3", "--device", "cpu"]
    full = t_train.main(small + ["--steps", "9", "--ckpt-dir",
                                 str(tmp_path / "full")])
    cut = str(tmp_path / "cut")
    t_train.main(small + ["--steps", "6", "--ckpt-dir", cut])
    losses = t_train.main(small + ["--steps", "9", "--ckpt-dir", cut,
                                   "--resume"])
    assert len(losses) == 3                # resumed from step 6
    assert losses == full[6:]
    assert all(np.isfinite(full))

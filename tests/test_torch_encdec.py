"""Parity of the port's audio family (whisper-small: the encoder-decoder
of `models/encdec.py`) with `repro`'s, at its `smoke_config()` on the
CPU.

Parameters come from `repro`'s `Model.init` (float32) and cross over
through `convert.params_from_numpy`; frames and tokens come from numpy
with fixed seeds.  `repro` runs under `jax.jit` with
`use_flash_kernel=False` (its smoke configuration's setting); the port
runs with the flag on, where the decoder's causal self-attention takes
the flash kernel's plain version on the CPU, and off.

Tolerances:

* `_sinusoid` alone: two ulps of the largest angle (`sin_atol`).  The
  float32 `pow` of XLA and of torch differ in the last bit at 4 of
  Whisper's 384 exponents, which moves an angle pos / 10000^(2i/d) by an
  ulp, and sin and cos of one angle differ by an ulp of the result:
  measured 6.0e-8 at the smoke length (20), and at Whisper's 1500 × 768
  3.1e-5 against the eager reference, 1.2e-4 (one ulp of 1499) against
  the jitted one.
* Losses: rtol = atol = 1e-5 (`TOL`; measured 7e-8 relative).
* Each encoder and decoder layer from the reference's own input: within
  `LAYER_RTOL` = 1e-5 of the output's largest magnitude (measured
  ≤ 1.9e-6).
* Values carried through the whole stack (the encoder's states, the
  logits, every cache leaf): rtol 1e-5 and an atol of `STACK_RTOL` = 1e-4
  of the largest magnitude (measured ≤ 3.1e-5 of it over four draws:
  1.3e-4 on teacher-forced logits up to 4.2; 2.0e-5 on this file's).
  The smoke attention has no qk-norm and the reference's initializer
  scales q and k by 1/sqrt(heads), so the encoder's scores reach O(70)
  and the softmax is nearly an argmax: a float32 reordering in one layer
  moves the next layers' outputs far more
  (`test_encoder_attention_amplifies_float32_noise_in_repro`).
* Gradients (flag off), each leaf within `GRAD_RTOL` = 1e-3 of its
  largest element (measured 2.2e-4 on this file's draw and 2.6e-4 on
  another, at the encoder's k: the same amplification in the backward
  pass).
* bfloat16 caches within one bfloat16 rounding of the reference's
  (|a − b| ≤ 2⁻⁷·|b|) plus the stack's atol.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import base as r_base  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import encdec as r_ed  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import encdec as t_ed  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402

ARCH = "whisper-small"
TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_RTOL = 1e-5
STACK_RTOL = 1e-4
GRAD_RTOL = 1e-3
S_ENC = 20


class Jitted:
    """`repro`'s Model with its entry points, and its encoder and one
    layer of each stack, under `jax.jit`."""

    def __init__(self, rm):
        cfg = self.cfg = rm.cfg
        self.init_caches = rm.init_caches
        self.loss = jax.jit(rm.loss)
        self.prefill = jax.jit(rm.prefill, static_argnums=2)
        self.decode_step = jax.jit(rm.decode_step)
        self.grad = jax.jit(jax.grad(lambda p, b: rm.loss(p, b)[0]))
        self.encode = jax.jit(lambda p, f: r_ed.encode(cfg, p, f))
        self.decode_train = jax.jit(
            lambda p, t, e: r_ed.decode_train(cfg, p, t, e))

        def enc_layer(p, x):
            pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None],
                                   x.shape[:2])
            h = r_layers.rms_norm(x, p["norm1"], cfg.norm_eps)
            x = x + r_attn.attention(cfg, p["mixer"], h, pos, causal=False,
                                     use_rope=False)
            h = r_layers.rms_norm(x, p["norm2"], cfg.norm_eps)
            return x + r_layers.mlp_apply(cfg, p["ffn"], h)

        def dec_layer(p, x, enc_out):
            pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None],
                                   x.shape[:2])
            h = r_layers.rms_norm(x, p["norm1"], cfg.norm_eps)
            x = x + r_attn.attention(cfg, p["self"], h, pos)
            h = r_layers.rms_norm(x, p["norm_x"], cfg.norm_eps)
            k, v = r_ed._cross_kv(cfg, p["cross"], enc_out)
            x = x + r_attn.cross_attention_cached(cfg, p["cross"], h, k, v)
            h = r_layers.rms_norm(x, p["norm2"], cfg.norm_eps)
            return x + r_layers.mlp_apply(cfg, p["ffn"], h)

        self.enc_layer = jax.jit(enc_layer)
        self.dec_layer = jax.jit(dec_layer)


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


def stack_close(got, want):
    """Within TOL's rtol and STACK_RTOL of the largest |want|."""
    want = np.asarray(want, np.float32)
    close(got, want, rtol=TOL["rtol"],
          atol=TOL["atol"] + STACK_RTOL * float(np.abs(want).max()))


def layer_close(got, want):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= \
        LAYER_RTOL * np.abs(want).max()


def inputs(seed, B=2, S_dec=32, dtype=np.float32):
    """{"frames" [B, S_ENC, d] unit normals, "tokens" [B, S_dec]}."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, S_ENC, 64)).astype(dtype),
            "tokens": rng.integers(0, 512, (B, S_dec))}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# ---- the configuration and the spec ----

def test_config_spec_and_parameter_count_are_repro_s():
    """`CONFIG` and `smoke_config()` field by field; every leaf of the
    encoder-decoder spec (embed, encoder, enc_norm, decoder; no q/k norm
    on the cross-attention) by path and shape; the parameter counts of
    both specs."""
    for name in ("get_config", "get_smoke_config"):
        got, want = getattr(t_base, name)(ARCH), getattr(r_base, name)(ARCH)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = t_base.get_smoke_config(ARCH)
    r_spec = jax.tree.map(lambda p: p.shape, r_ed.encdec_spec(cfg),
                          is_leaf=lambda p: hasattr(p, "shape"))
    t_spec = {path: p.shape for path, p in leaves(t_ed.encdec_spec(cfg))}
    assert dict(convert._flatten(r_spec)) == t_spec
    assert set(t_spec) >= {"enc_norm", "embed/head", "decoder/cross/q"}
    qk = dataclasses.replace(cfg, qk_norm=True)
    assert "q_norm" in t_attn.attn_spec(qk)
    assert "q_norm" not in t_attn.attn_spec(qk, cross=True)
    for c in (t_base.get_config(ARCH), cfg):
        assert build_model(c, "cpu").n_params() == RModel(c).n_params()
    assert build_model(cfg, "cpu").is_encdec


@pytest.mark.parametrize("S,d", [(S_ENC, 64), (1500, 768)])
def test_sinusoid_matches_repro(S, d):
    """Against the reference's `_sinusoid`, eagerly and jitted, within two
    ulps of the largest angle (S − 1)."""
    sin_atol = 2 * float(np.spacing(np.float32(S - 1)))
    got = t_ed._sinusoid(S, d)
    assert got.shape == (S, d) and got.dtype == torch.float32
    for want in (r_ed._sinusoid(S, d),
                 jax.jit(r_ed._sinusoid, static_argnums=(0, 1))(S, d)):
        close(got, want, rtol=0, atol=sin_atol)


# ---- the encoder and scoring ----

def test_each_layer_matches_repro_from_its_input(ref):
    """Each encoder layer and each decoder layer (self-attention, cross-
    attention over the reference's encoder states, MLP) on the
    reference's own input: within LAYER_RTOL of the output's largest
    magnitude."""
    rm, r_params = ref
    model, params = port(r_params, flash=False)
    cfg = model.cfg
    b = inputs(1)
    x = jnp.asarray(b["frames"]) + r_ed._sinusoid(S_ENC, 64)[None]
    for i in range(cfg.n_enc_layers):
        y = rm.enc_layer(jax.tree.map(lambda a: a[i], r_params["encoder"]),
                         x)
        p = t_lm._layer(params["encoder"], i)
        xt = torch.from_numpy(np.array(x))
        with torch.no_grad():
            h = t_ed.rms_norm(xt, p["norm1"], cfg.norm_eps)
            xt = xt + t_attn.attention(cfg, p["mixer"], h,
                                       t_lm._positions(xt), causal=False,
                                       use_rope=False)
            yt = xt + t_ed.mlp_apply(cfg, p["ffn"], t_ed.rms_norm(
                xt, p["norm2"], cfg.norm_eps))
        layer_close(yt, y)
        x = y
    enc_out = r_layers.rms_norm(x, r_params["enc_norm"], cfg.norm_eps)
    et = torch.from_numpy(np.array(enc_out))
    x = r_params["embed"]["tok"][jnp.asarray(b["tokens"])]
    for i in range(cfg.n_layers):
        y = rm.dec_layer(jax.tree.map(lambda a: a[i], r_params["decoder"]),
                         x, enc_out)
        p = t_lm._layer(params["decoder"], i)
        xt = torch.from_numpy(np.array(x))
        with torch.no_grad():
            k, v = t_ed._cross_kv(cfg, p["cross"], et)
            yt = t_ed._dec_block(cfg, p, xt, lambda h: t_attn.attention(
                cfg, p["self"], h, t_lm._positions(xt)), k, v)
        layer_close(yt, y)
        x = y


def test_encoder_attention_amplifies_float32_noise_in_repro(ref):
    """Why STACK_RTOL: in `repro` alone, the first encoder layer moves its
    output by more than 10× a perturbation of its input of the size of a
    float32 reordering (1e-6 of the input's largest magnitude)."""
    rm, r_params = ref
    x = jnp.asarray(inputs(1)["frames"]) + r_ed._sinusoid(S_ENC, 64)[None]
    eps = np.random.default_rng(2).standard_normal(x.shape) \
        .astype(np.float32)
    eps *= 1e-6 * float(jnp.abs(x).max()) / np.abs(eps).max()
    p = jax.tree.map(lambda a: a[0], r_params["encoder"])
    moved = float(jnp.abs(rm.enc_layer(p, x + eps) - rm.enc_layer(p, x))
                  .max())
    assert moved > 10 * np.abs(eps).max()


def test_encode_and_teacher_forced_logits_match_repro(ref):
    """`encode` (frames plus sinusoid, non-causal attention without RoPE,
    `enc_norm`) and `decode_train`'s logits over an odd decoder length
    (31), each through the whole stack: within the stack's tolerance."""
    rm, r_params = ref
    model, params = port(r_params)
    b = inputs(2)
    enc_r = rm.encode(r_params, jnp.asarray(b["frames"]))
    with torch.no_grad():
        enc_t = t_ed.encode(model.cfg, params, torch.from_numpy(b["frames"]))
        logits = t_ed.decode_train(model.cfg, params, torch.from_numpy(
            b["tokens"][:, :-1]), enc_t)
    stack_close(enc_t, enc_r)
    want = rm.decode_train(r_params, jnp.asarray(b["tokens"][:, :-1]), enc_r)
    assert logits.shape == (2, 31, 512) and logits.dtype == torch.float32
    stack_close(logits, want)


@pytest.mark.parametrize("flash", [True, False])
def test_loss_matches_repro(ref, flash):
    """`Model.loss` on frames [2, 20, 64] and tokens [2, 32] (31 decoder
    positions), a label of −1 masked: the loss at TOL, the tokens counted,
    aux 0."""
    rm, r_params = ref
    model, params = port(r_params, flash)
    b = inputs(3)
    b["tokens"][1, 5] = -1
    r_loss, r_met = rm.loss(r_params, to_jax(b))
    with torch.no_grad():
        loss, met = model.loss(params, to_torch(b))
    close(loss, r_loss)
    assert float(met["tokens"]) == float(r_met["tokens"]) == 2 * 31 - 1
    assert float(met["aux_loss"]) == 0.0
    assert loss.dtype == torch.float32 and loss.shape == ()


def test_loss_gradient_matches_repro(ref):
    """Flag off: every leaf of the port's gradient (autograd) within
    GRAD_RTOL of its largest element of `jax.grad`'s."""
    rm, r_params = ref
    model, params = port(r_params, flash=False)
    b = inputs(4, S_dec=11)
    want, _ = jax.tree.flatten(rm.grad(r_params, to_jax(b)))
    flat, treedef = tree_flatten(params)
    ls = [p.requires_grad_() for p in flat]
    loss, _ = model.loss(treedef.unflatten(ls), to_torch(b))
    grads = torch.autograd.grad(loss, ls)
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= GRAD_RTOL * np.abs(w).max()


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_checkpoints_each_layer(monkeypatch, ref, remat):
    """Under grad mode every remat other than "none" checkpoints each
    encoder and decoder layer once (a full checkpoint, as the reference's
    plain `jax.checkpoint`), with "none"'s gradients, bitwise; without
    grad mode nothing is checkpointed."""
    _, r_params = ref
    b = to_torch(inputs(5, S_dec=9))
    calls, grads = [], {}
    real = t_ed.ckpt.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)
    monkeypatch.setattr(t_ed.ckpt, "checkpoint", counted)
    for mode in ("none", remat):
        model, params = port(r_params, flash=False, remat=mode)
        flat, treedef = tree_flatten(params)
        ls = [p.requires_grad_() for p in flat]
        loss, _ = model.loss(treedef.unflatten(ls), b)
        grads[mode] = torch.autograd.grad(loss, ls)
    assert len(calls) == 4 and all("context_fn" not in kw for kw in calls)
    assert all(torch.equal(a, c) for a, c in zip(grads["none"],
                                                  grads[remat]))
    with torch.no_grad():
        model.loss(params, b)
    assert len(calls) == 4


# ---- serving ----

def dec_caches_close(got, want):
    """Every `DecCache` leaf, the nested `KVCache` included."""
    assert type(got).__name__ == type(want).__name__ == "DecCache"
    assert type(got.self_kv).__name__ == "KVCache"
    pairs = [(got.self_kv.k, want.self_kv.k), (got.self_kv.v, want.self_kv.v),
             (got.cross_k, want.cross_k), (got.cross_v, want.cross_v)]
    for a, w in pairs:
        w = np.asarray(w, np.float32)
        assert tuple(a.shape) == w.shape
        if a.dtype == torch.bfloat16:
            atol = TOL["atol"] + STACK_RTOL * float(np.abs(w).max())
            assert np.all(np.abs(a.float().numpy() - w)
                          <= 2.0 ** -7 * np.abs(w) + atol)
        else:
            stack_close(a, w)


def test_serve_prefill_and_decode_match_repro(ref):
    """`Model.prefill` of 20 frames and a 4-token prompt, then 3 greedy
    `decode_step`s, each from the reference's caches carried over with
    `convert.caches_from_numpy`: logits and every `DecCache` leaf within
    the stack's tolerance; the self-attention K/V written in place."""
    rm, r_params = ref
    model, params = port(r_params)
    b = inputs(6)
    b["tokens"] = b["tokens"][:, :4]
    l_r, c_r = rm.prefill(r_params, to_jax(b), S_ENC)
    with torch.no_grad():
        l_t, c_t = model.prefill(params, to_torch(b), S_ENC)
    assert l_t.shape == (2, 512) and l_t.dtype == torch.float32
    assert c_t.self_kv.k.shape == (2, 2, 32, 4, 16)     # [L, B, dec_max_seq]
    assert c_t.cross_k.dtype == torch.float32
    stack_close(l_t, l_r)
    dec_caches_close(c_t, c_r)
    for step in range(3):
        tok = np.asarray(jnp.argmax(l_r, -1))[:, None]
        c_t = convert.caches_from_numpy(jax.tree.map(np.asarray, c_r), c_t)
        k_before = c_t.self_kv.k
        l_r, c_r = rm.decode_step(r_params, jnp.asarray(tok), 4 + step, c_r)
        with torch.no_grad():
            l_t, c_t = model.decode_step(params, torch.tensor(tok), 4 + step,
                                         c_t)
        assert c_t.self_kv.k is k_before
        stack_close(l_t, l_r)
        dec_caches_close(c_t, c_r)


def test_serve_prefill_builds_its_caches_in_the_frames_type(ref):
    """bfloat16 frames and parameters (the reference's scan needs both in
    one type): every `DecCache` leaf bfloat16 in both packages, of the
    same shapes; the port's cross K/V are `precompute_cross` of its
    encoder states cast to the frames' type, bitwise."""
    rm, r_params = ref
    r_bf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), r_params)
    model = build_model(t_base.get_smoke_config(ARCH), "cpu")
    params = convert.params_from_numpy(jax.tree.map(np.asarray, r_bf16),
                                       model.spec, "cpu", torch.bfloat16)
    b = inputs(7, S_dec=3)
    _, c_r = rm.prefill(r_bf16, {"frames": jnp.asarray(b["frames"]).astype(
        jnp.bfloat16), "tokens": jnp.asarray(b["tokens"])}, S_ENC)
    frames = torch.from_numpy(b["frames"]).bfloat16()
    with torch.no_grad():
        _, c_t = model.prefill(params, {
            "frames": frames, "tokens": torch.from_numpy(b["tokens"])},
            S_ENC)
        k, v = t_ed.precompute_cross(model.cfg, params, t_ed.encode(
            model.cfg, params, frames))
    for a, w in zip((*c_t.self_kv, c_t.cross_k, c_t.cross_v),
                    (*c_r.self_kv, c_r.cross_k, c_r.cross_v)):
        assert a.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert tuple(a.shape) == w.shape
    assert torch.equal(c_t.cross_k, k.bfloat16())
    assert torch.equal(c_t.cross_v, v.bfloat16())


def test_init_caches_take_max_seq_as_the_encoder_length(ref):
    """`Model.init_caches(batch, max_seq)` passes `max_seq` as the
    encoder's length, as the reference's does: the reference's zero
    caches, leaf by leaf, in the default bfloat16."""
    rm, r_params = ref
    model, _ = port(r_params)
    got = model.init_caches(3, 11)
    want = rm.init_caches(3, 11)
    assert got.cross_k.shape == (2, 3, 11, 4, 16)
    assert got.self_kv.v.shape == (2, 3, 32, 4, 16)
    for a, w in zip((*got.self_kv, got.cross_k, got.cross_v),
                    (*want.self_kv, want.cross_k, want.cross_v)):
        assert tuple(a.shape) == w.shape and a.dtype == torch.bfloat16
        assert not bool(a.any())


def test_convert_carries_dec_caches_and_parameters_bitwise(ref):
    """`caches_from_numpy` takes the reference's nested `DecCache` (float32
    from a prefill, and bfloat16 by its bits), `params_from_numpy` the
    encoder-decoder's tree: every leaf bitwise; a cache tree of another
    shape or structure, or a tree without `enc_norm`, raises."""
    rm, r_params = ref
    model, params = port(r_params)
    tree = jax.tree.map(np.asarray, r_params)
    want, got = dict(convert._flatten(tree)), dict(convert._flatten(params))
    assert sorted(got) == sorted(want) == [p for p, _ in leaves(model.spec)]
    for path, a in got.items():
        np.testing.assert_array_equal(a.numpy(), want[path])
    _, c_r = rm.prefill(r_params, to_jax(inputs(8, S_dec=4)), S_ENC)
    for r_caches, like in ((c_r, model.init_caches(2, S_ENC, torch.float32)),
                           (rm.init_caches(2, S_ENC),
                            model.init_caches(2, S_ENC))):
        r_caches = jax.tree.map(np.asarray, r_caches)
        got = convert.caches_from_numpy(r_caches, like)
        assert type(got).__name__ == "DecCache"
        assert type(got.self_kv).__name__ == "KVCache"
        for a, w in zip((*got.self_kv, got.cross_k, got.cross_v),
                        (*r_caches.self_kv, r_caches.cross_k,
                         r_caches.cross_v)):
            assert a.dtype == like.cross_k.dtype
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(w, np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.caches_from_numpy(r_caches, model.init_caches(2, 7))
    with pytest.raises(ValueError, match="fields"):
        convert.caches_from_numpy(
            (r_caches.self_kv.k, r_caches.self_kv.v, r_caches.cross_k,
             r_caches.cross_v), model.init_caches(2, S_ENC))
    del tree["enc_norm"]
    with pytest.raises(KeyError, match="enc_norm"):
        convert.params_from_numpy(tree, model.spec, "cpu")


def test_engine_and_serve_launcher_refuse_the_encoder_decoder(ref):
    """The engine prefills tokens only, as the reference's, whose first
    prefill then fails on the missing frames: the port's engine, and
    `launch/serve` through it, refuse whisper at construction."""
    _, r_params = ref
    model, params = port(r_params)
    calls = []
    model.prefill = lambda *a: calls.append(a)
    with pytest.raises(ValueError, match="frames"):
        t_engine.ServeEngine(model, params, batch_slots=2, max_seq=16,
                             prompt_len=4)
    with pytest.raises(ValueError, match="frames"):
        t_serve.main(["--arch", ARCH, "--requests", "1", "--slots", "1",
                      "--max-new", "2", "--prompt-len", "4", "--max-seq",
                      "16", "--device", "cpu"])
    assert calls == []

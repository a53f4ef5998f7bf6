"""Parity of the port's dense family (qwen3-1.7b) with `repro`'s.

Parameters come from `repro`'s `Model.init` (float32) and cross over
through `convert.params_from_numpy`; tokens and activations come from
numpy with fixed seeds.  `repro` runs as its own tests run it; where its
attention reaches the Pallas flash kernel (`use_flash_kernel=True`), the
kernel's wrapper is patched to `interpret=True`, the only mode its CPU
allows.  The port on the CPU runs the flash kernel's plain version.

Tolerances: rtol = atol = 1e-5 at float32 (float32 sums in other
orders); the bfloat16 KV caches within one bfloat16 ulp plus that
(|a − b| ≤ 2⁻⁷·|b| + 1e-5: K and V are formed in float32 on both sides
and rounded once, so a rare element lands on the other bf16
neighbour).  The flash path and the plain attention round differently
(q scaled before or logits divided after the product, masks of −1e30
or −2e38), so comparisons across the flag are tolerances too.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.kernels.flash_attention.ops as r_fa_ops  # noqa: E402
from repro.configs.qwen3_1p7b import CONFIG as R_CONFIG  # noqa: E402
from repro.configs.qwen3_1p7b import smoke_config as r_smoke  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro.serve.engine import Request as RRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs.qwen3_1p7b import CONFIG, smoke_config  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref_model():
    return RModel(r_smoke())


@pytest.fixture(scope="module")
def ref_params(ref_model):
    return ref_model.init(jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture
def repro_flash_interpret(monkeypatch):
    """`repro`'s flash kernel in interpret mode, patched from outside."""
    monkeypatch.setattr(r_fa_ops, "flash_attention", functools.partial(
        r_fa_ops.flash_attention, interpret=True))


def port(params, flash=True, dtype=torch.float32, **cfg_overrides):
    cfg = dataclasses.replace(smoke_config(), use_flash_kernel=flash,
                              **cfg_overrides)
    model = build_model(cfg, "cpu")
    tree = jax.tree.map(np.asarray, params)
    return model, convert.params_from_numpy(tree, model.spec, "cpu", dtype)


def rcfg(flash):
    return dataclasses.replace(r_smoke(), use_flash_kernel=flash)


def layer(tree, i):
    return jax.tree.map(lambda a: np.asarray(a)[i], tree)


def tensors(tree):
    return {k: tensors(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def close_bf16(got, want):
    """One bfloat16 rounding step of `want`, plus the float32 atol."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-5)


def tokens(seed, B, S):
    return np.random.default_rng(seed).integers(0, 512, (B, S))


def activations(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ---- layers ----

@pytest.mark.parametrize("S", [5, 24])
def test_apply_rope_matches_repro(S):
    x = activations(S, 2, S, 4, 16)
    pos = np.repeat(np.arange(S)[None] + 3, 2, axis=0)
    close(t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
          r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp_apply_matches_repro(act):
    cfg = dataclasses.replace(smoke_config(), act=act)
    rc = dataclasses.replace(r_smoke(), act=act)
    rng = np.random.default_rng(1)
    p = {k: (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in t_layers.mlp_spec(cfg).items()}
    x = activations(2, 2, 6, 64)
    close(t_layers.mlp_apply(cfg, tensors(p), torch.from_numpy(x)),
          r_layers.mlp_apply(rc, p, jnp.asarray(x)))


def test_mlp_apply_bf16_rounds_silu_as_repro():
    """bf16 SwiGLU at x [2, 256, 64] and the smoke widths (d_ff 128), on
    random bf16 weights: the SiLU rounds at each step of `jax.nn.silu`, as
    the reference's does on the CPU (`F.silu`, rounding once, moves more
    than half of the outputs, by up to one bf16 ulp).

    What may still differ is the three products' float32 summation order:
    where a product's float32 sum lands beside a bf16 rounding midpoint,
    the two sides round it one ulp apart.  So at most 1% of the outputs
    differ at all, and each within one ulp of its own rounding plus one
    ulp of every hidden element it sums: |Δy| ≤ 2⁻⁷·|y| + 2⁻⁷·(|h|·|wo|),
    h the reference's hidden activations (one bf16 ulp ≤ 2⁻⁷ of a value).
    """
    cfg, rc = smoke_config(), r_smoke()
    rng = np.random.default_rng(7)
    p = {k: jnp.asarray(0.2 * rng.standard_normal(v.shape)).astype(
        jnp.bfloat16) for k, v in t_layers.mlp_spec(cfg).items()}
    x = jnp.asarray(activations(8, 2, 256, 64)).astype(jnp.bfloat16)
    want = np.asarray(r_layers.mlp_apply(rc, p, x), np.float32)
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          for k, v in p.items()}
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = t_layers.mlp_apply(cfg, tp, tx)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 256, 64)
    got = got.float().numpy()
    h = np.asarray(jax.nn.silu(x @ p["wi0"]) * (x @ p["wi1"]), np.float32)
    bound = 2.0 ** -7 * (np.abs(want) + np.abs(h) @ np.abs(
        np.asarray(p["wo"], np.float32)))
    assert (got != want).sum() <= 0.01 * want.size
    assert np.all(np.abs(got - want) <= bound)
    once = (torch.nn.functional.silu(tx @ tp["wi0"]) * (tx @ tp["wi1"])) \
        @ tp["wo"]
    assert (once.float().numpy() != want).sum() > 0.5 * want.size


@pytest.mark.parametrize("S,chunk", [(24, 512), (24, 7), (10, 4)])
def test_chunked_ce_matches_repro(ref_params, S, chunk):
    emb = layer({"e": ref_params["embed"]}, slice(None))["e"]
    h = activations(S, 2, S, 64)
    labels = tokens(S + 1, 2, S)
    labels[:, -1] = -1
    labels[0, 2] = -1
    nll_t, cnt_t = t_layers.chunked_ce(smoke_config(), tensors(emb),
                                       torch.from_numpy(h),
                                       torch.from_numpy(labels), chunk)
    nll_r, cnt_r = r_layers.chunked_ce(r_smoke(), emb, jnp.asarray(h),
                                       jnp.asarray(labels), chunk)
    close(nll_t, nll_r)
    assert int(cnt_t) == int(cnt_r) == 2 * S - 3


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_matches_repro(causal):
    q, k, v = (activations(i, 2, 12, h, 16) for i, h in ((0, 4), (1, 2),
                                                          (2, 2)))
    mask = np.tril(np.ones((12, 12), bool)) if causal else \
        np.ones((12, 12), bool)
    close(t_attn._sdpa(smoke_config(), *(torch.from_numpy(a)
                                         for a in (q, k, v)),
                       torch.from_numpy(mask)[None, None]),
          r_attn._sdpa(r_smoke(), jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v), jnp.asarray(mask)[None, None]))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv,qc,kc", [(20, 20, 8, 8), (19, 19, 4, 16)])
def test_sdpa_blockwise_matches_repro(causal, Sq, Skv, qc, kc):
    q = activations(Sq, 2, Sq, 4, 16)
    k, v = activations(1, 2, Skv, 2, 16), activations(2, 2, Skv, 2, 16)
    got = t_attn._sdpa_blockwise(smoke_config(), *(torch.from_numpy(a)
                                                   for a in (q, k, v)),
                                 causal, qc, kc)
    close(got, r_attn._sdpa_blockwise(r_smoke(), jnp.asarray(q),
                                      jnp.asarray(k), jnp.asarray(v),
                                      causal, qc, kc))
    close(got, t_attn._dispatch_sdpa(smoke_config(),
                                     *(torch.from_numpy(a)
                                       for a in (q, k, v)), causal))


@pytest.mark.parametrize("flash", [True, False])
def test_attention_matches_repro(ref_params, repro_flash_interpret, flash):
    p = layer(ref_params["blocks"]["mixer"], 0)
    x = activations(3, 2, 20, 64)
    pos = np.repeat(np.arange(20)[None], 2, axis=0)
    cfg = dataclasses.replace(smoke_config(), use_flash_kernel=flash)
    got = t_attn.attention(cfg, tensors(p), torch.from_numpy(x),
                           torch.from_numpy(pos))
    close(got, r_attn.attention(rcfg(flash), p, jnp.asarray(x),
                                jnp.asarray(pos)))


@pytest.mark.parametrize("offset", [-1, 0, 3])
def test_decode_attention_at_and_past_the_cache_end_matches_repro(
        ref_params, offset):
    """A step at pos = max_seq + offset (cache of 8): at or past the end,
    the reference's `dynamic_update_slice` clamps the write onto row
    max_seq − 1, and so does the port's `_write`; y and both caches at
    float32."""
    max_seq, pos = 8, 8 + offset
    p = layer(ref_params["blocks"]["mixer"], 0)
    x = activations(5, 2, 1, 64)
    k0, v0 = activations(6, 2, max_seq, 2, 16), activations(7, 2, max_seq,
                                                            2, 16)
    y_r, c_r = r_attn.decode_attention(
        rcfg(False), p, jnp.asarray(x), pos,
        r_attn.KVCache(jnp.asarray(k0), jnp.asarray(v0)))
    y_t, c_t = t_attn.decode_attention(
        smoke_config(), tensors(p), torch.from_numpy(x), pos,
        t_attn.KVCache(torch.from_numpy(k0.copy()),
                       torch.from_numpy(v0.copy())))
    close(y_t, y_r)
    close(c_t.k, c_r.k)
    close(c_t.v, c_r.v)


# ---- the scoring forward ----

@pytest.mark.parametrize("S", [24, 40])
@pytest.mark.parametrize("flash", [True, False])
def test_loss_matches_repro(ref_model, ref_params, repro_flash_interpret,
                            flash, S):
    model, params = port(ref_params, flash)
    batch = tokens(S, 2, S)
    r_loss, r_metrics = RModel(rcfg(flash)).loss(
        ref_params, {"tokens": jnp.asarray(batch)})
    with torch.no_grad():
        loss, metrics = model.loss(params, {"tokens": torch.from_numpy(batch)})
        direct, _ = t_lm.lm_loss(model.cfg, params,
                                 {"tokens": torch.from_numpy(batch)})
    assert loss.dtype == torch.float32 and loss.shape == ()
    close(loss, r_loss)
    assert float(direct) == float(loss)
    assert float(metrics["tokens"]) == float(r_metrics["tokens"]) == \
        2 * (S - 1)
    assert float(metrics["aux_loss"]) == float(r_metrics["aux_loss"]) == 0.0


def test_flash_and_plain_losses_agree(ref_params):
    """Across the flag only the attention's roundings differ."""
    batch = {"tokens": torch.from_numpy(tokens(5, 2, 33))}
    with torch.no_grad():
        on = port(ref_params, True)
        off = port(ref_params, False)
        close(on[0].loss(on[1], batch)[0], off[0].loss(off[1], batch)[0])


def test_forward_train_matches_repro(ref_params, repro_flash_interpret):
    model, params = port(ref_params)
    batch = tokens(7, 2, 16)
    logits, aux = t_lm.forward_train(model.cfg, params,
                                     torch.from_numpy(batch))
    r_logits, _ = r_lm.forward_train(rcfg(True), ref_params,
                                     jnp.asarray(batch))
    assert logits.shape == (2, 16, 512) and logits.dtype == torch.float32
    close(logits, r_logits)
    assert float(aux) == 0.0


def test_loss_refuses_gradients_through_the_kernel(ref_params):
    model, params = port(ref_params)
    params["blocks"]["mixer"]["q"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(params, {"tokens": torch.from_numpy(tokens(0, 1, 8))})
    with torch.no_grad():
        model.loss(params, {"tokens": torch.from_numpy(tokens(0, 1, 8))})


def test_prefill_matches_train_forward(ref_params):
    """Serving's prefill (plain attention) against the scoring forward
    through the flash path, at the last prompt position."""
    model, params = port(ref_params)
    batch = torch.from_numpy(tokens(8, 2, 16))
    full, _ = t_lm.forward_train(model.cfg, params, batch)
    last, caches, S = t_lm.prefill(model.cfg, params, batch, 32,
                                   caches=model.init_caches(2, 32,
                                                            torch.float32))
    assert S == 16
    close(last, full[:, -1])


def test_decode_matches_teacher_forcing(ref_params):
    model, params = port(ref_params)
    seq = torch.from_numpy(tokens(9, 1, 12))
    full, _ = t_lm.forward_train(model.cfg, params, seq)
    _, caches, _ = t_lm.prefill(model.cfg, params, seq[:, :4], 24,
                                caches=model.init_caches(1, 24,
                                                         torch.float32))
    for t in range(4, 12):
        logits, caches = t_lm.decode_step(model.cfg, params,
                                          seq[:, t:t + 1], t, caches)
        close(logits[0], full[0, t])


# ---- serving ----

def test_prefill_and_decode_match_repro(ref_model, ref_params):
    model, params = port(ref_params)
    batch = tokens(1, 2, 10)
    l_r, c_r = ref_model.prefill(ref_params, {"tokens": jnp.asarray(batch)},
                                 48)
    l_t, c_t = model.prefill(params, {"tokens": torch.from_numpy(batch)}, 48)
    assert l_t.dtype == torch.float32 and l_t.shape == (2, 512)
    close(l_t, l_r)
    assert c_t.k.shape == (2, 2, 48, 2, 16) and c_t.k.dtype == torch.bfloat16
    close_bf16(c_t.k, c_r.k)
    close_bf16(c_t.v, c_r.v)
    for step in range(3):
        tok = np.asarray(jnp.argmax(l_r, -1))[:, None]
        l_r, c_r = ref_model.decode_step(ref_params, jnp.asarray(tok),
                                         10 + step, c_r)
        l_t, c_t = model.decode_step(params, torch.tensor(tok), 10 + step,
                                     c_t)
        close(l_t, l_r)
        close_bf16(c_t.k, c_r.k)
        close_bf16(c_t.v, c_r.v)


def serve(engine, req_cls, n=5, prompt=8, new=8):
    rng = np.random.default_rng(0)
    reqs = [req_cls(rid, rng.integers(0, 512, size=prompt),
                    max_new_tokens=new) for rid in range(n)]
    for r in reqs:
        engine.submit(r)
    steps = engine.run_until_drained()
    return steps, [r.output for r in reqs], [r.done for r in reqs]


def test_serve_engine_matches_repro(ref_model, ref_params):
    r_engine = RServeEngine(ref_model, ref_params, batch_slots=2, max_seq=48,
                            prompt_len=8)
    r_out = serve(r_engine, RRequest)
    model, params = port(ref_params)
    engine = t_engine.ServeEngine(model, params, batch_slots=2, max_seq=48,
                                  prompt_len=8)
    assert serve(engine, t_engine.Request) == r_out
    assert engine.stats == r_engine.stats
    assert engine.stats["prefills"] == 5


def test_serve_engine_at_prompt_len_max_seq_matches_repro(ref_model,
                                                         ref_params):
    """Prompts fill the cache (prompt_len == max_seq 16), so every decode
    step writes at or past its end: `dynamic_update_slice` clamps the
    write onto the last row, and the port's in-place write clamps alike
    (it wrote nothing before)."""
    kw = dict(batch_slots=2, max_seq=16, prompt_len=16)
    r_engine = RServeEngine(ref_model, ref_params, **kw)
    r_out = serve(r_engine, RRequest, n=3, prompt=16, new=2)
    model, params = port(ref_params)
    engine = t_engine.ServeEngine(model, params, **kw)
    out = serve(engine, t_engine.Request, n=3, prompt=16, new=2)
    assert out == r_out
    assert out[1] == [[224, 191], [341, 361], [182, 333]]
    assert engine.stats == r_engine.stats


def test_engine_throughput_tokens_per_s(monkeypatch, ref_model, ref_params):
    """stats["tokens"] over the seconds since t0, floored at 1e-9 s, as
    `repro`'s engine computes it."""
    model, params = port(ref_params)
    engine = t_engine.ServeEngine(model, params, batch_slots=1, max_seq=16,
                                  prompt_len=4)
    r_engine = RServeEngine(ref_model, ref_params, batch_slots=1,
                            max_seq=16, prompt_len=4)
    engine.stats["tokens"] = r_engine.stats["tokens"] = 300
    for now, want in ((112.5, 200.0), (111.0, 3e11)):
        monkeypatch.setattr(t_engine.time, "time", lambda: now)
        import repro.serve.engine as r_engine_mod
        monkeypatch.setattr(r_engine_mod.time, "time", lambda: now)
        assert engine.throughput_tokens_per_s(111.0) == pytest.approx(want)
        assert engine.throughput_tokens_per_s(111.0) == \
            r_engine.throughput_tokens_per_s(111.0)


def test_launcher_serves_qwen3_on_the_cpu(capsys):
    stats = t_launch.main(["--arch", "qwen3-1.7b", "--requests", "5",
                           "--slots", "2", "--max-new", "8",
                           "--prompt-len", "8", "--max-seq", "48",
                           "--device", "cpu"])
    assert stats["prefills"] == 5
    assert stats["tokens"] >= 5 * (8 + 7)
    assert "arch=qwen3-1.7b device=cpu" in capsys.readouterr().out


# ---- parameters and configuration ----

def test_params_from_numpy_takes_the_dense_leaves(ref_model, ref_params):
    model, params = port(ref_params, dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, ref_params)
    paths = [path for path, _ in leaves(model.spec)]
    assert paths == [
        "blocks/ffn/wi0", "blocks/ffn/wi1", "blocks/ffn/wo",
        "blocks/mixer/k", "blocks/mixer/k_norm", "blocks/mixer/o",
        "blocks/mixer/q", "blocks/mixer/q_norm", "blocks/mixer/v",
        "blocks/norm1", "blocks/norm2", "embed/final_norm", "embed/head",
        "embed/tok"]
    for path in paths:
        got, want = params, tree
        for k in path.split("/"):
            got, want = got[k], want[k]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32))
    assert len(jax.tree.leaves(tree)) == len(paths)
    assert model.n_params() == ref_model.n_params()


def test_full_config_counts_repro_parameters():
    """The full-width spec without materializing it: 2,031,739,904."""
    assert CONFIG == dataclasses.replace(CONFIG, **{
        f.name: getattr(R_CONFIG, f.name)
        for f in dataclasses.fields(R_CONFIG)})
    assert t_base.get_config("qwen3-1.7b") == CONFIG
    assert t_base.get_smoke_config("qwen3-1.7b") == smoke_config()
    assert build_model(CONFIG, "cpu").n_params() == \
        RModel(R_CONFIG).n_params() == 2_031_739_904

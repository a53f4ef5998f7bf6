"""Parity of the port's MoE family (granite-moe-1b-a400m) with `repro`'s.

Parameters come from `repro`'s `Model.init` and cross over through
`convert.params_from_numpy`; tokens and activations come from numpy with
fixed seeds.  `repro` runs as its own tests run it, op by op; where its
attention reaches the Pallas flash kernel (`use_flash_kernel=True`), the
kernel's wrapper is patched to `interpret=True`.  `repro`'s router uses
`lax.top_k` whatever the flag; the port's takes the gating kernel's
plain version on the CPU with the flag on, and the same plain version
called directly with it off.

Tolerances: rtol = atol = 1e-5 at float32 (float32 sums in other
orders); the bfloat16 K/V caches within one bfloat16 ulp plus that
(|a − b| ≤ 2⁻⁷·|b| + 1e-5).  The bfloat16 `moe_apply` test holds the
port to |a − b| ≤ 2⁻⁷·|b| + 2⁻¹⁰·max |b| at every element: the slot
arithmetic is the reference's to the bit, and what remains is a rare
different rounding of a bfloat16 einsum (summed in another order); with
integer slot counts the same inputs miss it at more than 100 elements
(the test shows both).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.kernels.flash_attention.ops as r_fa_ops  # noqa: E402
from repro.configs.granite_moe_1b_a400m import CONFIG as R_CONFIG  # noqa: E402
from repro.configs.granite_moe_1b_a400m import smoke_config as r_smoke  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro.serve.engine import Request as RRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs.granite_moe_1b_a400m import CONFIG, smoke_config  # noqa: E402
from repro_torch.kernels.moe_gating import kernel as t_gating  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
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


@pytest.fixture(scope="module")
def ref_params_bf16(ref_model):
    return ref_model.init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)


@pytest.fixture
def repro_flash_interpret(monkeypatch):
    """`repro`'s flash kernel in interpret mode, patched from outside."""
    monkeypatch.setattr(r_fa_ops, "flash_attention", functools.partial(
        r_fa_ops.flash_attention, interpret=True))


def tcfg(flash=True):
    return dataclasses.replace(smoke_config(), use_flash_kernel=flash)


def rcfg(flash=True):
    return dataclasses.replace(r_smoke(), use_flash_kernel=flash)


def port(params, flash=True, dtype=torch.float32):
    model = build_model(tcfg(flash), "cpu")
    tree = jax.tree.map(np.asarray, params)
    return model, convert.params_from_numpy(tree, model.spec, "cpu", dtype)


def ffn(params, dtype=torch.float32):
    """Layer 0's MoE parameters: numpy for `repro`, tensors for the port
    (bfloat16 carried over by its bits)."""
    p = jax.tree.map(lambda a: np.asarray(a)[0], params["blocks"]["ffn"])
    return p, {k: convert._tensor(v).to(dtype) for k, v in p.items()}


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


# ---- the router and the MoE layer ----

@pytest.mark.parametrize("flash", [True, False])
def test_router_topk_matches_repro(ref_params, flash):
    p, tp = ffn(ref_params)
    x = activations(1, 40, 64)
    gate, idx, aux = t_moe.router_topk(tcfg(flash), tp, torch.from_numpy(x))
    r_gate, r_idx, r_aux = r_moe.router_topk(rcfg(flash), p, jnp.asarray(x))
    assert gate.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    close(gate, r_gate)
    close(aux, r_aux)
    g2, i2, none = t_moe.router_topk(tcfg(flash), tp, torch.from_numpy(x),
                                     need_aux=False)
    assert none is None and torch.equal(g2, gate) and torch.equal(i2, idx)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("S", [16, 600])
def test_moe_apply_matches_repro(ref_params, S, flash):
    """S 16: one group of 16; S 600: groups of 512, padded by 424, padded
    tokens dispatched nowhere."""
    p, tp = ffn(ref_params)
    x = activations(S, 2, S, 64)
    y, aux = t_moe.moe_apply(tcfg(flash), tp, torch.from_numpy(x))
    r_y, r_aux = r_moe.moe_apply(rcfg(flash), p, jnp.asarray(x))
    assert y.shape == (2, S, 64) and y.dtype == torch.float32
    close(y, r_y)
    close(aux, r_aux)


@pytest.mark.parametrize("L", [1, 8, 16, 17, 1024, 1200, 4096, 4101])
def test_scan_sum_is_jnp_cumsum_bitwise(L):
    """0/1 columns (one-hot choices) summed along the axis: in bfloat16,
    every partial sum past 256 rounds, in XLA's order; in float32 exact."""
    a = (np.random.default_rng(L).random((2, L, 3)) < 0.6).astype(np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = np.asarray(jnp.cumsum(jnp.asarray(a).astype(jdt), axis=1),
                          np.float32)
        got = t_moe.scan_sum(torch.from_numpy(a).to(tdt), dim=1)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.array_equal(np.asarray(jnp.cumsum(jnp.asarray(a), axis=1)),
                          np.cumsum(a, axis=1))


def bf16_moe_misses(ref_params_bf16, seed):
    """Elements of the port's bf16 `moe_apply` beyond the stated tolerance
    against `repro`'s, on the smoke config at S 512 (one group, C 320)."""
    p, tp = ffn(ref_params_bf16, torch.bfloat16)
    x = activations(seed, 1, 512, 64)
    r_y, r_aux = r_moe.moe_apply(r_smoke(), p,
                                 jnp.asarray(x).astype(jnp.bfloat16))
    y, aux = t_moe.moe_apply(tcfg(), tp, torch.from_numpy(x)
                             .to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    close(aux, r_aux)
    got, want = y.float().numpy(), np.asarray(r_y, np.float32)
    bound = 2.0 ** -7 * np.abs(want) + 2.0 ** -10 * np.abs(want).max()
    return int((np.abs(got - want) > bound).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_apply_bf16_keeps_the_reference_slot_arithmetic(
        ref_params_bf16, monkeypatch, seed):
    """In bfloat16 the slot count is rounded past 256, so two choices can
    share a slot below C = 320 and the reference adds both tokens into it.
    The port keeps those collisions: it agrees within the stated
    tolerance, and with exact integer counts in place of the rounded ones
    it would not."""
    p, _ = ffn(ref_params_bf16)
    x = jnp.asarray(activations(seed, 512, 64)).astype(jnp.bfloat16)
    _, idx, _ = r_moe.router_topk(r_smoke(), p, x)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=4)
    assert counts.max() > 256, counts          # collisions are exercised
    assert bf16_moe_misses(ref_params_bf16, seed) == 0
    monkeypatch.setattr(t_moe, "scan_sum",
                        lambda v, dim: torch.cumsum(v.float(), dim=dim))
    assert bf16_moe_misses(ref_params_bf16, seed) > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_apply_bf16_takes_one_cumsum_where_slots_are_exact(
        ref_params_bf16, monkeypatch, seed):
    """S 409 in one group: C 255, the largest C below 256.  Tokens leaning
    towards expert 0 give it all 409 tokens, so its counts pass 256 and
    round (in another order in `torch.cumsum` than in XLA's scan); no such
    count can keep a slot, so the layer through one `torch.cumsum` is bitwise the
    layer through `scan_sum`, and agrees with `repro` within the bf16
    bound of the S 512 test."""
    p, tp = ffn(ref_params_bf16, torch.bfloat16)
    router = np.asarray(p["router"], np.float32)[:, 0]
    x = activations(seed, 1, 409, 64) + 4.0 * router / np.linalg.norm(router)
    _, idx, _ = r_moe.router_topk(r_smoke(), p, jnp.asarray(x[0])
                                  .astype(jnp.bfloat16))
    onehot = torch.nn.functional.one_hot(
        torch.from_numpy(np.asarray(idx)).long(), 4).to(torch.bfloat16)
    onehot = onehot.reshape(1, -1, 4)
    assert int(onehot.sum((0, 1)).max()) > 256
    rounded = torch.cumsum(onehot, 1).float()     # counts past 256 round
    assert not torch.equal(rounded, torch.cumsum(onehot.float(), 1))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    used = []
    monkeypatch.setattr(t_moe, "scan_sum", lambda v, dim: used.append(1))
    y, _ = t_moe.moe_apply(tcfg(), tp, xt)
    assert used == []                               # one torch.cumsum
    monkeypatch.undo()
    monkeypatch.setattr(t_moe, "expert_counts",
                        lambda v, C: t_moe.scan_sum(v, dim=1))
    y_scan, _ = t_moe.moe_apply(tcfg(), tp, xt)
    assert torch.equal(y, y_scan)
    r_y, _ = r_moe.moe_apply(r_smoke(), p, jnp.asarray(x).astype(jnp.bfloat16))
    want = np.asarray(r_y, np.float32)
    bound = 2.0 ** -7 * np.abs(want) + 2.0 ** -10 * np.abs(want).max()
    assert np.all(np.abs(y.float().numpy() - want) <= bound)


def test_silu_rounds_as_the_reference_does():
    """In bf16, `jax.nn.silu` on the CPU rounds at each step, eagerly and
    under `jit` alike; `moe.silu` does the same, `F.silu` rounds once."""
    a = activations(3, 4096)
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    want = np.asarray(jax.nn.silu(ja), np.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(jax.nn.silu)(ja),
                                             np.float32), want)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    got = t_moe.silu(ta).float().numpy()
    assert (got != want).sum() <= 4      # exp's float32 last bit, rarely
    assert (torch.nn.functional.silu(ta).float().numpy() != want).sum() > 400
    close(t_moe.silu(torch.from_numpy(a)), jax.nn.silu(jnp.asarray(a)))


# ---- the scoring forward ----

def test_forward_train_matches_repro(ref_params, repro_flash_interpret):
    model, params = port(ref_params)
    batch = tokens(7, 2, 16)
    with torch.no_grad():
        logits, aux = t_lm.forward_train(model.cfg, params,
                                         torch.from_numpy(batch))
    r_logits, r_aux = r_lm.forward_train(rcfg(), ref_params,
                                         jnp.asarray(batch))
    assert logits.shape == (2, 16, 512) and logits.dtype == torch.float32
    close(logits, r_logits)
    assert float(aux) > 0
    close(aux, r_aux)


@pytest.mark.parametrize("S", [24, 40])
@pytest.mark.parametrize("flash", [True, False])
def test_loss_matches_repro(ref_params, repro_flash_interpret, flash, S):
    """`lm_loss` adds router_aux_coef · (the layers' summed aux loss)."""
    model, params = port(ref_params, flash)
    batch = tokens(S, 2, S)
    r_loss, r_metrics = RModel(rcfg(flash)).loss(
        ref_params, {"tokens": jnp.asarray(batch)})
    with torch.no_grad():
        loss, metrics = model.loss(params, {"tokens": torch.from_numpy(batch)})
    close(loss, r_loss)
    close(metrics["loss"], r_metrics["loss"])
    close(metrics["aux_loss"], r_metrics["aux_loss"])
    assert float(metrics["aux_loss"]) > 0
    assert float(metrics["tokens"]) == float(r_metrics["tokens"]) == \
        2 * (S - 1)


def test_loss_refuses_gradients_through_the_router_kernel(ref_params):
    model, params = port(ref_params)
    params["blocks"]["ffn"]["router"].requires_grad_()
    batch = {"tokens": torch.from_numpy(tokens(0, 1, 8))}
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(params, batch)
    with torch.no_grad():
        model.loss(params, batch)
    off, off_params = port(ref_params, flash=False)
    off_params["blocks"]["ffn"]["router"].requires_grad_()
    off.loss(off_params, batch)[0].backward()
    assert off_params["blocks"]["ffn"]["router"].grad is not None


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


@pytest.mark.parametrize("flash", [True, False])
def test_serve_engine_matches_repro(ref_model, ref_params, flash):
    r_engine = RServeEngine(ref_model, ref_params, batch_slots=2, max_seq=48,
                            prompt_len=8)
    r_out = serve(r_engine, RRequest)
    model, params = port(ref_params, flash)
    engine = t_engine.ServeEngine(model, params, batch_slots=2, max_seq=48,
                                  prompt_len=8)
    assert serve(engine, t_engine.Request) == r_out
    assert engine.stats == r_engine.stats
    assert engine.stats["prefills"] == 5


@pytest.mark.parametrize("flash", [True, False])
def test_serve_engine_at_prompt_len_max_seq_matches_repro(ref_model,
                                                         ref_params, flash):
    """Prompts fill the cache (prompt_len == max_seq 16), so every decode
    step writes at or past its end, where the reference's
    `dynamic_update_slice` clamps the write onto the last row; the port's
    attention clamps alike (it wrote nothing before)."""
    kw = dict(batch_slots=2, max_seq=16, prompt_len=16)
    r_engine = RServeEngine(ref_model, ref_params, **kw)
    r_out = serve(r_engine, RRequest, n=3, prompt=16, new=2)
    model, params = port(ref_params, flash)
    engine = t_engine.ServeEngine(model, params, **kw)
    assert serve(engine, t_engine.Request, n=3, prompt=16, new=2) == r_out
    assert engine.stats == r_engine.stats


@pytest.mark.parametrize("flash,interpret", [(True, False), (False, False),
                                             (True, True)])
def test_engine_routes_once_per_layer_per_step(monkeypatch, ref_params,
                                               flash, interpret):
    """With the flag on, every prefill and every decode step calls the
    gating op once per layer, on the whole batch of the step (on the card
    each call is one kernel launch), passing the model's interpret flag;
    with it off never: the router takes the plain version."""
    calls = []
    real = t_moe.fused_gating

    def spy(logits, top_k, interpret=False):
        calls.append(tuple(logits.shape))
        assert interpret == model.interpret
        return real(logits, top_k, interpret=interpret)

    monkeypatch.setattr(t_moe, "fused_gating", spy)
    _, params = port(ref_params, flash)
    model = build_model(tcfg(flash), "cpu", interpret=interpret)
    engine = t_engine.ServeEngine(model, params, batch_slots=2, max_seq=48,
                                  prompt_len=8)
    before = t_gating.gating_topk.launches
    out = serve(engine, t_engine.Request)
    steps = engine.stats["prefills"] + engine.stats["decode_steps"]
    assert t_gating.gating_topk.launches == before      # the CPU: plain
    if not flash:
        assert calls == []
        model_on, params_on = port(ref_params, True)
        assert out == serve(t_engine.ServeEngine(
            model_on, params_on, batch_slots=2, max_seq=48, prompt_len=8),
            t_engine.Request)
        return
    assert len(calls) == 2 * steps
    assert calls.count((8, 4)) == 2 * engine.stats["prefills"]
    assert calls.count((2, 4)) == 2 * engine.stats["decode_steps"]


def test_launcher_serves_granite_by_default_on_the_cpu(capsys):
    stats = t_launch.main(["--requests", "3", "--slots", "2", "--max-new",
                           "4", "--prompt-len", "8", "--max-seq", "24",
                           "--device", "cpu"])
    assert stats["prefills"] == 3
    assert "arch=granite-moe-1b-a400m device=cpu" in capsys.readouterr().out


# ---- parameters and configuration ----

def test_params_from_numpy_takes_the_moe_leaves(ref_model, ref_params):
    model, params = port(ref_params, dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, ref_params)
    paths = [path for path, _ in leaves(model.spec)]
    assert paths == [
        "blocks/ffn/router", "blocks/ffn/wi0", "blocks/ffn/wi1",
        "blocks/ffn/wo", "blocks/mixer/k", "blocks/mixer/o",
        "blocks/mixer/q", "blocks/mixer/v", "blocks/norm1", "blocks/norm2",
        "embed/final_norm", "embed/head", "embed/tok"]
    assert tuple(params["blocks"]["ffn"]["wi0"].shape) == (2, 4, 64, 64)
    assert tuple(params["blocks"]["ffn"]["wo"].shape) == (2, 4, 64, 64)
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
    """The full-width spec without materializing it: 1,384,963,072, with
    the expert weights [24, 32, 1024, 512] and [24, 32, 512, 1024]."""
    assert CONFIG == dataclasses.replace(CONFIG, **{
        f.name: getattr(R_CONFIG, f.name)
        for f in dataclasses.fields(R_CONFIG)})
    assert t_base.get_config("granite-moe-1b-a400m") == CONFIG
    assert t_base.get_smoke_config("granite-moe-1b-a400m") == smoke_config()
    spec = dict(leaves(build_model(CONFIG, "cpu").spec))
    assert spec["blocks/ffn/wi0"].shape == (24, 32, 1024, 512)
    assert spec["blocks/ffn/wo"].shape == (24, 32, 512, 1024)
    assert build_model(CONFIG, "cpu").n_params() == \
        RModel(R_CONFIG).n_params() == 1_384_963_072

"""Parity of the port's Mamba2 serving path with `repro`'s.

Parameters come from `repro`'s `Model.init` and cross over through
`convert.params_from_numpy`; prompts and activations come from numpy with
fixed seeds.  At `smoke_config()`:

* with float32 parameters the mixer (`ssm_apply`, `ssm_decode_step`), the
  model (`prefill`, `decode_step`) and the caches agree with `repro` at
  rtol = atol = 1e-5 (float32 sums in other orders; measured ≤ 2.3e-6),
  with the port's kernel path (`use_flash_kernel=True`, its plain version
  on the CPU) and its `_ssd_chunked` path alike; `repro` runs
  `_ssd_chunked`, since its Pallas kernel needs a TPU outside interpret
  mode;
* with bfloat16 parameters, prefill logits agree with `repro` at atol
  0.1 (measured 0.027 on logits up to 3.25) and the SSM state within 5%
  in L2 norm (measured 1.3%): bfloat16 rounds at other places in the two
  frameworks, and the kernel path forms C·B in float32 where
  `_ssd_chunked` forms it in bfloat16;
* the whole `ServeEngine`, 5 requests over 2 slots (the traffic of
  `tests/test_launchers.py::test_serve_launcher`), gives `repro`'s token
  streams and stats exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs.mamba2_2p7b import CONFIG as R_CONFIG  # noqa: E402
from repro.configs.mamba2_2p7b import smoke_config as r_smoke  # noqa: E402
from repro.models import ssm as r_ssm  # noqa: E402
from repro.models.api import Model as RModel  # noqa: E402
from repro.serve.engine import Request as RRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs.mamba2_2p7b import CONFIG, smoke_config  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 0.1
BF16_STATE_RTOL = 0.05
SPLIT_LOGIT_ATOL = 1e-2


@pytest.fixture(scope="module")
def ref_model():
    return RModel(r_smoke())


@pytest.fixture(scope="module")
def ref_params_f32(ref_model):
    return ref_model.init(jax.random.PRNGKey(0), dtype=jnp.float32)


def port(flash, params, dtype=torch.float32, **cfg_overrides):
    cfg = dataclasses.replace(smoke_config(), use_flash_kernel=flash,
                              **cfg_overrides)
    model = build_model(cfg, "cpu")
    tree = jax.tree.map(np.asarray, params)
    return model, convert.params_from_numpy(tree, model.spec, "cpu", dtype)


def layer(tree, i):
    return jax.tree.map(lambda a: np.asarray(a)[i], tree)


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("S,chunk", [(12, 128), (12, 8)])   # Q = S; pad 4
def test_ssm_apply_and_decode_match_repro(ref_params_f32, flash, S, chunk):
    rcfg = dataclasses.replace(r_smoke(), ssm_chunk=chunk)
    cfg = dataclasses.replace(smoke_config(), ssm_chunk=chunk,
                              use_flash_kernel=flash)
    p_np = layer(ref_params_f32["blocks"]["mixer"], 1)
    p_t = {k: torch.tensor(v) for k, v in p_np.items()}
    x = np.random.default_rng(S + chunk).standard_normal(
        (2, S, rcfg.d_model)).astype(np.float32)
    r_cache = r_ssm.init_ssm_cache(rcfg, 2)
    t_cache = t_ssm.init_ssm_cache(cfg, 2)

    y_r, c_r = r_ssm.ssm_apply(rcfg, p_np, jnp.asarray(x), r_cache)
    y_t, c_t = t_ssm.ssm_apply(cfg, p_t, torch.from_numpy(x), t_cache)
    close(y_t, y_r)
    assert c_t.conv.dtype == torch.bfloat16 and c_t.h.dtype == torch.float32
    close(c_t.conv, c_r.conv)
    close(c_t.h, c_r.h)
    y0_t, none = t_ssm.ssm_apply(cfg, p_t, torch.from_numpy(x))
    assert none is None
    close(y0_t, y_r)

    x1 = x[:, :1] * 0.5
    d_r, dc_r = r_ssm.ssm_decode_step(rcfg, p_np, jnp.asarray(x1), c_r)
    d_t, dc_t = t_ssm.ssm_decode_step(cfg, p_t, torch.from_numpy(x1), c_t)
    close(d_t, d_r)
    close(dc_t.conv, dc_r.conv)
    close(dc_t.h, dc_r.h)


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_and_decode_match_repro(ref_model, ref_params_f32, flash):
    model, params = port(flash, ref_params_f32)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 10))
    l_r, c_r = ref_model.prefill(ref_params_f32,
                                 {"tokens": jnp.asarray(tokens)}, 48)
    l_t, c_t = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, 48)
    assert l_t.dtype == torch.float32 and l_t.shape == (2, 512)
    close(l_t, l_r)
    assert c_t.conv.shape == (2, 2, 3, 128 + 32) and \
        c_t.h.shape == (2, 2, 8, 16, 16)
    close(c_t.conv, c_r.conv)
    close(c_t.h, c_r.h)
    for step in range(3):
        tok = np.asarray(jnp.argmax(l_r, -1))[:, None]
        l_r, c_r = ref_model.decode_step(ref_params_f32, jnp.asarray(tok),
                                         10 + step, c_r)
        l_t, c_t = model.decode_step(params, torch.tensor(tok),
                                     10 + step, c_t)
        close(l_t, l_r)
        close(c_t.h, c_r.h)


def test_bfloat16_prefill_matches_repro(ref_model):
    params = ref_model.init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    model, t_params = port(True, params, torch.bfloat16)
    assert t_params["blocks"]["mixer"]["in_x"].dtype == torch.bfloat16
    tokens = np.random.default_rng(2).integers(0, 512, (1, 8))
    l_r, c_r = ref_model.prefill(params, {"tokens": jnp.asarray(tokens)}, 48)
    l_t, c_t = model.prefill(t_params, {"tokens": torch.from_numpy(tokens)},
                             48)
    close(l_t, l_r, rtol=0, atol=BF16_ATOL)
    h_r = np.asarray(c_r.h)
    assert np.linalg.norm(c_t.h.numpy() - h_r) <= \
        BF16_STATE_RTOL * np.linalg.norm(h_r)


def test_loss_refuses_gradients_through_the_kernel(ref_params_f32):
    """With use_flash_kernel=True the mixer's scan is `ssd_scan`, which
    has no backward (nor has the reference's): the loss raises under grad
    and runs under no_grad."""
    model, params = port(True, ref_params_f32)
    params["blocks"]["mixer"]["in_x"].requires_grad_()
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, 512, (1, 12)))}
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(params, batch)
    with torch.no_grad():
        loss, _ = model.loss(params, batch)
    assert torch.isfinite(loss)


def serve(engine, req_cls, vocab):
    rng = np.random.default_rng(0)
    reqs = [req_cls(rid, rng.integers(0, vocab, size=8), max_new_tokens=8)
            for rid in range(5)]
    for r in reqs:
        engine.submit(r)
    steps = engine.run_until_drained()
    return steps, [r.output for r in reqs], [r.done for r in reqs]


@pytest.mark.parametrize("flash", [True, False])
def test_serve_engine_matches_repro(ref_model, ref_params_f32, flash):
    r_engine = RServeEngine(ref_model, ref_params_f32, batch_slots=2,
                            max_seq=48, prompt_len=8)
    r_out = serve(r_engine, RRequest, 512)
    model, params = port(flash, ref_params_f32)
    engine = ServeEngine(model, params, batch_slots=2, max_seq=48,
                         prompt_len=8)
    out = serve(engine, Request, 512)
    assert out == r_out
    assert engine.stats == r_engine.stats
    assert engine.stats["prefills"] == 5


def test_prompts_are_left_padded_and_truncated(ref_params_f32):
    """A short prompt is left-padded with zeros and a long one keeps its
    last `prompt_len` tokens, so these three serve the same stream."""
    model, params = port(True, ref_params_f32)
    outs = []
    for prompt in ([5, 6, 7], [0] * 5 + [5, 6, 7],
                   [9, 9] + [0] * 5 + [5, 6, 7]):
        engine = ServeEngine(model, params, batch_slots=1, max_seq=48,
                             prompt_len=8)
        req = Request(0, np.asarray(prompt), max_new_tokens=4)
        engine.submit(req)
        engine.run_until_drained()
        assert req.done and len(req.output) == 4
        assert engine.stats["tokens"] == 8 + 3
        outs.append(req.output)
    assert outs[0] == outs[1] == outs[2]


def test_launcher_serves_on_the_cpu(capsys):
    stats = t_launch.main(["--arch", "mamba2-2.7b", "--requests", "5",
                           "--slots", "2", "--max-new", "8",
                           "--prompt-len", "8", "--max-seq", "48",
                           "--device", "cpu"])
    assert stats["prefills"] == 5
    assert stats["tokens"] >= 5 * (8 + 7)
    assert "device=cpu" in capsys.readouterr().out


def test_params_from_numpy_round_trips(ref_model, ref_params_f32):
    model, params = port(True, ref_params_f32, torch.bfloat16)
    tree = jax.tree.map(np.asarray, ref_params_f32)
    n = 0
    for path, p in leaves(model.spec):
        got, want = params, tree
        for k in path.split("/"):
            got, want = got[k], want[k]
        assert got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape == p.shape
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32))
        n += 1
    assert n == len(jax.tree.leaves(tree)) == 17
    assert model.n_params() == ref_model.n_params()


@pytest.mark.parametrize("break_it", ["shape", "missing", "extra"])
def test_params_from_numpy_rejects_a_mismatched_tree(ref_params_f32,
                                                     break_it):
    model = build_model(smoke_config(), "cpu")
    tree = jax.tree.map(np.asarray, ref_params_f32)
    tree = {k: dict(v) for k, v in tree.items()}
    tree["blocks"]["mixer"] = dict(tree["blocks"]["mixer"])
    if break_it == "shape":
        tree["blocks"]["mixer"]["in_b"] = np.zeros((2, 64, 8), np.float32)
        err = ValueError
    elif break_it == "missing":
        del tree["embed"]["head"]
        err = KeyError
    else:
        tree["embed"]["bias"] = np.zeros((64,), np.float32)
        err = ValueError
    with pytest.raises(err):
        convert.params_from_numpy(tree, model.spec, "cpu")


def test_full_config_counts_repro_parameters():
    """The full-width spec without materializing it: 2,830,951,936."""
    assert CONFIG == dataclasses.replace(CONFIG, **{
        f.name: getattr(R_CONFIG, f.name)
        for f in dataclasses.fields(R_CONFIG)})
    assert build_model(CONFIG, "cpu").n_params() == \
        RModel(R_CONFIG).n_params() == 2_830_951_936


def test_init_follows_the_reference_distributions():
    model = build_model(smoke_config(), "cpu")
    p = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    mixer = p["blocks"]["mixer"]
    assert torch.equal(mixer["a_log"], torch.ones(2, 8))
    assert torch.equal(mixer["dt_bias"], torch.zeros(2, 8))
    # normal × 1/sqrt(fan_in), fan_in = shape[-2] after stacking
    assert abs(float(mixer["in_x"].std()) * 64 ** 0.5 - 1) < 0.05
    assert abs(float(mixer["conv_x"].std()) / 0.5 - 1) < 0.05
    assert abs(float(p["embed"]["tok"].std()) - 1) < 0.05
    again = model.init(torch.Generator().manual_seed(0), torch.float32)
    assert torch.equal(again["embed"]["head"], p["embed"]["head"])


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-small"])
def test_unported_architectures_raise(arch):
    """The last two architectures to be ported resolve now, so every id
    of ARCH_IDS is PORTED; an id that is none of them raises."""
    assert sorted(t_base.PORTED) == sorted(t_base.ARCH_IDS)
    assert t_base.get_config(arch).name == arch
    with pytest.raises(KeyError, match=arch):
        t_base.get_config(arch + "-x")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(smoke_config())
    with pytest.raises(ValueError, match="encdec"):
        t_lm.lm_spec(dataclasses.replace(smoke_config(), family="audio"))


def test_bfloat16_prefill_through_the_tensor_core_plain_version(
        ref_model, monkeypatch):
    """bf16 prefill with the intra-chunk pass the tensor-core kernel's
    plain version (`split_intra_chunk`, the card's arithmetic) in place of
    the reference's function: repro's logits and state within the bf16
    tolerances above, the same first tokens, and the reference-function
    run's logits within SPLIT_LOGIT_ATOL (measured 0 here: the two
    intra-chunk passes differ by ~1e-6 of y, below what moves a bf16
    activation of this model)."""
    from repro_torch.kernels.ssd_scan import ops as t_ssd_ops
    from repro_torch.kernels.ssd_scan import ref as t_ssd_ref
    params = ref_model.init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    model, t_params = port(True, params, torch.bfloat16)
    tokens = np.random.default_rng(2).integers(0, 512, (2, 40))
    batch = {"tokens": torch.from_numpy(tokens)}
    l_plain, _ = model.prefill(t_params, batch, 48)
    monkeypatch.setattr(t_ssd_ops, "reference_intra_chunk",
                        t_ssd_ref.split_intra_chunk)
    l_t, c_t = model.prefill(t_params, batch, 48)
    l_r, c_r = ref_model.prefill(params, {"tokens": jnp.asarray(tokens)}, 48)
    close(l_t, l_r, rtol=0, atol=BF16_ATOL)
    h_r = np.asarray(c_r.h)
    assert np.linalg.norm(c_t.h.numpy() - h_r) <= \
        BF16_STATE_RTOL * np.linalg.norm(h_r)
    close(l_t, l_plain.numpy(), rtol=0, atol=SPLIT_LOGIT_ATOL)
    assert torch.equal(l_t.argmax(-1), l_plain.argmax(-1))

"""Parity of the port's per-pair throughput API
(`repro_torch.core.throughput`) with `repro.core.throughput`.

Held bitwise: the per-token costs of Eqs. 6–9 (the same float32
operations, one rounding each, in the same order) and their float32
result type, and the locality integers of Eq. 12.  Held to rtol 1e-6,
the float32 tolerance of a reduction: the scalar `tps_prefill`,
`tps_decode`, `tps_request` and `tps_per_watt` and the `bottleneck`
terms, for every Table 2 model on Kyber 2028 racks and pods (1 and 5
racks, MED and HIGH), in both modes.  `tps_request` sums 256 decode
terms: `repro` with `jnp.sum` in XLA's order, the port with numpy's
pairwise sum.  The binding `bottleneck` term must be the same one.  The
port's [C, M] grid equals its scalar loop bitwise, and `repro`'s jitted
grid within rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import projections as r_proj  # noqa: E402
from repro.core import throughput as r_tp  # noqa: E402
from repro_torch.core import projections as t_proj  # noqa: E402
from repro_torch.core import throughput as t_tp  # noqa: E402

RTOL = 1e-6
MODELS = [m.name for m in r_tp.MODEL_SUITE]
MODES = ("additive", "min")


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def pair(name, n, scenario):
    """The same (model, deployment) pair in both packages."""
    return ((r_tp.MODELS[name], r_tp.Deployment(r_proj.KYBER, 2028, n,
                                                 scenario)),
            (t_tp.MODELS[name], t_tp.Deployment(t_proj.KYBER, 2028, n,
                                                 scenario)))


@pytest.mark.parametrize("name", MODELS)
def test_per_token_costs_bitwise(name):
    """Eqs. 6–9 at the prompt length, at decode positions and over an
    array of lengths, and Eqs. 10–12."""
    (rm, rd), (tm, td) = pair(name, 1, "med")
    ts = np.array([1.0, 8.0, 1025.0, 1280.0], np.float32)
    for t in (rm.S, 1, 1280, ts):
        assert same_bits(t_tp.c_prefill(tm, t), r_tp.c_prefill(rm, t))
        assert same_bits(t_tp.c_decode(tm, t), r_tp.c_decode(rm, t))
        assert same_bits(t_tp.m_decode(tm, t), r_tp.m_decode(rm, t))
        assert same_bits(t_tp.m_decode(tm, t, batch=32),
                         r_tp.m_decode(rm, t, batch=32))
    assert t_tp.m_prefill(tm, tm.S) == r_tp.m_prefill(rm, rm.S)
    assert t_tp.m_prefill(tm, 64, batch=8) == r_tp.m_prefill(rm, 64, batch=8)
    assert t_tp.n_tp(tm, 8) == r_tp.n_tp(rm, 8)
    assert t_tp.n_ep(tm) == r_tp.n_ep(rm)
    assert t_tp.n_domains(tm, td) == r_tp.n_domains(rm, rd)


def test_c_prefill_dtype_unified():
    """`c_*` cast their length to float32 whether it is a scalar or an
    array, as `tests/test_metric_stack.py` pins for `repro`; the tiny
    pair's hand-computed values hold."""
    tiny = t_tp.MoEModel("tiny", L=2, w=64, E=4, K=2, S=8)
    arr = t_tp.c_prefill(tiny, np.array([8.0, 16.0]))
    scl = t_tp.c_prefill(tiny, 8.0)
    assert arr.dtype == scl.dtype == t_tp.DTYPE
    assert float(arr[0]) == float(scl) == 296960.0
    assert float(t_tp.c_decode(tiny, 8)) == 296960.0
    assert t_tp.m_prefill(tiny, 8, batch=4) == 294912.0 / 32 + 128.0
    assert float(t_tp.m_decode(tiny, 3, batch=4)) == 163840.0 / 4 + 4 * 128.0


@pytest.mark.parametrize("scenario", ["med", "high"])
@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("name", MODELS)
def test_scalar_api_matches_repro(name, n, scenario):
    (rm, rd), (tm, td) = pair(name, n, scenario)
    for mode in MODES:
        for fn, args in (("tps_prefill", ()), ("tps_decode", (rm.S + 1,)),
                         ("tps_decode", (np.arange(1, 9) + rm.S,)),
                         ("tps_request", ()), ("tps_request", (64,))):
            got = getattr(t_tp, fn)(tm, td, *args, mode=mode)
            want = getattr(r_tp, fn)(rm, rd, *args, mode=mode)
            assert np.asarray(got).dtype == np.float32, fn
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                       err_msg=f"{fn} {mode}")
        np.testing.assert_allclose(t_tp.tps_per_watt(tm, td, mode=mode),
                                   r_tp.tps_per_watt(rm, rd, mode=mode),
                                   rtol=RTOL)
    for phase in ("pre", "dec"):
        key, terms = t_tp.bottleneck(tm, td, phase)
        r_key, r_terms = r_tp.bottleneck(rm, rd, phase)
        assert key == r_key, phase
        assert terms.keys() == r_terms.keys()
        for k in terms:
            np.testing.assert_allclose(terms[k], r_terms[k], rtol=RTOL)


def test_scalar_api_takes_a_cost_scale():
    """A calibrated `CostScale` scales the same terms in both packages."""
    (rm, rd), (tm, td) = pair("MoE-132T", 5, "high")
    r_sc, t_sc = r_tp.CostScale(1.7, 0.6, 2.5), t_tp.CostScale(1.7, 0.6, 2.5)
    np.testing.assert_allclose(t_tp.tps_request(tm, td, scale=t_sc),
                               np.asarray(r_tp.tps_request(rm, rd,
                                                           scale=r_sc)),
                               rtol=RTOL)
    for phase in ("pre", "dec"):
        assert t_tp.bottleneck(tm, td, phase, scale=t_sc)[0] == \
            r_tp.bottleneck(rm, rd, phase, scale=r_sc)[0]


@pytest.mark.parametrize("mode", MODES)
def test_grid_equals_scalar_loop_and_repro(mode):
    deps = [(r_tp.Deployment(r_proj.KYBER, 2028, n, s),
             t_tp.Deployment(t_proj.KYBER, 2028, n, s))
            for s in ("med", "high") for n in (1, 3, 5, 7)]
    t_deps = [d for _, d in deps]
    grid = t_tp.tps_request_grid(t_tp.MODEL_SUITE, t_deps, mode=mode)
    loop = np.array([[t_tp.tps_request(m, d, mode=mode)
                      for m in t_tp.MODEL_SUITE] for d in t_deps])
    assert grid.shape == (len(deps), len(MODELS))
    np.testing.assert_array_equal(grid, loop)
    want = r_tp.tps_request_grid(r_tp.MODEL_SUITE, [d for d, _ in deps],
                                 mode=mode)
    np.testing.assert_allclose(grid, np.asarray(want), rtol=RTOL)
    per_w = t_tp.tps_per_watt_grid(t_tp.MODEL_SUITE, t_deps, mode=mode)
    loop_w = np.array([[t_tp.tps_per_watt(m, d, mode=mode)
                        for m in t_tp.MODEL_SUITE] for d in t_deps])
    np.testing.assert_allclose(per_w, loop_w, rtol=RTOL)

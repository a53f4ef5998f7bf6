"""MoE inference throughput model (paper §5.4, Appendix A), host-side.

Three-resource min-bottleneck model per phase (Eq. 5):
    TPS^φ(m, D) = min( F_D / C^φ(m),  B_D^HBM / M^φ(m),  1 / T_comm^φ(m,D) )
with per-token compute/memory costs (Eqs. 6–9), TP/EP communication
(Eqs. 10–16) under the HBM-residency locality model (Eqs. 12–13), and
request-level aggregation (Eq. 17).

The counterpart of `repro.core.throughput`.  It is plain host math on a
handful of (model, deployment) pairs, so the `*_s` evaluators run in
numpy float32 over `PairStatics` of any leaf shape, operation for
operation as `repro`'s jnp evaluators.  A [C, M] grid of pairs is one
evaluation (`tps_request_grid`, `tps_per_watt_grid`: the sweep engines'
metric stage); the scalar API (`tps_prefill`, `tps_request`, …) is the
single-pair wrapper over the same evaluators.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np

from . import projections as proj

# Serving conventions (App. A.1): FP8 weights, FP4 activations/KV, B=256.
B_W = 1.0          # bytes / weight
B_ACT = 0.5        # bytes / activation element
B_KV = 0.5         # bytes / KV element
BATCH = 256
ALPHA_HBM = 0.7    # usable HBM fraction (Eq. 12)


@dataclass(frozen=True)
class MoEModel:
    """Appendix A.5, Table 2."""
    name: str
    L: int
    w: int
    E: int
    K: int = 2
    S: int = 1024          # evaluation context (= prompt) length

    @property
    def FF(self) -> int:
        return 4 * self.w

    @property
    def w_total_bytes(self) -> float:
        # all experts + shared attention:  L(4w² + E·2·w·FF)·b_w
        return self.L * (4 * self.w ** 2 + self.E * 2 * self.w * self.FF) * B_W

    @property
    def w_active_bytes(self) -> float:
        return self.L * (4 * self.w ** 2 + self.K * 2 * self.w * self.FF) * B_W


# Table 2 model suite (0.6T – 401T nominal).
MODEL_SUITE = (
    MoEModel("MoE-0.6T", 48, 6144, 64),
    MoEModel("MoE-5T", 96, 8192, 96),
    MoEModel("MoE-19T", 120, 12288, 128),
    MoEModel("MoE-51T", 120, 14336, 256),
    MoEModel("MoE-132T", 120, 16384, 512),
    MoEModel("MoE-401T", 144, 18432, 1024),
)
MODELS = {m.name: m for m in MODEL_SUITE}


@dataclass(frozen=True)
class Deployment:
    """A rack- or pod-scale accelerator deployment (App. B.1/B.2).

    Locality semantics (§6.5 / DESIGN.md §4): a *pod* deployment
    (`pod_fabric=True`, n_racks>1) exposes its constituent racks as one
    local high-bandwidth domain ("shared low-latency pod fabric", §5.2);
    rack-scale deployments keep Eq. 24's per-rack NVLink domain.  When a
    model needs more domains than the deployment provides, serving spans
    `n_units ≥ n_racks` co-scheduled units over the scale-out fabric.
    """
    arch: proj.DeploymentArch
    year: int
    n_racks: int = 1            # pod size (1 = rack-scale)
    scenario: str = proj.MED
    pod_fabric: bool = True     # pods form one local domain (§6.5)
    incast_penalty: bool = True  # remote EP shares B_IB across domain pairs

    @property
    def line(self) -> str:
        return "kyber" if self.arch is proj.KYBER else "oberon"

    @property
    def perf(self):
        return proj.pkg_perf(self.year, self.line)

    @property
    def domain_pkgs(self) -> int:
        """Packages per local high-bandwidth domain."""
        if self.pod_fabric and self.n_racks > 1:
            return self.arch.nvl_domain_pkgs * self.n_racks
        return self.arch.nvl_domain_pkgs

    def n_units(self, m: "MoEModel") -> int:
        """Racks/pods co-scheduled so the model fits in HBM (≥ n_racks)."""
        usable_per_rack = ALPHA_HBM * self.arch.n_pkg * self.hbm_pkg_bytes
        need = int(np.ceil(m.w_total_bytes / usable_per_rack))
        return max(self.n_racks, need)

    def n_pkg(self, m: "MoEModel") -> int:
        return self.arch.n_pkg * self.n_units(m)

    def f_flops(self, m: "MoEModel") -> float:      # Eq. 20 (FLOP/s)
        return self.n_pkg(m) * self.perf["flops_pf"] * 1e15

    def b_hbm(self, m: "MoEModel") -> float:        # Eq. 21 (bytes/s)
        return self.n_pkg(m) * self.perf["hbm_bw_tbps"] * 1e12

    @property
    def hbm_pkg_bytes(self) -> float:
        return self.perf["hbm_gb"] * 1e9

    @property
    def b_nvl(self) -> float:                        # per-domain (bytes/s)
        bw = self.arch.b_nvl_tbps * 1e12
        if self.pod_fabric and self.n_racks > 1:
            bw *= self.n_racks                       # pod fabric spine
        return bw

    def b_ib(self, m: "MoEModel") -> float:          # aggregate (bytes/s)
        return self.arch.b_ib_tbps * 1e12 * self.n_units(m)

    @property
    def tp_degree(self) -> int:                      # T_D
        return self.arch.nvl_domain_pkgs

    def power_w(self, m: "MoEModel" = None) -> float:   # Eq. 25
        rack_kw = proj.gpu_rack_kw(self.year, self.scenario,
                                   pod_scale=self.arch is proj.KYBER)
        n = self.n_racks if m is None else self.n_units(m)
        return rack_kw * n * 1e3


def serving_deployment(year: int, scenario: str, pod_racks: int = 1,
                       pod_scale: bool | None = None) -> Deployment:
    """The serving `Deployment` implied by a simulator operating point:
    the architecture in service for `year` (`projections
    .deployment_arch_for`, pod-scale Kyber racks when pods are in play)
    at the envelope's placement quantum.  Shared by the sweep engines'
    metric stage and `payoff`."""
    pod_racks = max(int(pod_racks), 1)
    pod_scale = pod_racks > 1 if pod_scale is None else bool(pod_scale)
    arch = proj.deployment_arch_for(year, pod_scale)
    return Deployment(arch, year, pod_racks, scenario)


class CostScale(NamedTuple):
    """Multipliers applied to the analytic per-token costs — identity by
    default; `core.calibration` sets these from compiled-HLO measurements."""
    compute: float = 1.0
    memory: float = 1.0
    comm: float = 1.0


IDENT = CostScale()

DTYPE = np.float32     # one dtype for every per-token cost


# --- per-token costs (Eqs. 6–11) ---

def c_prefill(m: MoEModel, s_p):                  # Eq. 6 (FLOPs/token)
    s_p = np.asarray(s_p, DTYPE)
    return float(m.L) * (4.0 * m.K * m.w * m.FF + 4.0 * m.w ** 2
                         + 2.0 * m.w * s_p)


def c_decode(m: MoEModel, t):                     # Eq. 7
    t = np.asarray(t, DTYPE)
    return float(m.L) * (4.0 * m.K * m.w * m.FF + 4.0 * m.w ** 2
                         + 2.0 * m.w * t)


def m_prefill(m: MoEModel, s_p, batch=BATCH):     # Eq. 8 (bytes/token)
    return m.w_total_bytes / (batch * s_p) + 2 * m.L * m.w * B_KV


def m_decode(m: MoEModel, t, batch=BATCH):        # Eq. 9
    t = np.asarray(t, DTYPE)
    return m.w_active_bytes / batch + 2.0 * m.L * m.w * (t + 1.0) * B_KV


def n_tp(m: MoEModel, t_d):                       # Eq. 10 (bytes/token)
    return m.L * 2 * (t_d - 1) / t_d * m.w * B_ACT


def n_ep(m: MoEModel):                            # Eq. 11
    return 2 * m.L * m.K * m.w * B_ACT


# --- locality model (Eqs. 12–16) ---

def n_domains(m: MoEModel, d: Deployment):        # Eq. 12
    usable = ALPHA_HBM * d.domain_pkgs * d.hbm_pkg_bytes
    return int(np.ceil(m.w_total_bytes / usable))


def f_ib(m: MoEModel, d: Deployment):             # Eq. 13
    nd = n_domains(m, d)
    return 0.0 if nd == 1 else 1.0 - 1.0 / nd


def t_comm(m: MoEModel, d: Deployment, scale: CostScale = IDENT):
    """Eqs. 14–16.  Pure host-float math over the pair's locality
    statics (no dtype/shape forks) — `PairStatics` records the unscaled
    value so grids never re-derive it."""
    tp = n_tp(m, d.tp_degree) / d.b_nvl                      # Eq. 14
    f = f_ib(m, d)
    nd = n_domains(m, d)
    b_ib = d.b_ib(m)
    if d.incast_penalty and nd > 1:
        b_ib = b_ib / nd       # per-domain-pair share of the scale-out fabric
    ep = max((1 - f) * n_ep(m) / d.b_nvl,                    # Eq. 15
             f * n_ep(m) / b_ib if f > 0 else 0.0)
    return scale.comm * (tp + ep)                            # Eq. 16


# --- precomputed pair statics (the vmap-safe layer) ---

class PairStatics(NamedTuple):
    """Everything Eqs. 5–18 need about one (model, deployment) pair,
    with the static `ceil`-derived integers (`n_units`, `n_domains`)
    already folded in.  Leaves are host floats for one pair
    (`pair_statics`) or [C, M] float32 arrays for a deployments × models
    grid (`grid_statics`); the `*_s` evaluators are pure numpy over any
    leaf shape."""
    c0: object       # constant FLOPs/token (Eqs. 6/7 shared term)
    c1: object       # context-linear FLOPs/token coefficient (2·L·w)
    m_pre: object    # prefill bytes/token at (s_p, batch) (Eq. 8)
    m_dec0: object   # decode bytes/token constant (Eq. 9)
    m_dec1: object   # decode bytes/token per (t+1): 2·L·w·b_kv
    s_p: object      # prompt length
    f_flops: object  # Eq. 20
    b_hbm: object    # Eq. 21
    t_comm: object   # Eqs. 14–16, unscaled
    t_kv: object     # Eq. 18 per-request-batch KV transfer time
    power_w: object  # Eq. 25 over the co-scheduled units


def resolve_model(m) -> MoEModel:
    """Accept a `MoEModel` or a Table 2 model name (key of `MODELS`)."""
    return MODELS[m] if isinstance(m, str) else m


def pair_statics(m: MoEModel, d: Deployment, s_p=None,
                 batch=BATCH) -> PairStatics:
    """Host-side statics for one (model, deployment) pair — the only
    place the Python `int`/`ceil` casts live."""
    m = resolve_model(m)
    s_p = float(m.S if s_p is None else s_p)
    return PairStatics(
        c0=float(m.L) * (4.0 * m.K * m.w * m.FF + 4.0 * m.w ** 2),
        c1=2.0 * m.L * m.w,
        m_pre=m.w_total_bytes / (batch * s_p) + 2 * m.L * m.w * B_KV,
        m_dec0=m.w_active_bytes / batch,
        m_dec1=2.0 * m.L * m.w * B_KV,
        s_p=s_p,
        f_flops=d.f_flops(m),
        b_hbm=d.b_hbm(m),
        t_comm=t_comm(m, d),
        t_kv=t_kv_transfer(m, s_p, d.b_ib(m)),
        power_w=d.power_w(m),
    )


def grid_statics(models: Sequence[MoEModel], deployments: Sequence[Deployment],
                 batch=BATCH) -> PairStatics:
    """[C, M] statics for a deployments × models grid (C deployments,
    M models), ready for the `*_s` evaluators."""
    rows = [[pair_statics(m, d, batch=batch) for m in models]
            for d in deployments]
    return PairStatics(*(np.asarray(
        [[getattr(st, f) for st in row] for row in rows], DTYPE)
        for f in PairStatics._fields))


# --- phase & request throughput (Eqs. 5, 17, 18) ---
# `mode="min"` is Eq. 5 as printed (full overlap: slowest resource binds).
# `mode="additive"` follows limitation A.4(3) — no overlap between comm and
# compute/memory: T_token = max(T_compute, T_memory) + T_comm.  The additive
# mode is the default for the §6.5 pod study (see DESIGN.md §4).
DEFAULT_MODE = "additive"


def _combine(t_comp, t_mem, t_cm, mode):
    if mode == "min":
        return 1.0 / np.maximum(np.maximum(t_comp, t_mem), t_cm)
    return 1.0 / (np.maximum(t_comp, t_mem) + t_cm)


def _f32(st: PairStatics) -> PairStatics:
    return PairStatics(*(np.asarray(x, DTYPE) for x in st))


def tps_prefill_s(st: PairStatics, scale: CostScale = IDENT,
                  mode=DEFAULT_MODE):
    """Eq. 5, prefill phase, over statics of any shape."""
    st = _f32(st)
    t_comp = scale.compute * (st.c0 + st.c1 * st.s_p) / st.f_flops
    t_mem = scale.memory * st.m_pre / st.b_hbm
    return _combine(t_comp, t_mem, scale.comm * st.t_comm, mode)


def tps_decode_s(st: PairStatics, t, scale: CostScale = IDENT,
                 mode=DEFAULT_MODE):
    """Eq. 5, decode phase at context length `t` (broadcastable)."""
    st = _f32(st)
    t = np.asarray(t, DTYPE)
    t_comp = scale.compute * (st.c0 + st.c1 * t) / st.f_flops
    t_mem = scale.memory * (st.m_dec0 + st.m_dec1 * (t + 1.0)) / st.b_hbm
    return _combine(t_comp, t_mem, scale.comm * st.t_comm, mode)


def tps_request_s(st: PairStatics, s_out: int = 256,
                  scale: CostScale = IDENT, batch=BATCH, mode=DEFAULT_MODE):
    """Request-level throughput (Eq. 17, dimensional reading per
    DESIGN.md): T_total = B·S_p/TPS_pre + Σ_t B/TPS_dec(t) + T_KV;
    TPS_req = B·S_out / T_total [tokens/s].  The decode sum
    broadcasts a trailing context axis against statics of any shape, so
    a [C, M] grid is one fused evaluation."""
    st = _f32(st)
    t_pre = batch * st.s_p / tps_prefill_s(st, scale, mode)
    st_b = PairStatics(*(x[..., None] for x in st))
    ts = st.s_p[..., None] + np.arange(1, s_out + 1, dtype=DTYPE)
    t_dec = np.sum(batch / tps_decode_s(st_b, ts, scale, mode), axis=-1)
    return batch * s_out / (t_pre + t_dec + st.t_kv)


def tps_per_watt_s(st: PairStatics, s_out: int = 256,
                   scale: CostScale = IDENT, batch=BATCH, mode=DEFAULT_MODE):
    st = _f32(st)
    return tps_request_s(st, s_out, scale, batch, mode) / st.power_w


def tps_request_grid(models: Sequence[MoEModel],
                     deployments: Sequence[Deployment], s_out: int = 256,
                     scale: CostScale = IDENT, batch=BATCH,
                     mode=DEFAULT_MODE) -> np.ndarray:
    """[C, M] request throughput for a deployments × models grid in one
    evaluation (C deployments, M models).  Equals the scalar
    `tps_request` per pair."""
    st = grid_statics(models, deployments, batch=batch)
    return tps_request_s(st, s_out, scale, batch, mode)


def tps_per_watt_grid(models: Sequence[MoEModel],
                      deployments: Sequence[Deployment], s_out: int = 256,
                      scale: CostScale = IDENT, batch=BATCH,
                      mode=DEFAULT_MODE) -> np.ndarray:
    """[C, M] tokens/s per serving watt (Eq. 25 normalization)."""
    st = grid_statics(models, deployments, batch=batch)
    return tps_per_watt_s(st, s_out, scale, batch, mode)


def t_kv_transfer(m: MoEModel, s_p, b_transfer):  # Eq. 18
    return 2 * m.L * m.w * s_p * B_KV / b_transfer


def tps_prefill(m: MoEModel, d: Deployment, s_p=None,
                scale: CostScale = IDENT, batch=BATCH, mode=DEFAULT_MODE):
    return tps_prefill_s(pair_statics(m, d, s_p, batch), scale, mode)


def tps_decode(m: MoEModel, d: Deployment, t,
               scale: CostScale = IDENT, batch=BATCH, mode=DEFAULT_MODE):
    return tps_decode_s(pair_statics(m, d, batch=batch), t, scale, mode)


def tps_request(m: MoEModel, d: Deployment, s_out: int = 256,
                scale: CostScale = IDENT, batch=BATCH, mode=DEFAULT_MODE):
    """Request-level throughput for one pair (Eq. 17): the scalar
    wrapper over `tps_request_s`."""
    return tps_request_s(pair_statics(m, d, batch=batch), s_out, scale,
                         batch, mode)


def tps_per_watt(m: MoEModel, d: Deployment, s_out: int = 256,
                 scale: CostScale = IDENT, mode=DEFAULT_MODE):
    return float(tps_request(m, d, s_out, scale, mode=mode)) / d.power_w(m)


def bottleneck(m: MoEModel, d: Deployment, phase: str = "dec", t: int = 1024,
               scale: CostScale = IDENT):
    """Which of the three terms binds (for analysis/plots)."""
    if phase == "pre":
        terms = {
            "compute": float(scale.compute * c_prefill(m, m.S)) / d.f_flops(m),
            "memory": float(scale.memory * m_prefill(m, m.S)) / d.b_hbm(m),
            "comm": t_comm(m, d, scale),
        }
    else:
        terms = {
            "compute": float(scale.compute * c_decode(m, t)) / d.f_flops(m),
            "memory": float(scale.memory * m_decode(m, t)) / d.b_hbm(m),
            "comm": t_comm(m, d, scale),
        }
    return max(terms, key=terms.get), terms

"""Power-delivery hierarchy: designs, line-ups, rows, wiring (paper §2, App. C).

A hall is a tree  substation → UPS line-ups → rows → racks.  We model the
levels that bind placement: line-ups (UPS domains) and rows, plus hall-level
liquid-cooling capacity.  Two redundancy families (paper §2.3):

* distributed ``xN/y``: all x line-ups are active; each may carry HA load up
  to (y/x)·C (Eq. 27) and must retain failover headroom Δ = P_r/(k_r−1)
  (Eq. 1) for every HA deployment it feeds.
* block ``N+k``: y = N primary line-ups carry load to full rating C; k
  standby line-ups exist only for failover (they cost money but admit no
  load), so usable capacity is quantized per line-up (Eq. 2).

Row wiring follows Appendix C.2: low-density rows connect to 2 upstream
line-ups, high-density rows to 4 (distributed) — balanced across the
admissible combinations within a power domain; block-design rows draw from a
single primary line-up (the reserve path is via STS and consumes no primary
capacity).

A numpy copy of `repro.core.hierarchy` (the port imports nothing of
`repro`); `build_topology` gives byte-identical arrays.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

from .resources import (AIR, AIR_CFM_PER_KW, LIQ, LIQ_LPM_PER_RACK, N_RES,
                        POWER, TILES)

MAX_FEEDS = 4


class SweepValidationError(ValueError):
    """A sweep input failed validation before any compile time was spent.

    `field` names the offending spec field (e.g. ``"lineup_kw"`` or
    ``"envs"``); `message` is the human-readable diagnosis.  Subclasses
    ValueError so pre-existing ``pytest.raises(ValueError)`` call sites
    keep working.
    """

    def __init__(self, field: str, message: str):
        self.field = field
        self.message = message
        super().__init__(f"{field}: {message}")


def _require(ok: bool, field: str, message: str) -> None:
    if not ok:
        raise SweepValidationError(field, message)


@dataclass(frozen=True)
class DesignSpec:
    """A power-delivery reference design (paper Table 1 / App. C.2)."""
    name: str
    kind: str                    # 'distributed' | 'block'
    n_lineups: int               # x: total UPS line-ups (incl. reserve)
    n_active: int                # y: line-ups of supported HA load
    lineup_kw: float = 2500.0    # 2.5 MW UPS line-up (Table 1)
    n_domains: int = 1           # power domains partitioning the line-ups
    ld_rows: int = 18
    hd_rows: int = 12
    ld_row_kw: float = 625.0     # Table 1 electrical granularity
    hd_row_kw: float = 2500.0
    ld_feeds: int = 2            # App. C.2 row classes
    hd_feeds: int = 4
    tiles_per_row: int = 24      # App. C.2
    # Cooling provisioning (see DESIGN.md §4 — supply sizing is ours):
    air_provision_ratio: float = 1.0
    liq_gpu_share: float = 0.7        # design-point GPU share of HA power
    liq_ref_rack_kw: float = 150.0    # design-point GPU rack density

    @property
    def ha_capacity_kw(self) -> float:
        # distributed: (y/x)·x·C = y·C ; block: y primaries · C  → identical.
        return self.n_active * self.lineup_kw

    @property
    def ha_frac(self) -> float:
        """Effective HA fraction of a line-up's rating (Eq. 27)."""
        if self.kind == "distributed":
            return self.n_active / self.n_lineups
        return 1.0

    @property
    def n_rows(self) -> int:
        return self.ld_rows + self.hd_rows

    @property
    def hall_liq_cap_lpm(self) -> float:
        """Liquid plant sized for `liq_gpu_share` of HA power at the
        reference GPU rack density (2 LPM per rack)."""
        ref_racks = self.liq_gpu_share * self.ha_capacity_kw / self.liq_ref_rack_kw
        return ref_racks * LIQ_LPM_PER_RACK

    def validate(self) -> "DesignSpec":
        """Raise `SweepValidationError` on an unbuildable design."""
        d = self
        _require(d.kind in ("distributed", "block"), "kind",
                 f"unknown design kind {d.kind!r}; expected 'distributed' "
                 f"or 'block'")
        _require(d.n_lineups >= 1, "n_lineups",
                 f"design {d.name!r} needs at least one line-up, got "
                 f"{d.n_lineups}")
        _require(1 <= d.n_active <= d.n_lineups, "n_active",
                 f"design {d.name!r} has n_active={d.n_active} outside "
                 f"[1, n_lineups={d.n_lineups}]")
        _require(d.lineup_kw > 0, "lineup_kw",
                 f"design {d.name!r} has non-positive line-up rating "
                 f"{d.lineup_kw} kW")
        _require(d.n_domains >= 1, "n_domains",
                 f"design {d.name!r} needs at least one power domain, got "
                 f"{d.n_domains}")
        _require(d.ld_rows >= 0 and d.hd_rows >= 0, "ld_rows",
                 f"design {d.name!r} has negative row counts "
                 f"(ld_rows={d.ld_rows}, hd_rows={d.hd_rows})")
        _require(d.n_rows > 0, "ld_rows",
                 f"design {d.name!r} has zero rows (ld_rows + hd_rows == 0); "
                 f"nothing can ever place")
        _require(d.ld_row_kw > 0 and d.hd_row_kw > 0, "ld_row_kw",
                 f"design {d.name!r} has non-positive row power caps "
                 f"(ld_row_kw={d.ld_row_kw}, hd_row_kw={d.hd_row_kw})")
        _require(d.ld_feeds >= 1 and d.hd_feeds >= 1, "ld_feeds",
                 f"design {d.name!r} has a zero-feed row class "
                 f"(ld_feeds={d.ld_feeds}, hd_feeds={d.hd_feeds}); every "
                 f"row needs at least one upstream line-up")
        _require(max(d.ld_feeds, d.hd_feeds) <= MAX_FEEDS, "hd_feeds",
                 f"design {d.name!r} requests more than MAX_FEEDS="
                 f"{MAX_FEEDS} feeds per row")
        _require(d.tiles_per_row > 0, "tiles_per_row",
                 f"design {d.name!r} has non-positive tiles_per_row "
                 f"{d.tiles_per_row}")
        _require(d.air_provision_ratio >= 0, "air_provision_ratio",
                 f"design {d.name!r} has negative air_provision_ratio "
                 f"{d.air_provision_ratio}")
        _require(0.0 <= d.liq_gpu_share <= 1.0, "liq_gpu_share",
                 f"design {d.name!r} has liq_gpu_share {d.liq_gpu_share} "
                 f"outside [0, 1]")
        _require(d.liq_ref_rack_kw > 0, "liq_ref_rack_kw",
                 f"design {d.name!r} has non-positive liq_ref_rack_kw "
                 f"{d.liq_ref_rack_kw}")
        return d


def _balanced_combos(n: int, r: int, count: int, offset: int = 0):
    """Cyclically assign `count` rows over all C(n, r) feed combinations."""
    combos = list(itertools.combinations(range(n), r))
    return [tuple(offset + c for c in combos[i % len(combos)])
            for i in range(count)]


@dataclass(frozen=True)
class HallTopology:
    """Static (numpy) arrays describing one hall design, possibly tiled over
    H halls with globally-indexed rows/line-ups (fleet mode)."""
    design: DesignSpec
    n_halls: int
    row_cap: np.ndarray        # [R_tot, N_RES] float32
    row_feeds: np.ndarray      # [R_tot, MAX_FEEDS] int32, -1 padded
    row_nfeeds: np.ndarray     # [R_tot] int32
    row_is_hd: np.ndarray      # [R_tot] bool
    row_domain: np.ndarray     # [R_tot] int32 (global domain id)
    row_hall: np.ndarray       # [R_tot] int32
    lineup_cap: np.ndarray     # [X_tot] float32 (kW rating C)
    lineup_is_active: np.ndarray  # [X_tot] bool (block reserve = False)
    lineup_hall: np.ndarray    # [X_tot] int32 — hall owning each line-up
    hall_liq_cap: np.ndarray   # [H] float32
    ha_frac: float
    is_block: bool

    @property
    def rows_per_hall(self) -> int:
        # derived from the arrays (≥ design.n_rows when padded for sweeps)
        return self.row_cap.shape[0] // self.n_halls

    @property
    def lineups_per_hall(self) -> int:
        return self.lineup_cap.shape[0] // self.n_halls

    @property
    def n_hd_rows(self) -> int:
        """HD-row count across all halls (the compacted pod-scan length)."""
        return int(np.asarray(self.row_is_hd).sum())

    def ha_capacity_kw(self) -> float:
        return self.design.ha_capacity_kw * self.n_halls

    def validate(self) -> "HallTopology":
        """Raise `SweepValidationError` on an internally inconsistent
        topology (hand-built grids bypassing `build_topology`)."""
        t = self
        _require(t.n_halls >= 1, "n_halls",
                 f"topology needs at least one hall, got {t.n_halls}")
        R_tot = t.row_cap.shape[0]
        X_tot = t.lineup_cap.shape[0]
        _require(R_tot > 0, "row_cap",
                 "topology has zero rows; nothing can ever place")
        _require(X_tot > 0, "lineup_cap",
                 "topology has zero line-ups; no power can be delivered")
        _require(R_tot % t.n_halls == 0, "row_cap",
                 f"{R_tot} rows do not tile evenly over {t.n_halls} halls")
        _require(X_tot % t.n_halls == 0, "lineup_cap",
                 f"{X_tot} line-ups do not tile evenly over "
                 f"{t.n_halls} halls")
        for name, arr, n in (("row_feeds", t.row_feeds, R_tot),
                             ("row_nfeeds", t.row_nfeeds, R_tot),
                             ("row_is_hd", t.row_is_hd, R_tot),
                             ("row_domain", t.row_domain, R_tot),
                             ("row_hall", t.row_hall, R_tot),
                             ("lineup_is_active", t.lineup_is_active, X_tot),
                             ("lineup_hall", t.lineup_hall, X_tot)):
            _require(arr.shape[0] == n, name,
                     f"{name} has {arr.shape[0]} entries, expected {n}")
        _require(t.row_feeds.shape[1] == MAX_FEEDS, "row_feeds",
                 f"row_feeds second axis is {t.row_feeds.shape[1]}, "
                 f"expected MAX_FEEDS={MAX_FEEDS}")
        _require(t.hall_liq_cap.shape[0] == t.n_halls, "hall_liq_cap",
                 f"hall_liq_cap has {t.hall_liq_cap.shape[0]} entries, "
                 f"expected n_halls={t.n_halls}")
        feeds = np.asarray(t.row_feeds)
        _require(bool(np.all((feeds >= -1) & (feeds < X_tot))), "row_feeds",
                 f"row_feeds references line-ups outside [-1, {X_tot})")
        # Real rows (positive power capacity) must be wired to a line-up;
        # zero-capacity padding rows may legitimately have no feeds.
        real = np.asarray(t.row_cap)[:, POWER] > 0
        unfed = real & (np.asarray(t.row_nfeeds) <= 0)
        _require(not bool(unfed.any()), "row_nfeeds",
                 f"{int(unfed.sum())} powered row(s) have zero feeds "
                 f"(first at index {int(np.argmax(unfed))}); every powered "
                 f"row needs at least one upstream line-up")
        caps = np.asarray(t.lineup_cap)
        _require(bool(np.all(caps >= 0)), "lineup_cap",
                 "negative line-up power caps")
        active = np.asarray(t.lineup_is_active)
        dead = active & (caps <= 0)
        _require(not bool(dead.any()), "lineup_cap",
                 f"{int(dead.sum())} active line-up(s) have non-positive "
                 f"power caps (first at index {int(np.argmax(dead))})")
        _require(bool(active.any()), "lineup_is_active",
                 "no active line-ups; no load can ever be admitted")
        _require(0.0 < t.ha_frac <= 1.0, "ha_frac",
                 f"ha_frac {t.ha_frac} outside (0, 1]")
        return t


def build_topology(design: DesignSpec, n_halls: int = 1,
                   rows_per_hall: int | None = None,
                   lineups_per_hall: int | None = None) -> HallTopology:
    """Build the (possibly multi-hall) topology for `design`.

    `rows_per_hall` / `lineups_per_hall` optionally pad every hall to a
    common static shape so heterogeneous designs can be stacked and
    batched together (sweep engine): padding rows have zero capacity and
    no feeds (never feasible), padding line-ups are inactive with zero
    rating (contribute nothing to stranding metrics).
    """
    d = design.validate()        # zero-row / zero-feed / bad caps → precise error
    _require(n_halls >= 1, "n_halls",
             f"need at least one hall, got {n_halls}")
    if d.kind == "distributed":
        active = list(range(d.n_lineups))
        per_dom = d.n_lineups // d.n_domains
    else:
        active = list(range(d.n_active))       # primaries first
        per_dom = d.n_active // d.n_domains
    if per_dom * d.n_domains != len(active):
        raise SweepValidationError(
            "n_domains", f"design {d.name!r}: line-ups must partition "
            f"evenly into {d.n_domains} domains")
    if d.ld_rows % d.n_domains or d.hd_rows % d.n_domains:
        raise SweepValidationError(
            "n_domains", f"design {d.name!r}: rows must partition evenly "
            f"into {d.n_domains} domains")

    ld_per_dom = d.ld_rows // d.n_domains
    hd_per_dom = d.hd_rows // d.n_domains

    feeds, nfeeds, is_hd, domain = [], [], [], []
    for dom in range(d.n_domains):
        off = dom * per_dom
        if d.kind == "distributed":
            ld = _balanced_combos(per_dom, min(d.ld_feeds, per_dom), ld_per_dom, off)
            hd = _balanced_combos(per_dom, min(d.hd_feeds, per_dom), hd_per_dom, off)
        else:
            # block: one primary feed per row, round-robin within domain.
            ld = [(off + i % per_dom,) for i in range(ld_per_dom)]
            hd = [(off + i % per_dom,) for i in range(hd_per_dom)]
        for combo in ld:
            feeds.append(combo); nfeeds.append(len(combo))
            is_hd.append(False); domain.append(dom)
        for combo in hd:
            feeds.append(combo); nfeeds.append(len(combo))
            is_hd.append(True); domain.append(dom)

    R = len(feeds)
    row_feeds = np.full((R, MAX_FEEDS), -1, np.int32)
    for i, combo in enumerate(feeds):
        row_feeds[i, :len(combo)] = combo
    row_nfeeds = np.asarray(nfeeds, np.int32)
    row_is_hd = np.asarray(is_hd, bool)
    row_domain = np.asarray(domain, np.int32)

    row_kw = np.where(row_is_hd, d.hd_row_kw, d.ld_row_kw).astype(np.float32)
    row_cap = np.zeros((R, N_RES), np.float32)
    row_cap[:, POWER] = row_kw
    row_cap[:, AIR] = d.air_provision_ratio * AIR_CFM_PER_KW * row_kw
    row_cap[:, LIQ] = np.where(row_is_hd, 1e9, 0.0)   # liquid loops only in HD rows;
    row_cap[:, TILES] = d.tiles_per_row               # the binding cap is hall-level.

    lineup_cap = np.full((d.n_lineups,), d.lineup_kw, np.float32)
    lineup_is_active = np.zeros((d.n_lineups,), bool)
    lineup_is_active[active] = True

    # --- pad the single hall to a requested common shape (sweep batching) ---
    R_pad = rows_per_hall or R
    X_pad = lineups_per_hall or d.n_lineups
    if R_pad < R or X_pad < d.n_lineups:
        raise ValueError(
            f"padding ({R_pad} rows, {X_pad} line-ups) smaller than design "
            f"({R} rows, {d.n_lineups} line-ups)")
    if R_pad > R:
        pad = R_pad - R
        row_cap = np.concatenate([row_cap, np.zeros((pad, N_RES), np.float32)])
        row_feeds = np.concatenate(
            [row_feeds, np.full((pad, MAX_FEEDS), -1, np.int32)])
        row_nfeeds = np.concatenate([row_nfeeds, np.zeros((pad,), np.int32)])
        row_is_hd = np.concatenate([row_is_hd, np.zeros((pad,), bool)])
        row_domain = np.concatenate([row_domain, np.zeros((pad,), np.int32)])
        R = R_pad
    if X_pad > d.n_lineups:
        pad = X_pad - d.n_lineups
        lineup_cap = np.concatenate([lineup_cap, np.zeros((pad,), np.float32)])
        lineup_is_active = np.concatenate(
            [lineup_is_active, np.zeros((pad,), bool)])

    # --- tile over H halls with global indices ---
    H = n_halls
    X = X_pad
    row_feeds_g = np.concatenate(
        [np.where(row_feeds >= 0, row_feeds + h * X, -1) for h in range(H)], 0)
    tile = lambda a: np.concatenate([a] * H, 0)
    topo = HallTopology(
        design=d, n_halls=H,
        row_cap=tile(row_cap),
        row_feeds=row_feeds_g.astype(np.int32),
        row_nfeeds=tile(row_nfeeds),
        row_is_hd=tile(row_is_hd),
        row_domain=np.concatenate(
            [row_domain + h * d.n_domains for h in range(H)], 0).astype(np.int32),
        row_hall=np.concatenate(
            [np.full((R,), h, np.int32) for h in range(H)], 0),
        lineup_cap=np.concatenate([lineup_cap] * H, 0),
        lineup_is_active=np.concatenate([lineup_is_active] * H, 0),
        lineup_hall=np.repeat(np.arange(H, dtype=np.int32), X),
        hall_liq_cap=np.full((H,), d.hall_liq_cap_lpm, np.float32),
        ha_frac=d.ha_frac,
        is_block=(d.kind == "block"),
    )
    return topo


# ---------------------------------------------------------------------------
# Reference designs (paper Table 1 / §3.1 / §6.1).
# ---------------------------------------------------------------------------

def design_4n3() -> DesignSpec:
    """4N/3 distributed-redundant, 7.5 MW HA (paper §3.1)."""
    return DesignSpec("4N/3", "distributed", n_lineups=4, n_active=3,
                      n_domains=1, ld_rows=18, hd_rows=12)


def design_3p1() -> DesignSpec:
    """3+1 block-redundant, 7.5 MW HA (paper §3.1). App. C.2 base hall:
    6N LD + 4N HD rows with N = 3 primaries."""
    return DesignSpec("3+1", "block", n_lineups=4, n_active=3,
                      n_domains=1, ld_rows=18, hd_rows=12)


def design_10n8() -> DesignSpec:
    """10N/8 distributed, 20 MW HA.  Two domains of 5 line-ups (see
    DESIGN.md §4 for the balanced-subset rationale): LD rows multiple of
    C(5,2)=10 per domain, HD rows multiple of C(5,4)=5 per domain, chosen
    to hit the 3:2 LD:HD reference ratio."""
    return DesignSpec("10N/8", "distributed", n_lineups=10, n_active=8,
                      n_domains=2, ld_rows=60, hd_rows=40)


def design_8p2() -> DesignSpec:
    """8+2 block-redundant, 20 MW HA.  App. C.2 base hall: 6N LD + 4N HD
    with N = 8 primaries."""
    return DesignSpec("8+2", "block", n_lineups=10, n_active=8,
                      n_domains=2, ld_rows=48, hd_rows=32)


DESIGNS = {
    "4N/3": design_4n3,
    "3+1": design_3p1,
    "10N/8": design_10n8,
    "8+2": design_8p2,
}


def get_design(name: str) -> DesignSpec:
    try:
        return DESIGNS[name]()
    except KeyError:
        raise KeyError(f"unknown design {name!r}; have {list(DESIGNS)}")

"""Component-based infrastructure cost model (paper §5.3, Table 6).

Comparative, not predictive: all designs are costed under the same
per-component assumptions; topology only changes which components (and how
many reserve units) a hall needs.

Calibration notes (DESIGN.md §4): the Table 6 column sums to $10.381M/MW —
the paper's quoted 3+1 block cost (~$10.3M/MW).  Distributed designs need no
static transfer switches (failover is absorbed by per-line-up reserve), so
4N/3 = Table 6 − STS ≈ $10.13M/MW (~paper's $10M), reproducing the ~3%
static gap of §3.1.

A copy of `repro.core.cost`.
"""
from __future__ import annotations

from typing import Dict

from .hierarchy import DesignSpec

# Table 6: $ per MW of IT capacity.
TABLE6 = {
    "ups": 1_000_000,
    "battery": 275_000,
    "generators": 750_000,
    "mv_transformers": 120_000,
    "mv_switchgear": 60_000,
    "lv_switchboards": 150_000,
    "ats": 70_000,
    "sts": 250_000,
    "row_distribution": 100_000,
    "busbar_overhead": 6_000,
    "cooling": 3_000_000,
    "shell_site_engineering": 1_800_000,
    "fitout_other": 2_800_000,
}

# Electrical power-train components whose installed count scales with the
# reserve ratio (used for the Fig. 14 reserve/stranding decomposition).
POWERTRAIN = ("ups", "battery", "generators", "lv_switchboards", "ats", "sts")


def component_costs_per_mw(design: DesignSpec) -> Dict[str, float]:
    c = dict(TABLE6)
    if design.kind == "distributed":
        c["sts"] = 0.0           # no block-transfer path
        # dual/quad-feed busway runs: scale busbar overhead with mean feeds
        mean_feeds = (design.ld_rows * design.ld_feeds +
                      design.hd_rows * design.hd_feeds) / design.n_rows
        c["busbar_overhead"] = TABLE6["busbar_overhead"] * mean_feeds / 2.0
    return c


def initial_dollars_per_mw(design: DesignSpec) -> float:
    """Initial $/MW: hall CapEx normalized by nameplate HA capacity."""
    return sum(component_costs_per_mw(design).values())


def hall_capex(design: DesignSpec) -> float:
    return initial_dollars_per_mw(design) * design.ha_capacity_kw / 1000.0


def reserve_cost_per_mw(design: DesignSpec) -> float:
    """$/MW attributable to reserve electrical capacity: the (x−y)/x share
    of the installed power train (Fig. 14 decomposition)."""
    c = component_costs_per_mw(design)
    reserve_ratio = (design.n_lineups - design.n_active) / design.n_lineups
    return reserve_ratio * sum(c[k] for k in POWERTRAIN)


def effective_dollars_per_mw(design: DesignSpec, n_halls: int,
                             deployed_mw: float) -> float:
    """Effective $/MW = Σ K_i / Σ P̂_i (paper §4.3).

    NaN (not inf) when nothing is deployed: the metric is *undefined* for
    an empty fleet, and a NaN sentinel survives aggregation arithmetic as
    "no data" where inf used to poison frontier deltas with ±inf
    (`payoff` masks non-finite values explicitly)."""
    if deployed_mw <= 0:
        return float("nan")
    return n_halls * hall_capex(design) / deployed_mw


def stranding_cost_per_mw(design: DesignSpec, n_halls: int,
                          deployed_mw: float) -> float:
    """Effective − initial $/MW: infrastructure built but not deployable."""
    return (effective_dollars_per_mw(design, n_halls, deployed_mw)
            - initial_dollars_per_mw(design))


def dollars_per_tps(total_capex: float, delivered_tps: float) -> float:
    """Effective $ per delivered token/s — the paper's headline
    $/performance objective.  NaN when nothing is delivered."""
    if not (delivered_tps > 0):
        return float("nan")
    return total_capex / delivered_tps

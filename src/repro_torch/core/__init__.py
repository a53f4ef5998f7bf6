"""Core of the port: hierarchy, placement (multi-row pods included), the
fleet lifecycle, the batched sweep, the single-hall Monte Carlo, the
streaming quantiles, the host-side cost and throughput models, the
scenario families, the pod payoff and frontier studies, the
calibration-artifact reader, and resilient (checkpointed, fault-isolated)
execution of the sweeps."""

from . import (arrivals, calibration, cost, fleet, hierarchy, mc_sweep,
               payoff, placement, prng, projections, quantiles, resilience,
               resources, scenarios, singlehall, sweep, throughput)

__all__ = [
    "arrivals", "calibration", "cost", "fleet", "hierarchy", "mc_sweep",
    "payoff", "placement", "prng", "projections", "quantiles", "resilience",
    "resources", "scenarios", "singlehall", "sweep", "throughput",
]

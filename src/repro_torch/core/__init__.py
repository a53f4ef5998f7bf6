"""Core of the port: hierarchy, placement (multi-row pods included), the
fleet lifecycle, the batched sweep, the single-hall Monte Carlo, the
streaming quantiles, and the host-side cost and throughput models."""

"""Core of the port: hierarchy, placement, the pod-free fleet lifecycle,
the batched sweep, and the host-side cost and throughput models."""

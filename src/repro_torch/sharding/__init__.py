"""Sweep meshes of the port: the device grid and the slab assignment of
the sharded sweep engines (`axes`), and how their slabs run on their
devices (`dispatch`)."""

from . import axes, dispatch

__all__ = ["axes", "dispatch"]

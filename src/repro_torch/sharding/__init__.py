"""Meshes of the port: the sweep meshes and the model meshes' logical-axis
rules (`axes`), how a sweep's slabs run on their devices (`dispatch`),
and the ranks of a model mesh with their collectives (`ranks`)."""

from . import axes, dispatch, ranks

__all__ = ["axes", "dispatch", "ranks"]

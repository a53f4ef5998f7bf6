"""Parameter specs (port of `repro.models.params`).

A model builds a nested dict of `ParamDef`s (shape + logical axes +
initializer).  From one spec come the materialized parameters
(`init_params`), their count (`n_params`), their logical-axes tree
(`axes_tree`, which the rule sets of `sharding.axes` read) and the
layer-stacked variant the layer loop walks (`stack_spec`).  Parameters
are a nested dict of tensors with the same keys.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # default: 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


Spec = Dict[str, Any]  # nested dict[str, ParamDef | Spec]


def _map_spec(spec: Spec, fn):
    return {k: (fn(v) if isinstance(v, ParamDef) else _map_spec(v, fn))
            for k, v in spec.items()}


def leaves(spec: Spec, prefix: str = ""):
    """(path, ParamDef) pairs in sorted key order, paths joined by '/'."""
    for k in sorted(spec):
        v = spec[k]
        path = f"{prefix}{k}"
        if isinstance(v, ParamDef):
            yield path, v
        else:
            yield from leaves(v, path + "/")


def unflatten(items) -> Dict[str, Any]:
    """(path, value) pairs → the nested dict their '/'-joined paths name."""
    out: Dict[str, Any] = {}
    for path, value in items:
        *parents, name = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = value
    return out


def stack_spec(spec: Spec, n: int, axis_name: Optional[str] = None) -> Spec:
    """Prepend a stacked-layer dimension to every param."""
    return _map_spec(spec, lambda p: ParamDef(
        (n,) + p.shape, (axis_name,) + p.axes, p.init, p.scale))


def axes_tree(spec: Spec):
    """The nested dict of each parameter's logical axes (a tuple of
    names or None per dimension)."""
    return _map_spec(spec, lambda p: p.axes)


def n_params(spec: Spec) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(spec))


def init_params(spec: Spec, generator: torch.Generator, dtype=torch.bfloat16,
                device=None, shardings=None):
    """Materialize `spec`: normal draws scaled by 1/sqrt(fan_in) (fan_in =
    shape[-2] after stacking, or the given `scale`), ones and zeros as
    given.  Draws are float32 from `generator` on its own device, in
    sorted key order, then cast to `dtype` on `device` (default: the
    generator's).  With `shardings` (a tree of `sharding.axes.
    NamedSharding` matching `spec`) each leaf is drawn whole, so that the
    numbers are one device's, and kept as a DTensor of this rank's block
    (`NamedSharding.place`); one leaf is whole at a time."""
    device = torch.device(device) if device is not None else \
        generator.device

    def make(p: ParamDef):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (scale * w).to(device=device, dtype=dtype)

    if shardings is None:
        return unflatten((path, make(p)) for path, p in leaves(spec))
    from ..checkpoint.checkpointer import tree_flatten
    flat_s, _ = tree_flatten(shardings)
    return unflatten((path, s.place(make(p))) for (path, p), s in
                     zip(leaves(spec), flat_s))

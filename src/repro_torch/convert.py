"""Carry `repro`'s state across to the port.

The port's counterpart of loading weights: it takes numpy arrays (the
leaves of `repro`'s `JaxTopology`, `HallState` and `FleetTrace`, as
`np.asarray` gives them, a model's parameter tree and its optimizer
state, serving caches) and returns the
port's tensors on a given device.  A fleet-state leaf may be one
configuration's (the batch axis is added) or already carry the leading
configuration axis.  Only numpy crosses over: nothing of `repro` or
`jax` is imported here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.fleet import FleetTrace
from .core.placement import HallState, Topology, check_hall_blocks
from .models.params import Spec, leaves, unflatten
from .optim.adamw import AdamWState

# field -> (dtype, ndim of one configuration's leaf)
_TOPOLOGY = {
    "row_cap": (torch.float32, 2), "row_feeds": (torch.int32, 2),
    "row_nfeeds": (torch.int32, 1), "row_is_hd": (torch.bool, 1),
    "row_domain": (torch.int64, 1), "row_hall": (torch.int64, 1),
    "hd_index": (torch.int64, 1), "lineup_cap": (torch.float32, 1),
    "lineup_is_active": (torch.bool, 1), "lineup_hall": (torch.int32, 1),
    "hall_liq_cap": (torch.float32, 1), "ha_frac": (torch.float32, 0),
    "is_block": (torch.bool, 0),
}
_STATE = {
    "row_load": (torch.float32, 2), "lineup_ha": (torch.float32, 1),
    "lineup_tot": (torch.float32, 1), "hall_liq": (torch.float32, 1),
    "rr_cursor": (torch.int32, 0),
}
_TRACE = {
    "month": (torch.int32, 1), "rack_kw": (torch.float32, 1),
    "n_racks": (torch.int32, 1), "is_gpu": (torch.bool, 1),
    "is_pod": (torch.bool, 1), "tier": (torch.int32, 1),
    "harvest_frac": (torch.float32, 1), "lifetime_m": (torch.int32, 1),
}


def _convert(leaves: Mapping[str, np.ndarray], spec, device):
    missing = set(spec) - set(leaves)
    if missing:
        raise KeyError(f"missing leaves: {sorted(missing)}")
    batched = None
    out = {}
    for name, (dtype, ndim) in spec.items():
        a = np.asarray(leaves[name])
        if a.ndim not in (ndim, ndim + 1):
            raise ValueError(f"`{name}` has {a.ndim} axes, expected {ndim} "
                             f"(one configuration) or {ndim + 1} (batched)")
        is_batched = a.ndim == ndim + 1
        if batched is None:
            batched = is_batched
        elif batched != is_batched:
            raise ValueError(f"`{name}` mixes batched and unbatched leaves")
        if not is_batched:
            a = a[None]
        if a.dtype == np.float64:
            raise TypeError(f"`{name}` is float64; the port computes in "
                            "float32")
        out[name] = torch.as_tensor(np.array(a), dtype=dtype,
                                    device=device)
    return out


def topology_from_numpy(leaves: Mapping[str, np.ndarray], device) -> Topology:
    """`repro` `JaxTopology` leaves → the port's `Topology` (line-ups
    grouped by hall in contiguous blocks, see `check_hall_blocks`)."""
    return check_hall_blocks(Topology(**_convert(leaves, _TOPOLOGY, device)))


def state_from_numpy(leaves: Mapping[str, np.ndarray], device) -> HallState:
    """`repro` `HallState` leaves → the port's `HallState`."""
    return HallState(**_convert(leaves, _STATE, device))


def trace_from_numpy(leaves: Mapping[str, np.ndarray], device) -> FleetTrace:
    """`repro` `FleetTrace` leaves → the port's `FleetTrace`."""
    return FleetTrace(**_convert(leaves, _TRACE, device))


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 (`ml_dtypes`, as `np.asarray`
    gives a JAX bfloat16 array) is carried over by its bits."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def params_from_numpy(tree: Mapping, spec: Spec, device,
                      dtype=torch.float32, shardings=None):
    """`repro`'s parameter tree (a nested dict of numpy arrays, stacked
    `[L, …]` block leaves) → the port's, cast to `dtype` on `device`.
    Every leaf of `spec` must be present with its shape, and nothing
    else.  With `shardings` (a tree of `sharding.axes.NamedSharding`
    matching `spec`, `Model.param_shardings`) each leaf is a DTensor of
    this rank's block, and only the block goes to `device`."""
    flat_s = None
    if shardings is not None:
        from .checkpoint.checkpointer import tree_flatten
        flat_s, _ = tree_flatten(shardings)
    flat = dict(_flatten(tree))
    want = dict(leaves(spec))
    missing = sorted(set(want) - set(flat))
    if missing:
        raise KeyError(f"parameters missing from the tree: {missing}")
    extra = sorted(set(flat) - set(want))
    if extra:
        raise ValueError(f"parameters not in the port's spec: {extra}")
    out = []
    for i, (path, p) in enumerate(want.items()):
        a = np.asarray(flat[path])
        if a.shape != p.shape:
            raise ValueError(f"parameter `{path}` has shape {a.shape}, the "
                             f"port's spec says {p.shape}")
        if flat_s is None:
            out.append((path, _tensor(a).to(device=device, dtype=dtype)))
            continue
        local = _tensor(a[flat_s[i].block(a.shape)])
        out.append((path, flat_s[i].distribute(
            local.to(device=device, dtype=dtype), a.shape)))
    return unflatten(out)


def caches_from_numpy(tree, like, shardings=None):
    """`repro`'s serving caches with numpy leaves (as `jax.tree.map(
    np.asarray, …)` gives them: a `KVCache` or `SSMCache`, the hybrid's
    dict of them by sub-layer, or the encoder-decoder's `DecCache`, whose
    first field is itself a `KVCache`) → the port's, shaped as the cache
    tree `like` (`Model.init_caches`): the same dict keys and cache types,
    each leaf of `like`'s shape and type (bfloat16 carried over by its
    bits) on `like`'s device.  With `shardings` (a tree of
    `sharding.axes.NamedSharding` matching `like`,
    `Model.cache_shardings`) each leaf is a DTensor of this rank's block,
    and only the block goes to the device, as `params_from_numpy`
    carries the weights."""
    if isinstance(like, Mapping):
        got = sorted(tree) if isinstance(tree, Mapping) else \
            type(tree).__name__
        if got != sorted(like):
            raise KeyError(f"cache sub-layers {got} are not the port's "
                           f"{sorted(like)}")
        return {k: caches_from_numpy(tree[k], v, None if shardings is None
                                     else shardings[k])
                for k, v in like.items()}
    if len(tree) != len(like):
        raise ValueError(f"{type(like).__name__} has {len(like)} fields, "
                         f"the tree {len(tree)}")
    out = []
    for i, (name, a, t) in enumerate(zip(like._fields, tree, like)):
        s = None if shardings is None else shardings[i]
        if not isinstance(t, torch.Tensor):
            out.append(caches_from_numpy(a, t, s))
            continue
        a = np.asarray(a)
        if a.shape != tuple(t.shape):
            raise ValueError(f"cache `{name}` has shape {a.shape}, the "
                             f"port's {tuple(t.shape)}")
        device = t.to_local().device if hasattr(t, "to_local") else t.device
        if s is None:
            out.append(_tensor(a).to(device=device, dtype=t.dtype))
            continue
        local = _tensor(a[s.block(a.shape)])
        out.append(s.distribute(local.to(device=device, dtype=t.dtype),
                                a.shape))
    return type(like)(*out)


def adamw_state_from_numpy(state, spec: Spec, device) -> AdamWState:
    """`repro`'s `AdamWState(step, mu, nu)` with numpy leaves (as
    `jax.tree.map(np.asarray, …)` gives it) → the port's: the step an
    int32 scalar, the moments float32 trees of `spec`'s leaves."""
    step, mu, nu = state
    step = np.asarray(step)
    if step.shape != () or step.dtype.kind not in "iu":
        raise ValueError(f"the step is {step.dtype} of shape {step.shape}, "
                         "expected an integer scalar")
    return AdamWState(
        torch.tensor(int(step), dtype=torch.int32, device=device),
        params_from_numpy(mu, spec, device, torch.float32),
        params_from_numpy(nu, spec, device, torch.float32))

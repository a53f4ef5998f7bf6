"""Tensor and expert parallelism over one mesh axis, and FSDP's gather
at use: the collectives GSPMD inserts around the reference's projections
under `base_rules` and `fsdp_rules`, made explicit for the model code.

Under the active rules and mesh (`axes.use_rules`), `context()` gives the
tensor-parallel axis: the one mesh axis larger than 1 that the rules put
the model-parallel logical axes on (`TP_LOGICAL`; "model" under
`base_rules`), with this rank's group and index on it.  Without one it
gives None, and the model code runs its one-device path unchanged.

The layout, what the reference's comments describe
(`repro/sharding/axes.py:138-141`, `repro/models/moe.py:120-122`):

* The residual stream is held as each rank's block of its last
  dimension (`act_embed`).  Before each norm and projection it is
  all-gathered (`TP.gather`), so the RMS statistics are those of the
  full row; after each projection out it is reduce-scattered back
  (`TP.scatter`).
* A projection into heads, MLP columns, experts or vocabulary entries
  computes this rank's range of them (`TP.range`).  A weight the rules
  shard there is that block already.  A weight they replicate, because
  its dimension does not divide over the axis (`axes.divisible_spec`),
  is narrowed to the range (`TP.local`); the ranges of such a dimension
  may be uneven.
* The projection out of a range sums the ranks' partial results.

Gradients: the loss is the same on every rank.  A parameter block the
rules shard gets its whole gradient on its rank.  A parameter they
replicate gets, on each rank, the part of its gradient that flows
through that rank's range, and `train.step.make_train_step` sums those
parts over the axis.  So every replicated value that feeds the loss on
every rank must reach it through a per-rank part: the MoE load-balance
loss sums its experts' terms by range (`models.moe.router_topk`), the
cross-entropy its vocabulary's (`models.layers.chunked_ce`).

FSDP (`fsdp_gather`): a parameter that the rules shard over other axes
than the tensor-parallel one (the data axes on `embed`) is all-gathered
over them where it is used, inside the remat'd layer, so the recompute
gathers again; the gather's backward reduce-scatters the gradient, so
no rank holds a full gradient of such a leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from . import axes as ax
from . import ranks

# logical axes that tensor and expert parallelism split
TP_LOGICAL = ("act_embed", "heads", "kv_heads", "mlp", "expert", "vocab")


def tp_axis(rules: ax.Rules, mesh) -> Optional[str]:
    """The mesh axis larger than 1 that `rules` put the `TP_LOGICAL` axes
    on, or None.  The port splits the model over one such axis, never a
    batch axis."""
    sizes = ax.axis_sizes(mesh)
    wide = {a for k in TP_LOGICAL for a in ax._names(rules.get(k))
            if sizes.get(a, 1) > 1}
    if not wide:
        return None
    if len(wide) > 1 or wide & set(ax.batch_axes(rules)):
        raise NotImplementedError(
            f"the rules split the model over {sorted(wide)} with the batch "
            f"over {ax.batch_axes(rules)}: the port splits it over one mesh "
            "axis that is not a batch axis")
    return wide.pop()


@dataclass(frozen=True)
class TP:
    """This rank's place on the tensor-parallel axis."""
    group: Any
    n: int          # the axis' size
    r: int          # this rank's index on it

    def range(self, size: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of a dimension of `size`: the rules' block
        where `size` divides, else the uneven split."""
        return self.r * size // self.n, (self.r + 1) * size // self.n

    def local(self, w: torch.Tensor, dim: int, size: int) -> torch.Tensor:
        """`w`'s part for this rank along `dim` (of global `size`): `w`
        if it is the rules' block, `w` narrowed to `range` if it is
        whole (replicated)."""
        lo, hi = self.range(size)
        if w.shape[dim] == hi - lo:
            return w
        if w.shape[dim] != size:
            raise ValueError(f"dimension {dim} of {tuple(w.shape)} is "
                             f"neither {size} nor this rank's {hi - lo}")
        return w.narrow(dim, lo, hi - lo)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream's blocks → the full rows."""
        return ranks.all_gather(x, -1, self.group, self.n)

    def scatter(self, y: torch.Tensor) -> torch.Tensor:
        """The ranks' partial sums → this rank's block of their sum."""
        return ranks.reduce_scatter(y, -1, self.group, self.n)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full row that every rank holds."""
        lo, hi = self.range(x.shape[-1])
        return x[..., lo:hi]

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return ranks.all_reduce(x, self.group, self.n)


def context() -> Optional[TP]:
    """The tensor-parallel axis of the active rules and mesh, or None."""
    rules, mesh = ax.get_rules(), ax.get_mesh()
    if rules is None or mesh is None:
        return None
    a = tp_axis(rules, mesh)
    if a is None:
        return None
    group = mesh.get_group(a)
    return TP(group, ax.axis_sizes(mesh)[a], dist.get_rank(group))


def gather(x: torch.Tensor) -> torch.Tensor:
    """`TP.gather` under a tensor-parallel axis, else `x`."""
    tp = context()
    return x if tp is None else tp.gather(x)


def scatter(y: torch.Tensor) -> torch.Tensor:
    """`TP.scatter` under a tensor-parallel axis, else `y`."""
    tp = context()
    return y if tp is None else tp.scatter(y)


def fsdp_gather(tree, spec):
    """`tree`'s leaves (nested dicts matching `spec`'s `ParamDef`s, which
    give each leaf's global shape and logical axes), each all-gathered
    over the mesh axes other than the tensor-parallel one that the
    active rules shard it over: its tensor-parallel block.  `tree` as it
    is when the rules shard no leaf so (no FSDP)."""
    rules, mesh = ax.get_rules(), ax.get_mesh()
    if rules is None or mesh is None or not any(
            ax.axis_sizes(mesh).get(a, 1) > 1
            for a in ax._names(rules.get("embed"))):
        return tree
    tp = tp_axis(rules, mesh)

    def one(w, pd):
        s = ax.divisible_spec(ax.spec_for(pd.axes, rules), pd.shape, mesh)
        for d, entry in enumerate(s):
            names = [a for a in ax._names(entry) if a != tp]
            if names and len(names) < len(ax._names(entry)):
                raise NotImplementedError(
                    f"{pd.axes}: dimension {d} is split over {entry}, the "
                    "tensor-parallel axis and others together")
            group, n = ranks.axis_group(mesh, names)
            w = ranks.all_gather(w, d, group, n)
        return w

    def walk(t, sp):
        return {k: walk(v, sp[k]) if isinstance(v, dict) else one(v, sp[k])
                for k, v in t.items()}
    return walk(tree, spec)

"""Tensor and expert parallelism over the residual's mesh axis, the
mixers over a second one, and FSDP's gather at use: the collectives
GSPMD inserts around the reference's projections under `base_rules`,
`fsdp_rules`, `decode_32k`'s layout and `sequence_parallel_rules`, made
explicit for the model code.

Under the active rules and mesh (`axes.use_rules`), `context()` gives the
tensor-parallel axis: the mesh axis larger than 1 that the rules put
the residual (`act_embed`) on ("model" under those rules,
`axes.model_axis`), with this rank's group and index on it and the
model-parallel logical axes the rules put there (`TP.splits`).  Without
one it gives None.  `axis_of(logical)` gives the same for the wide axis
of any logical axis: the residual's for the MLP, experts and vocabulary
(`check_ported` allows no other), the residual's or a second one
("data" under `sequence_parallel_rules` with "data" > 1,
`axes.mixer_axis`) for the mixers' heads and SSM columns, the residual's
for the KV cache's sequence.  Without any the model code runs its
one-device path unchanged.

The layout, what the reference's comments describe
(`repro/sharding/axes.py:138-141,196-208`, `repro/models/moe.py:120-122`):

* The residual stream is held as each rank's block of its last
  dimension (`act_embed`).  Before each norm and projection it is
  all-gathered (`TP.gather`), so the RMS statistics are those of the
  full row.
* A projection into heads, MLP columns, experts, SSM heads or
  vocabulary entries that the rules split over a wide axis computes
  this rank's range of them on that axis (`TP.range`).  A weight the
  rules shard there is that block already.  A weight they replicate,
  because its dimension does not divide over the axis
  (`axes.divisible_spec`) or because FSDP took the axis for its `embed`
  dimension (`spec_for` uses an axis once), is narrowed to the range
  (`TP.local`); the ranges of such a dimension may be uneven.
* The projection out of a range on the residual's axis sums the ranks'
  partial results, which are reduce-scattered back to the residual's
  block.  Out of a range on the second axis (`out`): each rank keeps its
  residual block of its partial sum, and the blocks are all-reduced over
  the second axis.  A projection whose logical axis lies on no wide axis
  (the heads of `sequence_parallel_rules` on a "data" axis of 1) is
  computed whole on every rank, and each rank keeps its block of it.
* The KV cache's sequence (`seq_kv`) on the residual's axis: rank r
  holds cache positions [r·Smax/M, (r+1)·Smax/M) (`models.attention`).

Gradients: the loss is the same on every rank.  A parameter block the
rules shard gets its whole gradient on its rank.  A parameter they
replicate gets, on each rank, the part of its gradient that flows
through that rank's range or block, and `train.step.make_train_step`
sums those parts over the axis.  So every replicated value that feeds
the loss on every rank must reach it through a per-rank part: the MoE
load-balance loss sums its experts' terms by range
(`models.moe.router_topk`), the cross-entropy its vocabulary's
(`models.layers.chunked_ce`).  A sum over ranks that each rank then uses
only in part (the SSM gate norm's mean square) is `ranks.all_reduce`
wrapped in `ranks.copy_to`, whose backward sums the parts.  The ranks of
a second axis run the same work outside the mixers (the norms, MLP,
experts and vocabulary, split over the residual's axis alone), so there
a gradient is whole on each of them; the mixer's input enters through
`enter` (`ranks.copy_to` over the second axis), whose backward sums the
ranks' parts of its gradient, so that what flows on is whole again.
Only the mixers' parameters that the rules leave whole on the second
axis get a part there (`MIXER_KEY`; the step sums them over it).

FSDP (`fsdp_gather`): a parameter's `embed` dimension that the rules
shard over other axes than the residual's (the data axes) is
all-gathered over them where it is used, inside the remat'd layer, so
the recompute gathers again.  The gather's backward reduce-scatters the
gradient over a batch axis (the ranks' rows differ) and over the second
axis for a mixer's parameter (the ranks' heads differ); over an axis
whose ranks run the same work it takes the rank's block of its whole
gradient, with no communication.  So no rank holds a full gradient of
such a leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import axes as ax
from . import ranks

# the key of a layer's mixer parameters (`models.lm.block_spec`)
MIXER_KEY = "mixer"


@dataclass(frozen=True)
class TP:
    """This rank's place on one wide mesh axis of the model."""
    group: Any
    n: int          # the axis' size
    r: int          # this rank's index on it
    on: frozenset   # the model-parallel logical axes the rules put here
    name: str       # the mesh axis

    def splits(self, logical: str) -> bool:
        """Whether the rules split `logical` over this axis."""
        return logical in self.on

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

    def out(self, y: torch.Tensor, logical: str) -> torch.Tensor:
        """The residual's block of a projection out of `logical`: the
        reduce-scatter of the ranks' partial sums where the rules split
        `logical` here, else this rank's block of the whole sum."""
        return self.scatter(y) if self.splits(logical) else self.block(y)

    def gather_ranges(self, x: torch.Tensor, dim: int, units: int,
                      width: int = 1) -> torch.Tensor:
        """The whole of a dimension of `units` · `width` of which each
        rank holds, in `x` along `dim`, its `range(units)` of units of
        `width`: the ranges padded to one length, all-gathered (with a
        gradient), the padding stripped.  Ranges of `units` that do not
        divide over the axis are uneven (a vocabulary of 49155 over 2,
        3 SSM heads over 2)."""
        dim = dim % x.dim()
        most = -(-units // self.n) * width
        lo, hi = self.range(units)
        if x.shape[dim] != (hi - lo) * width:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} is not "
                             f"this rank's {hi - lo} units of {width}")
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, most - x.shape[dim]]
        full = ranks.all_gather(F.pad(x, pad), dim, self.group, self.n)
        if units % self.n == 0:
            return full
        return torch.cat([full.narrow(dim, g * most, (
            (g + 1) * units // self.n - g * units // self.n) * width)
            for g in range(self.n)], dim)


def _on(rules, mesh, a: Optional[str]) -> Optional[TP]:
    if a is None:
        return None
    group = mesh.get_group(a)
    return TP(group, ax.axis_sizes(mesh)[a], dist.get_rank(group),
              ax.on_axis(rules, a), a)


class _Layout:
    """The wide axes of one pair of active rules and mesh, each resolved
    once (`check_ported` passed when it was made): the residual's
    (`res`), each logical axis' (`of`) and a mixer's second one
    (`second`)."""

    def __init__(self, rules, mesh):
        self.rules, self.mesh, self._of = rules, mesh, {}
        self.res = _on(rules, mesh, ax.model_axis(rules, mesh))

    def of(self, logical: str) -> Optional[TP]:
        if logical not in self._of:
            self._of[logical] = _on(self.rules, self.mesh, ax.wide_axis(
                self.rules, self.mesh, logical))
        return self._of[logical]

    def second(self, logical: str) -> Optional[TP]:
        mix = self.of(logical)
        if mix is None or (self.res is not None
                           and self.res.name == mix.name):
            return None
        return mix


# the last active pair's `_Layout` (a layer looks its axes up per call)
_last: list = [None]


def _layout() -> Optional[_Layout]:
    rules, mesh = ax.get_rules(), ax.get_mesh()
    if rules is None or mesh is None:
        return None
    hit = _last[0]
    if hit is None or hit.rules is not rules or hit.mesh is not mesh:
        hit = _last[0] = _Layout(rules, mesh)
    return hit


def context() -> Optional[TP]:
    """The tensor-parallel axis (the residual's) of the active rules and
    mesh, or None."""
    lay = _layout()
    return None if lay is None else lay.res


def axis_of(logical: str) -> Optional[TP]:
    """The wide axis that the active rules put `logical` on, or None."""
    lay = _layout()
    return None if lay is None else lay.of(logical)


def gather(x: torch.Tensor) -> torch.Tensor:
    """`TP.gather` under a tensor-parallel axis, else `x`."""
    tp = context()
    return x if tp is None else tp.gather(x)


def scatter(y: torch.Tensor) -> torch.Tensor:
    """`TP.scatter` under a tensor-parallel axis, else `y`."""
    tp = context()
    return y if tp is None else tp.scatter(y)


def enter(h: torch.Tensor, logical: str) -> torch.Tensor:
    """The full rows `h` as the input of a mixer whose `logical` axis the
    rules put on a second wide axis: `ranks.copy_to` over it (each rank
    uses `h` for its heads only, so the backward sums their parts); `h`
    itself otherwise."""
    lay = _layout()
    mix = None if lay is None else lay.second(logical)
    return h if mix is None else ranks.copy_to(h, mix.group, mix.n)


def out(y: torch.Tensor, logical: str) -> torch.Tensor:
    """The residual's block of a projection out of `logical`: on a second
    wide axis, this rank's residual block of its partial sum all-reduced
    over that axis; else `TP.out` under a tensor-parallel axis, or `y`."""
    lay = _layout()
    res = None if lay is None else lay.res
    mix = None if lay is None else lay.second(logical)
    if mix is not None:
        return mix.all_reduce(y if res is None else res.block(y))
    return y if res is None else res.out(y, logical)


def fsdp_gather(tree, spec):
    """`tree`'s leaves (nested dicts matching `spec`'s `ParamDef`s, which
    give each leaf's global shape and logical axes), each with its
    `embed` dimension all-gathered over the mesh axes other than the
    residual's that the active rules shard it over: its tensor-parallel
    block.  Each axis' gather sums the gradient in its backward where the
    ranks' parts differ (a batch axis; the second axis under a mixer's
    parameter, `MIXER_KEY`) and takes the rank's block elsewhere.  `tree` as it is when the rules shard no leaf so (no
    FSDP)."""
    rules, mesh = ax.get_rules(), ax.get_mesh()
    if rules is None or mesh is None or not any(
            ax.axis_sizes(mesh).get(a, 1) > 1
            for a in ax._names(rules.get("embed"))):
        return tree
    tp = ax.model_axis(rules, mesh)
    batch = set(ax.batch_axes(rules))
    mixer = ax.mixer_axis(rules, mesh)

    def one(w, pd, in_mixer):
        s = ax.divisible_spec(ax.spec_for(pd.axes, rules), pd.shape, mesh)
        for d, entry in enumerate(s):
            if pd.axes[d] != "embed":
                continue
            names = [a for a in ax._names(entry) if a != tp]
            if names and len(names) < len(ax._names(entry)):
                raise NotImplementedError(
                    f"{pd.axes}: dimension {d} is split over {entry}, the "
                    "tensor-parallel axis and others together")
            summed = [a in batch or (in_mixer and a == mixer)
                      for a in names]
            if len(set(summed)) > 1:    # innermost first, each its own
                for a, sm in reversed(list(zip(names, summed))):
                    group, n = ranks.axis_group(mesh, [a])
                    w = ranks.all_gather(w, d, group, n, summed=sm)
                continue
            group, n = ranks.axis_group(mesh, names)
            w = ranks.all_gather(w, d, group, n, summed=all(summed))
        return w

    def walk(t, sp, in_mixer):
        return {k: walk(v, sp[k], in_mixer or k == MIXER_KEY)
                if isinstance(v, dict) else one(v, sp[k], in_mixer)
                for k, v in t.items()}
    return walk(tree, spec, False)

"""Ranks: the process-group plumbing that `jax.distributed` and GSPMD
hide in `repro`.

One process per rank, in `torch.distributed`.  `init_ranks` joins the
process group (its address, size and rank given explicitly: nothing on
the machine announces a cluster) and picks the rank's device,
``cuda:{rank % device_count}`` (several ranks share a card when there
are fewer cards than ranks, or all of them one named card) or the CPU.
`spawn_ranks` starts a world of ranks on `torch.multiprocessing` and
returns what each rank's function returned.

The collectives are `all_reduce` (SUM, MAX) and
`all_gather_into_tensor`, which gloo takes on CUDA tensors (probed on
the H100 under torch 2.11) as NCCL does, so one code path serves two
ranks sharing a card over gloo and one rank per card over NCCL (NCCL
refuses two ranks on one card):

* `axis_group`: the process group of a mesh's axes, one axis's from the
  `DeviceMesh`, a product of axes (the flattened ``("pod", "data")``)
  made once per mesh and cached;
* `all_sum_`, `all_max_`: in place over a group;
* `gather_full`: a sharded leaf back to full, bitwise: the ranks'
  blocks gathered flat, each copied to its place;
* `batch_mean`: the mean over the active rules' batch axes with a
  gradient (what GSPMD's mean over a sharded batch is), for statistics
  that couple the rows of a batch (the MoE router's load-balance loss);
* the differentiable collectives of tensor parallelism and FSDP, over
  one group, each the transpose of its backward: `all_gather` along a
  dimension (backward: reduce-scatter), `reduce_scatter` (backward:
  all-gather), `all_reduce` (backward: the identity, for a sum of
  partial results that every rank then uses whole) and its conjugate
  `copy_to` (forward: the identity; backward: all-reduce), the entry of
  a column-parallel product whose input every rank holds whole; and
  `all_gather(..., summed=False)`, whose backward takes the rank's block
  of its own gradient, for ranks that use the gathered whole the same
  way (FSDP's gather over a second model axis outside the mixers).  The
  model code holds the residual as blocks, so its projections enter
  through `all_gather`; `copy_to` wraps a sum that every rank holds
  whole and uses only in part (the SSM gate norm's all-reduced mean
  square, `models.ssm._gate_norm`).  A reduce-scatter is an all-reduce
  and a slice, so two collectives are all the backends must take; it
  moves the whole sum where a reduce-scatter would move a block.  Rank
  g of a group holds block g: the groups of `axis_group` list their
  ranks in mesh order, major axis first, which is the order of
  `axes.NamedSharding.block`.

`traffic` counts the bytes each collective of this process handed to
the backend (an all-reduce its tensor, an all-gather its gathered
output), by name; a caller resets it (``traffic.clear()``) and reads it.
"""
from __future__ import annotations

import collections
import datetime
import os
import tempfile
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import axes as ax

TIMEOUT = datetime.timedelta(seconds=300)

# bytes handed to each collective by this process, by collective name
traffic: collections.Counter = collections.Counter()


def rank_device(rank: int, device: str = "cuda") -> torch.device:
    """The device of `rank`: for "cuda", ``cuda:{rank % device_count}``;
    a card named with its index (``"cuda:0"``) takes every rank; "cpu"
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("ranks on the card requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    if dev.index is not None:
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_ranks(backend: str, rank: int, world: int, init_method: str,
               device: str = "cuda") -> torch.device:
    """Join the process group of `world` ranks as `rank` (`init_method`
    e.g. ``tcp://localhost:<port>`` or ``file://<path>``); returns the
    rank's device, made current."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return dev


def _entry(rank, fn, world, backend, device, store, out_dir, args):
    dev = init_ranks(backend, rank, world, f"file://{store}", device)
    try:
        result = fn(rank, world, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, backend: str = "gloo",
                device: str = "cuda", args: Sequence = ()) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` on `world` new processes
    (spawned, so `fn` is a module-level function) joined over
    `backend`; returns each rank's return value (saved with
    `torch.save`; give CPU tensors), in rank order.  A rank that raises
    stops the others and raises here."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_entry, args=(fn, world, backend, device,
                                         os.path.join(tmp, "store"), tmp,
                                         tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]


# process groups of mesh axes, keyed by (id(mesh), axes); the mesh is
# kept beside its groups so that its id is not reused
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, Any]] = {}


def axis_group(mesh, names: Sequence[str]) -> Tuple[Any, int]:
    """(process group, size) of the mesh axes `names` that are larger than
    1, for this rank: None and 1 if there are none.  A product of several
    axes is a group made over every rank of the world the first time it
    is asked for, so every rank asks at the same point."""
    sizes = ax.axis_sizes(mesh)
    wide = tuple(a for a in names if sizes[a] > 1)
    n = 1
    for a in wide:
        n *= sizes[a]
    if not wide:
        return None, 1
    if len(wide) == 1:
        return mesh.get_group(wide[0]), n
    key = (id(mesh), wide)
    if key not in _GROUPS:
        dims = [list(mesh.mesh_dim_names).index(a) for a in wide]
        grid = mesh.mesh.movedim(dims, list(range(len(dims))))
        grid = grid.reshape(n, -1)
        mine = None
        for j in range(grid.shape[1]):
            ranks = grid[:, j].tolist()
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = group
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1], n


def all_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    traffic["all_reduce"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_max_(t: torch.Tensor, group=None) -> torch.Tensor:
    traffic["all_reduce"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def _gather_flat(local: torch.Tensor, n: int, group) -> torch.Tensor:
    """The `n` ranks' `local`s, flat and concatenated in group order."""
    flat = torch.empty(n * local.numel(), dtype=local.dtype,
                       device=local.device)
    traffic["all_gather"] += flat.numel() * flat.element_size()
    with warnings.catch_warnings():     # renamed all_gather_single in 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(flat, local.contiguous().reshape(-1),
                                    group=group)
    return flat


def gather_full(local: torch.Tensor, sharding: ax.NamedSharding,
                shape: Sequence[int]) -> torch.Tensor:
    """The full tensor of `shape` whose block on each rank of the
    sharding's mesh is that rank's `local`, bitwise.  Every rank of the
    mesh calls it."""
    shape = tuple(shape)
    if sharding.block(shape) is None:
        raise ValueError("gather_full on a rank outside the mesh")
    names = [a for e in sharding.spec for a in ax._names(e)]
    group, n = axis_group(sharding.mesh, names)
    if n == 1:
        return local.reshape(shape).clone()
    parts = _gather_flat(local, n, group).view((n,) + tuple(local.shape))
    full = torch.empty(shape, dtype=local.dtype, device=local.device)
    grid = sharding.mesh.mesh
    for g in range(n):
        coord = (grid == dist.get_global_rank(group, g)).nonzero()[0]
        full[sharding.block(shape, coord.tolist())] = parts[g]
    return full


def sharding_of(x) -> Optional[ax.NamedSharding]:
    """A DTensor's placements as a `NamedSharding` (its spec read back from
    its `Shard` placements); None for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return None
    names = list(x.device_mesh.mesh_dim_names)
    spec: List[List[str]] = [[] for _ in range(x.dim())]
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard):
            spec[p.dim].append(name)
    entries = [tuple(e) if len(e) > 1 else (e[0] if e else None)
               for e in spec]
    while entries and entries[-1] is None:
        entries.pop()
    return ax.NamedSharding(x.device_mesh, ax.P(*entries))


def gather_dtensor(x) -> torch.Tensor:
    """A DTensor's full value, from its local block and placements (see
    `gather_full`); a plain tensor is returned as it is."""
    sharding = sharding_of(x)
    if sharding is None:
        return x
    return gather_full(x.to_local(), sharding, x.shape)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) with a gradient: the backward sums the incoming
    gradients over the same group, the transpose of a sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_sum_(g.clone(), ctx.group), None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """`x`, a statistic of this rank's block of the batch (a mean over
    its rows), made the statistic of the whole batch: its mean over the
    active rules' batch axes, with a gradient.  The blocks have equal
    rows, so the mean of their means is the mean over the batch.  `x`
    itself with no rules or mesh active, or one rank on the batch."""
    rules, mesh = ax.get_rules(), ax.get_mesh()
    if rules is None or mesh is None:
        return x
    group, n = axis_group(mesh, ax.batch_axes(rules))
    if n == 1:
        return x
    return _SumOverRanks.apply(x, group) / torch.full(
        (), n, dtype=x.dtype, device=x.device)


def _cat_blocks(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    parts = _gather_flat(x, n, group).view((n,) + tuple(x.shape))
    return torch.cat(parts.unbind(0), dim=dim)


def _own_block(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's block of the sum of `x` over the group, along `dim`."""
    total = all_sum_(x.clone(memory_format=torch.contiguous_format), group)
    w = x.shape[dim] // n
    return total.narrow(dim, dist.get_rank(group) * w, w).clone()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _cat_blocks(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _AllGatherSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.r, ctx.w = dim, dist.get_rank(group), x.shape[dim]
        return _cat_blocks(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.r * ctx.w, ctx.w).clone(), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide over {n} ranks")
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _own_block(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _cat_blocks(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_sum_(x.clone(memory_format=torch.contiguous_format),
                        group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum_(g.clone(), ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group, n: int,
               summed: bool = True) -> torch.Tensor:
    """The `n` ranks' blocks `x` concatenated along `dim` (rank g's block
    at g); the backward sums the incoming gradients over the group and
    gives each rank its block (a reduce-scatter), or with `summed` off,
    for ranks that use the whole the same way (their gradients of it
    are equal and whole), takes the rank's block of its own.  `x` itself
    when n is 1."""
    if n == 1:
        return x
    return (_AllGather if summed else _AllGatherSame).apply(x, dim, group, n)


def reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of the ranks' `x`; the
    backward all-gathers the blocks' gradients.  `x` when n is 1."""
    return x if n == 1 else _ReduceScatter.apply(x, dim, group, n)


def all_reduce(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum of the ranks' `x`, on every rank; the backward passes the
    gradient through unchanged: each rank holds a partial result and uses
    the whole sum, so the gradient of its part is the sum's.  `x` when n
    is 1."""
    return x if n == 1 else _AllReduce.apply(x, group)


def copy_to(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """`x`, whose gradient is summed over the group in the backward: the
    conjugate of `all_reduce`, for a value every rank holds whole and
    uses in part.  `x` when n is 1."""
    return x if n == 1 else _CopyTo.apply(x, group)

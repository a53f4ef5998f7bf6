"""Meshes and logical-axis rules (port of `repro.sharding.axes`).

Two halves, as in the reference.

**Sweep meshes**: where the sharded engines put each slab of a grid.  A
sweep's grid is embarrassingly parallel (one lifecycle per configuration
or trial, nothing shared between them), so a mesh is only a placement:
a ``(dc, dt)`` grid of devices named (`CONFIG_AXIS`, `TRIAL_AXIS`).
`core.sweep.sharded_sweep` and `core.mc_sweep.sharded_mc_sweep` cut
their batch into slabs with it and run each slab on its device:

* a flat (configuration·trial) batch is product-sharded over both axes
  in device order (`batch_slabs`, `repro`'s `batch_spec`), so every
  ``(dc, dt)`` with the same device count gives the same slabs;
* a ``[B, T]`` grid is block-sharded, configurations over `CONFIG_AXIS`
  and trials over `TRIAL_AXIS` (`grid_blocks`, `repro`'s `grid_spec`).

A device list may name one device more than once, which puts several
slabs on it (``["cpu"] * 4`` on the CPU, ``["cuda:0"] * 2`` on one
card).

**Model meshes** ("pod", "data", "model", and `STAGE_AXIS` for the
pipeline): a `torch.distributed.device_mesh.DeviceMesh` of ranks, one
process per rank (`sharding.ranks`).  Model code names *logical* axes
(`Model.param_axes`, `Model.cache_axes`); a rule set maps them onto mesh
axes (`base_rules`, `fsdp_rules`, `pure_dp_rules`,
`sequence_parallel_rules`, and `opt_rules` for the ZeRO-1 optimizer
moments), and `spec_for` / `divisible_spec` turn a leaf's axes into a
`P`, the reference's `PartitionSpec` as a tuple.  `tree_shardings*`
give each leaf a `NamedSharding`: its spec on the mesh, as DTensor
placements (`Shard(d)` on each mesh dimension that names tensor
dimension d, `Replicate()` elsewhere) and as this rank's block of the
full tensor.  What GSPMD inserts implicitly in `repro` the port does
with explicit collectives on each axis's process group: the batch's in
`train.step.make_train_step(mesh=, rules=)`, tensor and expert
parallelism's, the SSM mixers', the KV cache's sequence and FSDP's in
the model code (`sharding.tp`).  The model is split over the
residual's mesh axis (`model_axis`) and, under `sequence_parallel_rules`
with "data" larger than 1, its mixers (attention's heads, the SSM's)
over a second one (`mixer_axis`); the sequence on a wide axis and the
encoder-decoder under wide layouts are not ported yet and raise
(`check_ported`, `Model.check_layout`).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

AxisVal = Union[None, str, Tuple[str, ...]]

# Mesh-axis names of a sweep's (configuration × trial) grid, `repro`'s.
CONFIG_AXIS = "config"
TRIAL_AXIS = "trial"

# Logical axes of the sweep engines onto mesh axes, `repro`'s table:
# "batch" is a flat (config·trial) axis product-sharded over both.
SWEEP_RULES: Dict[str, AxisVal] = {
    "config": CONFIG_AXIS,
    "trial": TRIAL_AXIS,
    "batch": (CONFIG_AXIS, TRIAL_AXIS),
}


@dataclass(frozen=True)
class SweepMesh:
    """A grid of devices with one name per axis.  `devices` is an object
    array of `torch.device`s of the mesh's shape, filled in the order of
    the device list."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]


def local_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """`devices` as `torch.device`s, each checked by `resolve_device`;
    None means every visible card, ``cuda:0 … cuda:{n−1}`` (it raises
    without one, as every entry point asked for the card does)."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("an empty device list")
    return devs


def _mesh(devs: List[torch.device], shape, names) -> SweepMesh:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return SweepMesh(grid.reshape(shape), tuple(names))


def config_mesh(devices: Optional[Sequence] = None) -> SweepMesh:
    """1-D mesh over `devices` (default: every visible card) with the
    single axis `CONFIG_AXIS`."""
    devs = local_devices(devices)
    return _mesh(devs, (len(devs),), (CONFIG_AXIS,))


def sweep_mesh(devices: Optional[Sequence] = None,
               shape: Optional[Tuple[int, int]] = None) -> SweepMesh:
    """2-D (`CONFIG_AXIS` × `TRIAL_AXIS`) mesh over `devices` (default:
    every visible card).  `shape=(dc, dt)` must multiply out to the
    device count; the default ``(D, 1)`` puts every device on the
    configuration axis."""
    devs = local_devices(devices)
    D = len(devs)
    if shape is None:
        shape = (D, 1)
    dc, dt = int(shape[0]), int(shape[1])
    if dc < 1 or dt < 1 or dc * dt != D:
        raise ValueError(
            f"mesh shape {shape} needs {max(dc, 1) * max(dt, 1)} devices, "
            f"got {D}")
    return _mesh(devs, (dc, dt), (CONFIG_AXIS, TRIAL_AXIS))


def batch_slabs(mesh: SweepMesh, lo: int,
                hi: int) -> List[Tuple[torch.device, int, int]]:
    """A flat batch ``[lo, hi)`` product-sharded over every mesh axis:
    D contiguous slabs of ``ceil((hi − lo) / D)`` entries (D devices),
    the k-th on the k-th device of the list, as (device, start, stop);
    a short batch leaves its last slabs empty (start ≥ stop)."""
    devs = list(mesh.devices.flat)
    width = -(-(hi - lo) // len(devs))
    return [(d, lo + k * width, min(lo + (k + 1) * width, hi))
            for k, d in enumerate(devs)]


def grid_blocks(mesh: SweepMesh, B: int, T: int) -> List[
        Tuple[torch.device, Tuple[int, int], Tuple[int, int]]]:
    """A ``[B, T]`` grid block-sharded over a (config, trial) mesh: the
    device at mesh position (i, j) takes configurations block i and
    trials block j, blocks of ``ceil(B / dc)`` and ``ceil(T / dt)``, as
    (device, (b0, b1), (t0, t1)) in the order of the device list; a
    short grid leaves blocks empty (b0 ≥ b1 or t0 ≥ t1)."""
    dc, dt = mesh.devices.shape
    bc, tc = -(-B // dc), -(-T // dt)
    return [(mesh.devices[i, j], (i * bc, min((i + 1) * bc, B)),
             (j * tc, min((j + 1) * tc, T)))
            for i in range(dc) for j in range(dt)]


# ---------------------------------------------------------------------------
# Model meshes: logical-axis rules, specs and shardings
# ---------------------------------------------------------------------------

# The pipeline's stage axis (`train.pipeline`), `repro`'s name.
STAGE_AXIS = "stage"

Rules = Dict[str, AxisVal]


class P(tuple):
    """A partition spec: one entry per tensor dimension, each None, a
    mesh-axis name or a tuple of names; ``tuple(P(...))`` is what
    ``tuple(jax.sharding.PartitionSpec(...))`` gives."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# Baseline rule set for the production mesh ("pod", "data", "model"):
# DP over (pod×data); TP/EP/vocab over model; optimizer state additionally
# sharded over data (ZeRO-1) via `opt_overrides`.
def base_rules(multi_pod: bool) -> Rules:
    data = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": data,
        "seq": None,
        "seq_kv": None,
        "embed": None,
        "act_embed": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "expert": "model",
        "expert_cap": None,
        "vocab": "model",
        "layers": None,
        "ssm_heads": "model",
        "ssm_state": None,
        "ssm_inner": "model",
        "conv": None,
        "frontend": None,
    }


def _data_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def opt_overrides(multi_pod: bool) -> Rules:
    """ZeRO-1: the moments sharded over the data axes on `embed`."""
    return {"embed": _data_axes(multi_pod), "layers": None}


def fsdp_rules(rules: Rules, multi_pod: bool) -> Rules:
    """ZeRO-3/FSDP: the parameters themselves sharded over the data axes
    on their `embed` dimension."""
    r = dict(rules)
    r["embed"] = _data_axes(multi_pod)
    return r


def pure_dp_rules(multi_pod: bool) -> Rules:
    """Full data parallelism: the batch over (data×model), the weights
    replicated (the moments still ZeRO-1 under `opt_rules`); multi-pod
    also splits the sequence over `pod`."""
    r: Rules = {k: None for k in base_rules(multi_pod)}
    r["batch"] = ("data", "model")
    if multi_pod:
        r["seq"] = "pod"
    return r


def sequence_parallel_rules(multi_pod: bool) -> Rules:
    """Long-context decode: the KV sequence over `model`, heads and SSM
    state over `data`; the weights keep their tensor-parallel rules."""
    r = dict(base_rules(multi_pod))
    r["batch"] = None
    r["seq_kv"] = "model"
    r["heads"] = "data"
    r["kv_heads"] = "data"
    r["ssm_heads"] = "data"
    r["ssm_inner"] = "data"
    return r


def opt_rules(rules: Rules, multi_pod: bool = False) -> Rules:
    r = dict(rules)
    r.update(opt_overrides(multi_pod))
    return r


class _Active:
    """The active rules and mesh.  Process-wide, not per thread (the
    reference keeps them per thread): the autograd engine runs a CUDA
    backward, and the recomputation of a remat'd layer with it, on its
    own device thread, which must see the rules the forward saw.  One
    process is one rank."""
    rules: Optional[Rules] = None
    mesh: Any = None


_state = _Active()


def set_rules(rules: Optional[Rules], mesh=None):
    _state.rules = rules
    _state.mesh = mesh


def get_rules() -> Optional[Rules]:
    return _state.rules


def get_mesh():
    return _state.mesh


@contextlib.contextmanager
def use_rules(rules: Rules, mesh=None):
    prev_r, prev_m = get_rules(), get_mesh()
    set_rules(rules, mesh)
    try:
        yield
    finally:
        set_rules(prev_r, prev_m)


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh-axis name → size, of a `DeviceMesh` or of any object with
    `axis_names` and `devices.shape` (a `SweepMesh`, `repro`'s `Mesh`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for(axes: Sequence[Optional[str]],
             rules: Optional[Rules] = None) -> P:
    """Logical axes tuple → `P` under `rules` (default: the active ones);
    a mesh axis is used once, by the first dimension that names it."""
    rules = rules if rules is not None else get_rules()
    if rules is None:
        return P()
    out, used = [], set()
    for a in axes:
        v = rules.get(a) if a is not None else None
        if v is None:
            out.append(None)
            continue
        vs = tuple(x for x in _names(v) if x not in used)
        used.update(vs)
        out.append(vs if len(vs) > 1 else (vs[0] if vs else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def divisible_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop (or shrink to a divisible prefix) every mapping whose mesh
    extent does not divide the dimension, as the reference must for
    GSPMD's argument shardings: such a dimension is replicated."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        kept, k = [], 1
        for a in _names(entry):
            if shape[i] % (k * sizes[a]) == 0:
                kept.append(a)
                k *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def batch_axes(rules: Rules) -> Tuple[str, ...]:
    """The mesh axes the rules put the batch on."""
    return _names(rules.get("batch"))


# what the next slices port (ROADMAP queue 1, items 11b.2 and 11b.3)
NEXT_SLICE = ("the next slices of the port (ROADMAP queue 1, item 11b.2 "
              "and item 11b.3): pure_dp_rules(True)'s sequence over 'pod' "
              "and the encoder-decoder under wide layouts")

# logical axes that split the model: tensor and expert parallelism's,
# the SSM mixers' and the KV cache's sequence
MODEL_LOGICAL = ("act_embed", "heads", "kv_heads", "mlp", "expert",
                 "vocab", "ssm_heads", "ssm_inner", "seq_kv")
# those of the mixers (attention's heads, the SSM's), which may lie on a
# second wide axis beside the residual's (`sequence_parallel_rules`)
MIXER_LOGICAL = ("heads", "kv_heads", "ssm_heads", "ssm_inner")


def _wide(rules: Rules, k: str, sizes) -> List[str]:
    return [a for a in _names(rules.get(k)) if sizes.get(a, 1) > 1]


def _mixer_axes(rules: Rules, sizes, residual) -> List[str]:
    """The wide mesh axes other than the residual's that the rules put a
    mixer's logical axis on, in the order they first appear."""
    out: List[str] = []
    for k in MIXER_LOGICAL:
        out += [a for a in _wide(rules, k, sizes)
                if a not in residual and a not in out]
    return out


def check_ported(rules: Rules, mesh, logical=None):
    """Raise `NotImplementedError`, naming the next slices, if `rules` put
    one of the logical axes (of `logical`, default all) where the port
    does not go yet: the sequence (`seq`: `pure_dp_rules(True)`) on a
    mesh axis larger than 1, a model-parallel axis (`MODEL_LOGICAL`) on
    a wide batch axis, the residual (`act_embed`) over several wide axes,
    or a model-parallel axis on a wide axis other than the residual's
    unless it is a mixer's (`MIXER_LOGICAL`) on one second axis, with no
    wide batch axis and the K/V heads where the heads are
    (`sequence_parallel_rules` with "data" > 1).  The port never
    replicates what the rules shard."""
    sizes = axis_sizes(mesh)
    residual = _wide(rules, "act_embed", sizes)
    batch = set(batch_axes(rules))
    wide_batch = sorted(a for a in batch if sizes.get(a, 1) > 1)
    if len(residual) > 1 or batch & set(residual):
        raise NotImplementedError(
            f"the rules put the residual ('act_embed') on {residual} with "
            f"the batch on {sorted(batch)}: a residual over several mesh "
            f"axes or a batch axis is not ported")
    mixers = _mixer_axes(rules, sizes, residual)
    heads, kv = _wide(rules, "heads", sizes), _wide(rules, "kv_heads", sizes)
    for k in (logical if logical is not None else rules):
        if k == "seq":
            wide = _wide(rules, k, sizes)
            if wide:
                raise NotImplementedError(
                    f"the rules put 'seq' on mesh axis {wide[0]!r} of size "
                    f"{sizes[wide[0]]}: the sequence over a mesh axis "
                    f"comes in {NEXT_SLICE}")
        elif k in MODEL_LOGICAL:
            wide = _wide(rules, k, sizes)
            on_batch = [a for a in wide if a in batch]
            if on_batch:
                raise NotImplementedError(
                    f"the rules put {k!r} on the batch axis "
                    f"{on_batch[0]!r} of size {sizes[on_batch[0]]}: a "
                    f"model-parallel axis on a wide batch axis is not "
                    f"ported")
            other = [a for a in wide if a not in residual]
            if other and (k not in MIXER_LOGICAL or len(wide) > 1
                          or len(mixers) > 1 or wide_batch
                          or (kv and kv != heads)):
                raise NotImplementedError(
                    f"the rules put {k!r} on mesh axis {other[0]!r} of "
                    f"size {sizes[other[0]]}, the residual ('act_embed') "
                    f"on {residual or 'no wide axis'}, the mixers' second "
                    f"axes on {mixers} and the batch on wide axes "
                    f"{wide_batch}: only the mixers (heads, K/V heads "
                    f"with them, SSM heads and columns) may take one "
                    f"second wide axis, and only with no wide batch axis")


def model_axis(rules: Rules, mesh) -> Optional[str]:
    """The mesh axis the residual is split over: the residual's
    (`act_embed`'s) if it is larger than 1, else None; a layout the port
    does not run raises (`check_ported`)."""
    check_ported(rules, mesh)
    wide = _wide(rules, "act_embed", axis_sizes(mesh))
    return wide[0] if wide else None


def mixer_axis(rules: Rules, mesh) -> Optional[str]:
    """The second wide mesh axis that the rules put the mixers on, beside
    the residual's ("data" under `sequence_parallel_rules` with "data"
    larger than 1), else None; a layout the port does not run raises
    (`check_ported`)."""
    check_ported(rules, mesh)
    sizes = axis_sizes(mesh)
    wide = _mixer_axes(rules, sizes, _wide(rules, "act_embed", sizes))
    return wide[0] if wide else None


def wide_axis(rules: Rules, mesh, logical: str) -> Optional[str]:
    """The mesh axis larger than 1 that `rules` put `logical` on, else
    None (`check_ported` allows at most one)."""
    wide = _wide(rules, logical, axis_sizes(mesh))
    return wide[0] if wide else None


def on_axis(rules: Rules, axis: str) -> frozenset:
    """The model-parallel logical axes that `rules` put on mesh axis
    `axis`."""
    return frozenset(k for k in MODEL_LOGICAL if axis in _names(rules.get(k)))


def shard(x, *axes):
    """The reference's sharding constraint.  With no rules or mesh active
    it returns `x`.  Under a model mesh each rank already holds its block
    of `x` (the model code places it: `sharding.tp`), so it returns `x`
    after checking that the rules put none of its axes where the port
    does not go yet (`check_ported`)."""
    rules, mesh = get_rules(), get_mesh()
    if rules is None or mesh is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"{len(axes)} logical axes for a {x.dim()}-d "
                         "tensor")
    check_ported(rules, mesh, axes)
    return x


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(fn, axes_tree, *trees):
    """`fn(axes, *leaves)` over the leaves of a logical-axes tree (tuples
    of names; dicts, namedtuples and lists are walked) and the matching
    leaves of `trees`, which have the axes tree's structure."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (tuple, list)):
        vals = [map_axes(fn, a, *(t[i] for t in trees))
                for i, a in enumerate(axes_tree)]
        if hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*vals)
        return type(axes_tree)(vals)
    raise TypeError(f"not a logical-axes tree node: {axes_tree!r}")


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a model mesh: where each rank's block of a tensor lies."""
    mesh: Any
    spec: P

    @property
    def placements(self):
        """DTensor placements, one per mesh dimension.  A tuple entry
        shards its dimension over its axes major first, which DTensor's
        repeated `Shard(d)` expresses when they follow the mesh's order."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            dims = [names.index(a) for a in _names(entry)]
            if dims != sorted(dims):
                raise ValueError(f"{self.spec}: the axes of dimension {d} "
                                 f"do not follow the mesh order {names}")
            for i in dims:
                out[i] = Shard(d)
        return tuple(out)

    def block(self, shape: Sequence[int],
              coord: Optional[Sequence[int]] = None
              ) -> Optional[Tuple[slice, ...]]:
        """The block of a tensor of `shape` at mesh coordinate `coord`
        (default: this rank's), as one slice per dimension; None on a
        rank outside the mesh."""
        if coord is None:
            coord = self.mesh.get_coordinate()
        if coord is None:
            return None
        names = list(self.mesh.mesh_dim_names)
        sizes = axis_sizes(self.mesh)
        out = [slice(None)] * len(shape)
        for d, entry in enumerate(self.spec):
            idx, n = 0, 1
            for a in _names(entry):
                idx = idx * sizes[a] + coord[names.index(a)]
                n *= sizes[a]
            if n > 1:
                if shape[d] % n:
                    raise ValueError(f"dimension {d} of {tuple(shape)} does "
                                     f"not divide over {entry!r}")
                w = shape[d] // n
                out[d] = slice(idx * w, (idx + 1) * w)
        return tuple(out)

    def distribute(self, local, shape: Sequence[int]):
        """A DTensor of global `shape` whose block on this rank is
        `local` (no communication)."""
        from torch.distributed.tensor import DTensor
        stride, acc = [], 1
        for n in reversed(shape):
            stride.append(acc)
            acc *= n
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=tuple(shape),
                                  stride=tuple(reversed(stride)))

    def place(self, full):
        """`full` as a DTensor holding a copy of this rank's block."""
        sl = self.block(full.shape)
        local = full[sl].clone() if sl is not None else full.new_empty(0)
        return self.distribute(local, full.shape)


def tree_specs(axes_tree, rules: Optional[Rules] = None):
    """Axes tree → `P` tree."""
    return map_axes(lambda a: spec_for(a, rules), axes_tree)


def tree_shardings(axes_tree, mesh, rules: Optional[Rules] = None):
    return map_axes(lambda a: NamedSharding(mesh, spec_for(a, rules)),
                    axes_tree)


def tree_shardings_matched(axes_tree, abstract_tree, mesh,
                           rules: Optional[Rules] = None):
    """Shape-aware shardings: like `tree_shardings`, with the mappings
    that do not divide a leaf's dimension dropped (`divisible_spec`).
    `abstract_tree` has the axes tree's structure and leaves with a
    `.shape` (tensors, `ParamDef`s)."""
    return map_axes(lambda a, x: NamedSharding(
        mesh, divisible_spec(spec_for(a, rules), tuple(x.shape), mesh)),
        axes_tree, abstract_tree)

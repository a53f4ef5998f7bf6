"""Rank functions for the tensor-, expert- and FSDP-parallel tests of the
port (`tests/test_torch_tp_train.py` on gloo ranks of the CPU,
`tests/test_torch_cuda.py` on gloo ranks of one card).

Like `tests/torch_dp_workers.py`'s, they import neither jax nor repro and
return CPU tensors and numbers.  The parameters start from numpy (the
port's float32 init, the same numbers `repro` takes) and reach each rank
as DTensors of its blocks (`convert.params_from_numpy(..., shardings=)`);
each rank takes its block of rows of the global batch by its index on
the batch axes.  The global batch of a step is
`torch_dp_workers.global_batch(vocab, step, 2)`, what the data-parallel
tests' W = 2 ranks read, whatever the layout's batch ranks.
"""
from dataclasses import replace

import torch

import torch_dp_workers as DPW
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import tree_flatten
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.sharding import axes as ax
from repro_torch.sharding import ranks
from repro_torch.train.step import make_train_step, opt_shardings

NAMES = DPW.NAMES
ODD_VOCAB = 511


def smoke(arch, vocab=None):
    """The smoke config; qwen3's with remat "full", so that the ranks'
    collectives are recomputed in the backward (the math is the same)."""
    cfg = get_smoke_config(arch)
    if arch == "qwen3-1.7b":
        cfg = replace(cfg, remat="full")
    return replace(cfg, vocab=vocab) if vocab else cfg


# name → (world, mesh shape, rules, archs, steps, vocab); step i is a
# `make_train_step` with accum i + 1 from the start, on step i's batch:
# each compares the layout with one device after one update, where a
# second update would compare the first's rounding, which Adam makes
# O(lr) for elements whose gradient is near 0, as much as the layout
BASE = ax.base_rules(False)
LAYOUTS = {
    "tp2": (2, (1, 1, 2), BASE, DPW.ARCHS, 2, None),
    "odd_vocab": (2, (1, 1, 2), BASE, ("granite-moe-1b-a400m",), 1,
                  ODD_VOCAB),
    "dp2_tp2": (4, (1, 2, 2), BASE, DPW.ARCHS, 2, None),
    "fsdp": (4, (1, 2, 2), ax.fsdp_rules(BASE, False), DPW.ARCHS, 2, None),
    "fsdp_pure_dp": (4, (1, 2, 2), ax.fsdp_rules(ax.pure_dp_rules(False),
                                                 False),
                     ("qwen3-1.7b",), 1, None),
    "kv_fallback": (4, (1, 1, 4), BASE, ("qwen3-1.7b",), 1, None),
}


def global_batch(vocab, step):
    return DPW.global_batch(vocab, step, 2)


def batch_rows(mesh, rules, vocab, step):
    """This rank's rows of `global_batch`: its block on the batch axes."""
    n = 1
    for a in ax.batch_axes(rules):
        n *= ax.axis_sizes(mesh)[a]
    k, rows = DPW.batch_index(mesh, rules), DPW.ROWS
    return global_batch(vocab, step)[k * rows // n:(k + 1) * rows // n]


def snapshot(params, opt, metrics):
    """The state after a step, on the CPU: each parameter and moment
    gathered whole, each parameter's local block with its (start, stop)
    per dimension, and the metrics."""
    def bounds(x):
        s = ranks.sharding_of(x)
        return tuple((sl.start or 0, n if sl.stop is None else sl.stop)
                     for sl, n in zip(s.block(x.shape), x.shape))
    flat_p = tree_flatten(params)[0]
    return dict(
        params=[ranks.gather_dtensor(p).cpu() for p in flat_p],
        local=[(p.to_local().cpu().clone(), bounds(p)) for p in flat_p],
        mu=[ranks.gather_dtensor(m).cpu() for m in tree_flatten(opt.mu)[0]],
        nu=[ranks.gather_dtensor(v).cpu() for v in tree_flatten(opt.nu)[0]],
        step=int(opt.step),
        metrics={k: float(v) for k, v in metrics.items()})


def layout_steps(name, rank, device, start):
    """`LAYOUTS[name]`'s steps of each of its archs, each from `start`
    ((arch, vocab) → numpy params), each step's snapshot; and the first
    arch's model, params after step 0, mesh and rules."""
    world, shape, rules, archs, steps, vocab = LAYOUTS[name]
    mesh = make_test_mesh(shape, NAMES, device.type)
    cfg_o = adamw.AdamWConfig(**DPW.OPT)
    out, first = {}, None
    for arch in archs:
        model = build_model(smoke(arch, vocab), device)
        snaps = []
        for step in range(steps):
            params = convert.params_from_numpy(
                start[arch, vocab], model.spec, device,
                shardings=model.param_shardings(mesh, rules))
            opt = adamw.init(params, opt_shardings(model, mesh, rules))
            fn = make_train_step(model, cfg_o, step + 1, mesh=mesh,
                                 rules=rules)
            b = {"tokens": torch.as_tensor(batch_rows(
                mesh, rules, model.cfg.vocab, step), device=device)}
            params, opt, met = fn(params, opt, b)
            snaps.append(snapshot(params, opt, met))
            if first is None:
                first = (model, params, mesh, rules)
        out[arch] = snaps
    return out, first


def collectives_rank(rank, world, device):
    """Each differentiable collective of `sharding.ranks` over the whole
    world on rank-dependent inputs: (forward, gradient of the input) under
    a rank-dependent output gradient."""
    import torch.distributed as dist
    group = dist.group.WORLD
    out = {}
    x0 = torch.arange(12, dtype=torch.float32, device=device).reshape(3, 4)
    fns = {
        "all_gather": lambda x: ranks.all_gather(x, 1, group, world),
        "reduce_scatter": lambda x: ranks.reduce_scatter(x, 1, group, world),
        "all_reduce": lambda x: ranks.all_reduce(x, group, world),
        "copy_to": lambda x: ranks.copy_to(x, group, world),
    }
    for name, fn in fns.items():
        x = (x0 * (rank + 1)).requires_grad_()
        y = fn(x)
        g = torch.full_like(y, 1.0) + torch.arange(
            y.numel(), dtype=y.dtype, device=device).reshape(y.shape) * (
                10.0 ** rank)
        (gx,) = torch.autograd.grad(y, x, g)
        out[name] = (y.detach().cpu(), gx.cpu())
    return out


def survivors_rank(rank, world, device, start, final, tokens):
    """`tp2`'s qwen3 tree after its steps (`final`) and its start, each
    resharded onto a survivors mesh of rank 0 alone: rank 0's leaves
    against the gathered ones, and the loss there of the start on
    `tokens`."""
    model, params, _, rules = final
    axes = model.param_axes()
    new = elastic.survivors_mesh(list(range(1, world)), (1, 1, 1), NAMES,
                                 device.type)
    full = [ranks.gather_dtensor(p) for p in tree_flatten(params)[0]]
    moved = elastic.reshard(params, axes, new, rules)
    fresh = elastic.reshard(convert.params_from_numpy(
        start, model.spec, device, shardings=model.param_shardings(
            final[2], rules)), axes, new, rules)
    out = dict(sizes=[p.to_local().numel() for p in tree_flatten(moved)[0]])
    if rank == 0:
        out["equal"] = [torch.equal(a.to_local(), b) for a, b in
                        zip(tree_flatten(moved)[0], full)]
        with ax.use_rules(rules, new), torch.no_grad():
            loss, _ = model.loss(fresh, {"tokens": torch.as_tensor(
                tokens, device=device)})
        out["loss"] = float(loss)
    return out


def tp_world_rank(rank, world, device, start, tokens):
    """Every layout of `LAYOUTS` with this world size, in turn; W = 2 also
    the collectives and the survivors' reshard."""
    torch.set_num_threads(1)
    out = {}
    for name, (w, *_) in LAYOUTS.items():
        if w != world:
            continue
        out[name], final = layout_steps(name, rank, device, start)
        if name == "tp2":
            out["survivors"] = survivors_rank(
                rank, world, device, start["qwen3-1.7b", None], final,
                tokens)
    if world == 2:
        out["collectives"] = collectives_rank(rank, world, device)
    return out


def card_rank(rank, world, device, start, tokens):
    """The collectives on card tensors beside the same calls on CPU
    tensors (a gloo group of the world), and qwen3's smoke scoring loss
    under `base_rules` on (1, 1, W), float32, with the flash op and with
    the plain attention, TF32 off, each with its flash launches: what
    `tests/test_torch_cuda.py` holds."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = collectives_rank(rank, world, device)
    cpu = collectives_rank(rank, world, torch.device("cpu"))
    mesh = make_test_mesh((1, 1, world), NAMES, device.type)
    losses = {}
    for flash in (False, True):
        model = build_model(replace(smoke("qwen3-1.7b"),
                                    use_flash_kernel=flash), device)
        params = convert.params_from_numpy(
            start, model.spec, device,
            shardings=model.param_shardings(mesh, BASE))
        from repro_torch.kernels.flash_attention import ops as fa
        fa.flash_attention_bhsd.launches = 0
        with ax.use_rules(BASE, mesh), torch.no_grad():
            loss, _ = model.loss(params, {"tokens": torch.as_tensor(
                tokens, device=device)})
        losses[flash] = (float(loss), fa.flash_attention_bhsd.launches)
    dist.barrier()
    return dict(card=card, cpu=cpu, losses=losses)

"""Rank functions for the multi-rank tests of the port
(`tests/test_torch_dp_train.py` on gloo ranks of the CPU,
`tests/test_torch_cuda.py` on gloo ranks of one card).

`repro_torch.sharding.ranks.spawn_ranks` runs them, one process per
rank; they import neither jax nor repro, so a rank starts with torch
alone.  Each returns CPU tensors and numbers, which the test holds
against the reference.  The data: each rank reads its block of the
global batch through the `TokenPipeline` with `shard_id` = its index on
the batch axes and `num_shards` = their size, so the global batch is the
blocks concatenated in rank order (`global_batch`).
"""
import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import tree_flatten
from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.compression import (compressed_psum,
                                           ef_compress_grads, ef_init)
from repro_torch.runtime import elastic
from repro_torch.sharding import axes as ax
from repro_torch.sharding import ranks
from repro_torch.train.pipeline import pipeline, split_stages
from repro_torch.train.step import make_train_step, opt_shardings

ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m")
OPT = dict(lr=1e-2, warmup_steps=2)
ROWS, SEQ = 8, 32            # the global batch
NAMES = ("pod", "data", "model")
# world → (mesh shape, rules): W = 1 and 2 pure data parallel, W = 4 the
# reference's multi-pod base rules on a (2, 2, 1) mesh
LAYOUTS = {1: ((1, 1, 1), ax.pure_dp_rules(False)),
           2: ((1, 2, 1), ax.pure_dp_rules(False)),
           4: ((2, 2, 1), ax.base_rules(True))}


def block(vocab, step, k, world, rows=ROWS, seq=SEQ):
    """Rank k's rows of the global batch at `step`."""
    return TokenPipeline(PipelineConfig(rows // world, seq, vocab,
                                        shard_id=k,
                                        num_shards=world))._batch_at(step)


def global_batch(vocab, step, world, rows=ROWS, seq=SEQ):
    return np.concatenate([block(vocab, step, k, world, rows, seq)
                           for k in range(world)])


def psum_inputs(world, seed=0):
    """Each rank's input to `compressed_psum`: [6, 5] normals, a scale per
    rank, so that one rank's largest magnitude sets the shared scale."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((6, 5)) * (1.0 + 3.0 * r)).astype(
        np.float32) for r in range(world)]


def snapshot(params, opt, metrics):
    """(params, moments, metrics) on the CPU: params full; each moment as
    (its local block, its spec, the block's (start, stop) per dimension)."""
    def moment(m):
        s = ranks.sharding_of(m)
        full_shape = tuple(m.shape)
        sl = s.block(full_shape)
        bounds = tuple((x.start or 0, full_shape[i] if x.stop is None else
                        x.stop) for i, x in enumerate(sl))
        return (m.to_local().detach().cpu().clone(), tuple(s.spec), bounds)
    flat_p, _ = tree_flatten(params)
    return dict(
        params=[p.detach().cpu().clone() for p in flat_p],
        mu=[moment(m) for m in tree_flatten(opt.mu)[0]],
        nu=[moment(m) for m in tree_flatten(opt.nu)[0]],
        step=int(opt.step),
        metrics={k: float(v) for k, v in metrics.items()})


def three_steps(model, params, mesh, rules, k, world, device):
    """Three data-parallel steps from `params`: accum 1, accum 2, then the
    error-feedback compressor (`tests/test_torch_train.py`'s sequence);
    each step's snapshot, and the final (params, opt)."""
    cfg = adamw.AdamWConfig(**OPT)
    opt = adamw.init(params, opt_shardings(model, mesh, rules))
    box = {"r": ef_init(params)}

    def compressor(grads, opt_state):
        grads, box["r"] = ef_compress_grads(grads, box["r"])
        return grads, opt_state
    kw = dict(mesh=mesh, rules=rules)
    fns = (make_train_step(model, cfg, **kw),
           make_train_step(model, cfg, 2, **kw),
           make_train_step(model, cfg, compressor=compressor, **kw))
    out = []
    for step, fn in enumerate(fns):
        b = {"tokens": torch.as_tensor(block(model.cfg.vocab, step, k,
                                             world), device=device)}
        params, opt, met = fn(params, opt, b)
        out.append(snapshot(params, opt, met))
    return out, params, opt


def batch_index(mesh, rules):
    """This rank's block index on the rules' batch axes."""
    rows = ax.NamedSharding(mesh, ax.P(ax.batch_axes(rules)))
    n = 1
    for a in ax.batch_axes(rules):
        n *= ax.axis_sizes(mesh)[a]
    return rows.block((n,))[0].start or 0


def dp_rank(rank, world, device, start):
    """The data-parallel steps of each arch in `start` (arch → numpy
    float32 params) on this world's layout (`LAYOUTS`): the snapshots,
    and each arch's final (model, params, opt, mesh, rules)."""
    shape, rules = LAYOUTS[world]
    mesh = make_test_mesh(shape, NAMES, device.type)
    k = batch_index(mesh, rules)
    out, final = {}, {}
    for arch in ARCHS:
        model = build_model(get_smoke_config(arch), device)
        params = convert.params_from_numpy(start[arch], model.spec, device)
        out[arch], params, opt = three_steps(model, params, mesh, rules, k,
                                             world, device)
        final[arch] = (model, params, opt, mesh, rules)
    return out, final


def one_rank(rank, world, device, start):
    """W = 1: the data-parallel steps and `make_train_step` without a
    mesh, from the same params on the same batches."""
    torch.set_num_threads(1)
    out, _ = dp_rank(rank, world, device, start)
    cfg = adamw.AdamWConfig(**OPT)
    plain = {}
    for arch in ARCHS:
        model = build_model(get_smoke_config(arch), device)
        params = convert.params_from_numpy(start[arch], model.spec, device)
        opt = adamw.init(params)
        box = {"r": ef_init(params)}

        def compressor(grads, opt_state):
            grads, box["r"] = ef_compress_grads(grads, box["r"])
            return grads, opt_state
        steps = []
        for step, fn in enumerate((
                make_train_step(model, cfg), make_train_step(model, cfg, 2),
                make_train_step(model, cfg, compressor=compressor))):
            b = {"tokens": torch.as_tensor(block(model.cfg.vocab, step, 0,
                                                 1), device=device)}
            params, opt, met = fn(params, opt, b)
            steps.append(dict(
                params=[p.clone() for p in tree_flatten(params)[0]],
                mu=[m.clone() for m in tree_flatten(opt.mu)[0]],
                nu=[v.clone() for v in tree_flatten(opt.nu)[0]],
                metrics={k: float(v) for k, v in met.items()}))
        plain[arch] = steps
    return dict(dp=out, plain=plain)


def refused(world, device):
    """The layouts the data-parallel step once refused, and those it still
    refuses, each from qwen3's smoke model (or Mamba2's for an SSM under a
    wide "model" axis): (name, the `NotImplementedError`'s message or None,
    the loss of one step on the layout, the one-process step's loss on the
    same global batch)."""
    cases = []
    wide = {2: [("model axis", (1, 1, 2), ax.base_rules(False)),
                ("ssm under model", (1, 1, 2), ax.base_rules(False))],
            4: [("model axis", (1, 2, 2), ax.base_rules(False)),
                ("fsdp", (2, 2, 1),
                 ax.fsdp_rules(ax.base_rules(True), True)),
                ("sequence parallel", (2, 2, 1),
                 ax.sequence_parallel_rules(True)),
                ("pure dp multi-pod (seq over pod)", (2, 2, 1),
                 ax.pure_dp_rules(True)),
                ("ssm under model", (1, 2, 2), ax.base_rules(False))]}[world]
    cfg = adamw.AdamWConfig(**OPT)
    for name, shape, rules in wide:
        arch = "mamba2-2.7b" if name.startswith("ssm") else "qwen3-1.7b"
        model = build_model(get_smoke_config(arch), device)
        mesh = make_test_mesh(shape, NAMES, device.type)
        try:
            step = make_train_step(model, cfg, mesh=mesh, rules=rules)
        except NotImplementedError as exc:
            cases.append((name, str(exc), None, None))
            continue
        tokens = global_batch(model.cfg.vocab, 0, 2)
        n = 1
        for a in ax.batch_axes(rules):
            n *= ax.axis_sizes(mesh)[a]
        k = batch_index(mesh, rules)
        params = model.init(torch.Generator().manual_seed(0), torch.float32,
                            model.param_shardings(mesh, rules))
        _, _, met = step(params, adamw.init(params, opt_shardings(
            model, mesh, rules)), {"tokens": torch.as_tensor(
                tokens[k * ROWS // n:(k + 1) * ROWS // n], device=device)})
        full = model.init(torch.Generator().manual_seed(0), torch.float32)
        _, _, one = make_train_step(model, cfg)(
            full, adamw.init(full), {"tokens": torch.as_tensor(
                tokens, device=device)})
        cases.append((name, None, float(met["loss"]), float(one["loss"])))
    return cases


def psum_rank(rank, world, device):
    xs = psum_inputs(world)
    return compressed_psum(torch.as_tensor(xs[rank], device=device)).cpu()


def elastic_rank(rank, world, device, final, start, tokens):
    """The state after qwen3's three steps (`final`), resharded onto a
    survivors mesh of rank 0 alone: rank 0's leaves against the full
    values, and the loss there of `start` on `tokens`."""
    model, params, opt, _, rules = final
    axes = model.param_axes()
    full_mu = [ranks.gather_dtensor(m) for m in tree_flatten(opt.mu)[0]]
    new = elastic.survivors_mesh(list(range(1, world)), (1, 1, 1), NAMES,
                                 device.type)
    p_new = elastic.reshard(params, axes, new, rules)
    mu_new = elastic.reshard(opt.mu, axes, new, ax.opt_rules(rules, True))
    fresh = elastic.reshard(convert.params_from_numpy(start, model.spec,
                                                      device), axes, new,
                            rules)
    out = dict(sizes=[m.to_local().numel() for m in tree_flatten(mu_new)[0]])
    if rank == 0:
        out["params_equal"] = [torch.equal(a.to_local(), b) for a, b in zip(
            tree_flatten(p_new)[0], tree_flatten(params)[0])]
        out["mu_equal"] = [torch.equal(a.to_local(), b) for a, b in
                           zip(tree_flatten(mu_new)[0], full_mu)]
        _, treedef = tree_flatten(params)
        with ax.use_rules(rules, new), torch.no_grad():
            loss, _ = model.loss(treedef.unflatten(
                [p.to_local() for p in tree_flatten(fresh)[0]]),
                {"tokens": torch.as_tensor(tokens, device=device)})
        out["loss"] = float(loss)
    return out


def _mlp_stage(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def pipeline_rank(rank, world, device, fwd, bwd):
    """`repro`'s pipeline tests on a 1-D stage mesh of the world: the
    forward of an 8-layer tanh MLP stack (4 microbatches), and the
    gradients of sum(y²) through a 4-layer stack (2 microbatches)."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh(device.type, torch.arange(world),
                      mesh_dim_names=(ax.STAGE_AXIS,))
    (w, b, x), (w2, b2, x2) = fwd, bwd
    on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    pipe = pipeline(_mlp_stage, mesh, n_microbatches=4)
    out = pipe(split_stages({"w": on(w), "b": on(b)}, world), on(x))
    staged = split_stages({"w": on(w2), "b": on(b2)}, world)
    for a in staged.values():
        a.requires_grad_()
    pipe2 = pipeline(_mlp_stage, mesh, n_microbatches=2)
    loss = torch.sum(pipe2(staged, on(x2)) ** 2)
    gw, gb = torch.autograd.grad(loss, [staged["w"], staged["b"]])
    return dict(out=out.detach().cpu(), loss=float(loss.detach()),
                gw=gw.cpu(), gb=gb.cpu())


def world_rank(rank, world, device, start, tokens, fwd, bwd):
    """Everything a test world runs, one spawn per layout."""
    torch.set_num_threads(1)
    dp, final = dp_rank(rank, world, device, start)
    out = dict(dp=dp, psum=psum_rank(rank, world, device),
               refused=refused(world, device))
    if world == 2:
        out["elastic"] = elastic_rank(rank, world, device,
                                      final["qwen3-1.7b"],
                                      start["qwen3-1.7b"], tokens)
    if world == 4:
        out["pipeline"] = pipeline_rank(rank, world, device, fwd, bwd)
    return out


def card_rank(rank, world, device, start):
    """`compressed_psum` and qwen3's three smoke DP steps (W = 2), TF32
    off: what `tests/test_torch_cuda.py` holds on the card against the
    same on CPU ranks."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, rules = LAYOUTS[world]
    mesh = make_test_mesh(shape, NAMES, device.type)
    model = build_model(get_smoke_config("qwen3-1.7b"), device)
    params = convert.params_from_numpy(start, model.spec, device)
    steps, _, _ = three_steps(model, params, mesh, rules,
                              batch_index(mesh, rules), world, device)
    return dict(psum=psum_rank(rank, world, device), dp=steps)

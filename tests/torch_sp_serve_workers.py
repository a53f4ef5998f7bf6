"""Rank functions for the tests of the port's second wide model axis
(`tests/test_torch_sp_serve.py` on gloo ranks of the CPU): serving,
scoring and training under `sequence_parallel_rules(False)` on a mesh
whose "data" axis is 2, long_500k's layout in the reference's dry-run
(the heads, K/V heads and SSM mixers over "data"; the residual, MLP,
experts, vocabulary and KV sequence over "model"; the batch whole on
every rank), and under `fsdp_rules` over those rules (Jamba's, whose
config has `fsdp=True`).

Like `tests/torch_tp_serve_workers.py`'s, whose prefill and decode they
run, they import neither jax nor repro and return CPU tensors and
numbers.
"""
import torch

import torch_tp_serve_workers as TPSW
import torch_tp_workers as TPW
from repro_torch import convert
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.sharding import axes as ax
from repro_torch.sharding import ranks
from repro_torch.train.step import make_train_step, opt_shardings

NAMES = TPSW.NAMES
SP = ax.sequence_parallel_rules(False)
FSDP_SP = ax.fsdp_rules(SP, False)
JAMBA = "jamba-1.5-large-398b"
ARCHS = ("mamba2-2.7b", "qwen3-1.7b", JAMBA)
# the uneven-heads Mamba2 (3 heads of 32 over "data" 2) and qwen3 with 3
# K/V heads (which do not divide over "data" 2) beside the smoke configs
SERVE_ARCHS = ARCHS + (TPSW.KV3, TPSW.UNEVEN)

# name → (world, mesh shape, rules, archs): W = 4 on (1, 2, 2), both
# axes wide; W = 2 on (1, 2, 1), the heads over "data" and the residual
# whole
SERVE = {
    "sp": (4, (1, 2, 2), SP, SERVE_ARCHS),
    "sp_data_only": (2, (1, 2, 1), SP, SERVE_ARCHS),
    "fsdp_sp": (4, (1, 2, 2), FSDP_SP, (JAMBA,)),
    "fsdp_sp_data_only": (2, (1, 2, 1), FSDP_SP, (JAMBA,)),
}
# name → (world, mesh shape, rules, archs): the scoring loss and one
# train step on the global batch
TRAIN = {
    "sp": (4, (1, 2, 2), SP, ("mamba2-2.7b",)),
    "sp_data_only": (2, (1, 2, 1), SP, ("mamba2-2.7b", JAMBA)),
    "fsdp_sp": (4, (1, 2, 2), FSDP_SP, (JAMBA,)),
}


def train_arch(name, arch, device, start, step_batch):
    """`TRAIN[name]`'s layout for `arch`: its scoring loss on
    `step_batch` with the kernels' ops on (every rank holds every row)
    and one train step (accum 1) from `start`, as
    `torch_tp_workers.snapshot`s it, with the loss."""
    _, shape, rules, _ = TRAIN[name]
    mesh = make_test_mesh(shape, NAMES, device.type)
    model = build_model(TPSW.smoke(arch, flash=False), device)
    scorer = build_model(TPSW.smoke(arch), device)
    params = convert.params_from_numpy(
        start, model.spec, device,
        shardings=model.param_shardings(mesh, rules))
    batch = {"tokens": torch.as_tensor(step_batch, device=device)}
    with ax.use_rules(rules, mesh), torch.no_grad():
        loss = float(scorer.loss(params, batch)[0])
    opt = adamw.init(params, opt_shardings(model, mesh, rules))
    params, opt, met = make_train_step(
        model, adamw.AdamWConfig(**TPW.DPW.OPT), mesh=mesh, rules=rules)(
            params, opt, batch)
    return dict(loss=loss, **TPW.snapshot(params, opt, met))


def sp_world_rank(rank, world, device, start, tokens, steps, refs,
                  train_batch):
    """Every layout of `TRAIN` and `SERVE` with this world size: the train
    steps (`start`: arch → numpy params), then each serving layout's
    prefill, then its decode steps from the reference's caches `refs`
    (arch → [caches before each step]), or from what `torch.save` writes
    at the path `refs` when it is one.  Returns {(name, arch):
    `torch_tp_serve_workers.serve_decode`'s result, ("train", name,
    arch): `train_arch`'s}."""
    torch.set_num_threads(1)
    out = {}
    for name, (w, _, _, archs) in TRAIN.items():
        if w == world:
            for arch in archs:
                out["train", name, arch] = train_arch(
                    name, arch, device, start[arch], train_batch)
    states = {(name, arch): TPSW.serve_prefill(name, arch, device,
                                               start[arch], tokens, SERVE)
              for name, (w, _, _, archs) in SERVE.items() if w == world
              for arch in archs}
    if isinstance(refs, str):
        refs = TPSW.wait_for(refs)
    for (name, arch), state in states.items():
        out[name, arch] = TPSW.serve_decode(state, device, steps,
                                            refs[arch])
    ranks.traffic.clear()
    return out

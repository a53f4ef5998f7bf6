"""Rank functions for the serving-over-ranks tests of the port
(`tests/test_torch_tp_serve.py` on gloo ranks of the CPU,
`tests/test_torch_cuda.py` on gloo ranks of one card).

Like `tests/torch_tp_workers.py`'s, they import neither jax nor repro and
return CPU tensors and numbers.  The parameters start from numpy (the
port's float32 init, the same numbers `repro` takes) and reach each rank
as DTensors of its blocks; each rank serves its block of the global
batch's rows (its index on the batch axes).  Each decode step starts
from the reference's caches before it, carried to the rank's blocks
(`convert.caches_from_numpy(..., shardings=)`): a K/V element that
rounds to the other bfloat16 neighbour would otherwise move every later
step by more than the tolerance.
"""
from dataclasses import replace

import torch

import torch_tp_workers as TPW
from repro_torch import convert
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.sharding import axes as ax
from repro_torch.sharding import ranks
from repro_torch.train.step import make_train_step, opt_shardings

NAMES = TPW.NAMES
BASE = ax.base_rules(False)
# the reference dry-run's decode_32k layout (`repro/launch/dryrun.py`
# `rules_for`): the KV cache's sequence over "model", K/V heads whole
DECODE_32K = dict(BASE, seq_kv="model", kv_heads=None)
SEQ_PAR = ax.sequence_parallel_rules(False)
# the KV sequence over "model" with the K/V weights' heads there too: the
# cache's positions take the axis (`spec_for` uses it once), so each
# rank gathers the K/V heads its weights give before writing its slice
SEQ_KV = dict(BASE, seq_kv="model")
# Mamba2 with 3 SSM heads of 32: d_inner 96 divides over 2 ranks, the
# heads do not, so a rank's `in_x` block cuts a head in two
UNEVEN = "mamba2-uneven"
ARCHS = ("mamba2-2.7b", "qwen3-1.7b", "granite-moe-1b-a400m",
         "jamba-1.5-large-398b")
# the global batch's rows, the prompt, the caches' length and the decode
# steps: the prompt fills positions 0-5 and the steps write 6, 7, 8, so
# under the sequence split (8 positions a rank) they cross into rank 1's
ROWS, PROMPT, MAX_SEQ, STEPS = 4, 6, 16, 3

# name → (world, mesh shape, rules, archs)
SERVE = {
    "base": (2, (1, 1, 2), BASE, ARCHS),
    "base_dp2": (4, (1, 2, 2), BASE, ARCHS),
    "decode_32k": (2, (1, 1, 2), DECODE_32K, ("qwen3-1.7b",)),
    "decode_32k_dp2": (4, (1, 2, 2), DECODE_32K, ("qwen3-1.7b",)),
    "seq_parallel": (2, (1, 1, 2), SEQ_PAR, ("jamba-1.5-large-398b",
                                             "qwen3-1.7b")),
    "uneven_heads": (2, (1, 1, 2), BASE, (UNEVEN,)),
    "seq_kv_weights_split": (2, (1, 1, 2), SEQ_KV, ("qwen3-1.7b",)),
    "fsdp_dp2": (4, (1, 2, 2), ax.fsdp_rules(BASE, False),
                 ("qwen3-1.7b", "mamba2-2.7b")),
}
# name → (world, mesh shape): Mamba2's loss and one train step under BASE
TRAIN = {"base": (2, (1, 1, 2)), "base_dp2": (4, (1, 2, 2))}
TRAIN_ARCH = "mamba2-2.7b"


# qwen3 with 6 q heads over 3 K/V heads: the K/V heads do not divide
# over a "data" axis of 2, whose ranks' q heads [0, 3) and [3, 6) read
# the K/V heads [0, 2) and [1, 3), unevenly grouped
KV3 = "qwen3-kv3"


def smoke(arch, flash=True):
    """The smoke config (the uneven-heads Mamba2 for `UNEVEN`, qwen3 with
    3 K/V heads for `KV3`), with the kernels' ops on (their plain
    versions on the CPU) unless `flash` is off."""
    if arch == UNEVEN:
        cfg = replace(get_smoke_config("mamba2-2.7b"), d_model=48,
                      ssm_headdim=32)
    elif arch == KV3:
        cfg = replace(get_smoke_config("qwen3-1.7b"), n_heads=6,
                      n_kv_heads=3)
    else:
        cfg = get_smoke_config(arch)
    return replace(cfg, use_flash_kernel=flash)


def rows_of(mesh, rules, rows=ROWS):
    """This rank's rows [lo, hi) of a global batch of `rows`."""
    import torch_dp_workers as DPW
    n = 1
    for a in ax.batch_axes(rules):
        n *= ax.axis_sizes(mesh)[a]
    k = DPW.batch_index(mesh, rules)
    return k * rows // n, (k + 1) * rows // n


def cache_blocks(tree, path=""):
    """[(path, local block on the CPU, its (start, stop) per dimension,
    the global shape)] of a cache tree of DTensors (dicts and
    NamedTuples walked)."""
    if isinstance(tree, dict):
        return [b for k in sorted(tree)
                for b in cache_blocks(tree[k], f"{path}{k}/")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [b for name, v in zip(tree._fields, tree)
                for b in cache_blocks(v, f"{path}{name}/")]
    s = ranks.sharding_of(tree)
    shape = tuple(tree.shape)
    bounds = tuple((sl.start or 0, n if sl.stop is None else sl.stop)
                   for sl, n in zip(s.block(shape), shape))
    return [(path.rstrip("/"), tree.to_local().cpu().clone(), bounds,
             shape)]


def serve_prefill(name, arch, device, start, tokens, layouts=None):
    """`layouts[name]`'s layout (default `SERVE`) for `arch`: the prefill
    of this rank's rows of `tokens`.  Returns the state its decode steps
    go on from."""
    _, shape, rules, _ = (layouts or SERVE)[name]
    mesh = make_test_mesh(shape, NAMES, device.type)
    model = build_model(smoke(arch), device)
    params = convert.params_from_numpy(
        start, model.spec, device,
        shardings=model.param_shardings(mesh, rules))
    lo, hi = rows_of(mesh, rules)
    out = {"rows": (lo, hi), "steps": []}
    with ax.use_rules(rules, mesh), torch.no_grad():
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(tokens[lo:hi],
                                               device=device)}, MAX_SEQ)
    out["prefill"] = (logits.cpu(), cache_blocks(caches))
    return dict(out=out, model=model, params=params, mesh=mesh,
                rules=rules, caches=caches)


def serve_decode(state, device, steps, ref_caches):
    """The decode steps after `serve_prefill`'s, each from the reference's
    caches before it (`ref_caches[i]`, numpy trees) with `steps[i]`'s
    tokens.  Returns {"rows", "prefill": (logits, cache blocks), "steps":
    [(logits, cache blocks), …]}."""
    model, params, mesh, rules, caches, out = (
        state[k] for k in ("model", "params", "mesh", "rules", "caches",
                           "out"))
    lo, hi = out["rows"]
    shardings = model.cache_shardings(ROWS, MAX_SEQ, mesh, rules)
    with ax.use_rules(rules, mesh), torch.no_grad():
        for i, tok in enumerate(steps):
            carried = convert.caches_from_numpy(ref_caches[i], caches,
                                                shardings)
            logits, caches = model.decode_step(
                params, torch.as_tensor(tok[lo:hi], device=device),
                PROMPT + i, carried)
            out["steps"].append((logits.cpu(), cache_blocks(caches)))
    return out


def wait_for(path, timeout=600.0):
    """What `torch.save` wrote at `path`, once it is there (the writer
    renames a finished file into place)."""
    import os
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def train_arch(name, device, start, step_batch):
    """`TRAIN[name]`'s layout: Mamba2's loss on `step_batch` (each rank's
    on its rows, averaged over the batch ranks) and one train step
    (accum 1) from `start`, as `torch_tp_workers.snapshot`s it, with the
    loss."""
    _, shape = TRAIN[name]
    mesh = make_test_mesh(shape, NAMES, device.type)
    model = build_model(TPW.smoke(TRAIN_ARCH), device)
    params = convert.params_from_numpy(
        start, model.spec, device,
        shardings=model.param_shardings(mesh, BASE))
    lo, hi = rows_of(mesh, BASE, len(step_batch))
    batch = {"tokens": torch.as_tensor(step_batch[lo:hi], device=device)}
    with ax.use_rules(BASE, mesh), torch.no_grad():
        loss = float(ranks.batch_mean(model.loss(params, batch)[0]))
    opt = adamw.init(params, opt_shardings(model, mesh, BASE))
    params, opt, met = make_train_step(
        model, adamw.AdamWConfig(**TPW.DPW.OPT), mesh=mesh, rules=BASE)(
            params, opt, batch)
    return dict(loss=loss, **TPW.snapshot(params, opt, met))


def serve_world_rank(rank, world, device, start, tokens, steps, refs,
                     train_start, train_batch):
    """Every layout of `TRAIN` and `SERVE` with this world size: the train
    steps, then each serving layout's prefill, then its decode steps from
    the reference's caches `refs` (arch → [caches before each step]), or
    from what `torch.save` writes at the path `refs` when it is one (the
    caller computes them meanwhile).  Returns {(name, arch):
    serve_decode's result, ("train", name): train_arch's}."""
    torch.set_num_threads(1)
    out = {}
    for name, (w, _) in TRAIN.items():
        if w == world:
            out["train", name] = train_arch(name, device, train_start,
                                            train_batch)
    states = {(name, arch): serve_prefill(name, arch, device, start[arch],
                                          tokens)
              for name, (w, _, _, archs) in SERVE.items() if w == world
              for arch in archs}
    if isinstance(refs, str):
        refs = wait_for(refs)
    for (name, arch), state in states.items():
        out[name, arch] = serve_decode(state, device, steps, refs[arch])
    return out


def card_rank(rank, world, device, start, tokens, steps):
    """On the card, float32, TF32 off: qwen3 under `DECODE_32K` on
    (1, 1, W), each decode step from the one-device run's caches before
    it (`NamedSharding.place` of each leaf), beside that one-device run on
    this rank; and granite-moe under `BASE` on (1, 1, W), the gathered
    router logits that each call hands the gating op recorded, with the
    gating kernel's launches per call.  `start`: arch → numpy params."""
    import dataclasses
    from repro_torch.kernels.moe_gating import kernel as gk
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh((1, 1, world), NAMES, device.type)
    out = {}
    arch = "qwen3-1.7b"
    model = build_model(smoke(arch, flash=False), device)
    full = convert.params_from_numpy(start[arch], model.spec, device)
    toks = torch.as_tensor(tokens, device=device)
    with torch.no_grad():
        logits, caches = model.prefill(full, {"tokens": toks}, MAX_SEQ)
        one, before = [logits.cpu()], []
        for i, tok in enumerate(steps):
            before.append(_copy(caches))
            logits, caches = model.decode_step(
                full, torch.as_tensor(tok, device=device), PROMPT + i,
                caches)
            one.append(logits.cpu())
    params = convert.params_from_numpy(
        start[arch], model.spec, device,
        shardings=model.param_shardings(mesh, DECODE_32K))
    shardings = model.cache_shardings(ROWS, MAX_SEQ, mesh, DECODE_32K)
    with ax.use_rules(DECODE_32K, mesh), torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks}, MAX_SEQ)
        got = [logits.cpu()]
        for i, tok in enumerate(steps):
            carried = ax.map_axes(lambda _, s, t: s.place(t),
                                  model.cache_axes(), shardings, before[i])
            logits, caches = model.decode_step(
                params, torch.as_tensor(tok, device=device), PROMPT + i,
                carried)
            got.append(logits.cpu())
    out["decode_32k"] = dict(one=one, ranks=got)
    arch = "granite-moe-1b-a400m"
    model = build_model(smoke(arch), device)
    params = convert.params_from_numpy(
        start[arch], model.spec, device,
        shardings=model.param_shardings(mesh, BASE))
    seen, launches = [], []
    real = moe.fused_gating

    def spy(logits, k, interpret=False):
        seen.append((logits.detach().clone(), k))
        return real(logits, k, interpret=interpret)
    moe.fused_gating = spy
    try:
        with ax.use_rules(BASE, mesh), torch.no_grad():
            gk.gating_topk.launches = 0
            _, caches = model.prefill(params, {"tokens": toks}, MAX_SEQ)
            launches.append(gk.gating_topk.launches)
            for i, tok in enumerate(steps):
                gk.gating_topk.launches = 0
                _, caches = model.decode_step(
                    params, torch.as_tensor(tok, device=device),
                    PROMPT + i, caches)
                launches.append(gk.gating_topk.launches)
    finally:
        moe.fused_gating = real
    out["gating"] = dict(launches=launches, layers=model.cfg.n_layers,
                         logits=[(x.cpu(), k) for x, k in seen],
                         experts=dataclasses.asdict(model.cfg)["n_experts"])
    return out


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_copy(v) for v in tree))
    return tree.clone()

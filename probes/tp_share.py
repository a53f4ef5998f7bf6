"""What the tensor-parallel path's parameter gate reads (chip_smoke's
TP_PARAM_SHARE): after one AdamW step, each leaf's share of elements
more than 1e-2·lr from the one-process step's, for the sound step and
for planted faults in one leaf's gradient, as the sharded step hands it
to AdamW: rank 1's block negated, and rank 1's block lost (zeroed).

Qwen3's smoke config in float32 on two gloo ranks of the CPU,
`base_rules(False)` on (1, 1, 2), the one-process step on rank 0.

    python3 probes/tp_share.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

LEAF = "blocks/ffn/wi0"
FAULTS = ("none", "rank 1's block negated", "rank 1's block zeroed")


def rank_fn(rank, world, dev):
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.params import leaves
    from repro_torch.optim import adamw
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    from repro_torch.train.step import make_train_step, opt_shardings
    cfg = get_smoke_config("qwen3-1.7b")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (8, 32)), device=dev)
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    model = build_model(cfg, dev)
    paths = [p for p, _ in leaves(model.spec)]
    which = paths.index(LEAF)
    ref = None
    if rank == 0:
        full = model.init(torch.Generator().manual_seed(0), torch.float32)
        full, _, _ = make_train_step(model, opt_cfg)(
            full, adamw.init(full), {"tokens": tokens})
        ref = tree_flatten(full)[0]
    mesh = make_test_mesh((1, 1, 2), ("pod", "data", "model"), dev.type)
    rules = ax.base_rules(False)
    lines = []
    orig = adamw.update
    for fault in FAULTS:
        def planted(c, grads, state, params):
            g = tree_flatten(grads)[0][which]
            if rank == 1 and fault != "none":
                g.mul_(-1.0 if "negated" in fault else 0.0)
            return orig(c, grads, state, params)
        params = model.init(torch.Generator().manual_seed(0), torch.float32,
                            model.param_shardings(mesh, rules))
        opt = adamw.init(params, opt_shardings(model, mesh, rules))
        adamw.update = planted
        try:
            params, _, met = make_train_step(model, opt_cfg, mesh=mesh,
                                             rules=rules)(
                params, opt, {"tokens": tokens})
        finally:
            adamw.update = orig
        shares = {}
        for path, p, want in zip(paths, tree_flatten(params)[0],
                                 ref or [None] * len(paths)):
            full = ranks.gather_dtensor(p)
            if want is not None:
                gap = (full - want).abs() / float(met["lr"])
                shares[path] = float((gap > 1e-2).float().mean())
        if rank == 0:
            top = max(shares, key=shares.get)
            lines.append(f"{fault} (in {LEAF}): {shares[LEAF]:.4f} of "
                         f"{LEAF} beyond 1e-2·lr; the largest share "
                         f"{shares[top]:.4f} ({top})")
    return lines


if __name__ == "__main__":
    from repro_torch.sharding.ranks import spawn_ranks
    for line in spawn_ranks(rank_fn, 2, "gloo", "cpu")[0]:
        print(line, flush=True)

"""On the card: where granite-moe's tensor-parallel gradient parts from the
one-process gradient at full width (4 layers, the tensor-parallel path's
first batch, two gloo ranks on card 0, `base_rules(False)` on (1, 1, 2)).

For each case, rank 0 prints each leaf's gradient norm from one process
and from the two ranks, the relative norm of their difference, and, for
each MoE layer's router call in the forward, how many token rows chose a
different set of experts on the two sides and the share of choices that
capacity dropped.  The cases: float32 and bf16 at the config's capacity
factor, float32 with the first norm's scale moved by ±1e-6 relative on
the two-rank side, float32 at capacity factor E/k (no choice dropped),
and float64 (whose forward rounds the same float32 casts as float32's,
so the routes agree unless a cast lands on a rounding boundary).

    python3 probes/tp_grads.py [cuda:0]
    python3 probes/tp_grads.py cpu --smoke    # the smoke config, CPU ranks
"""
import os
import sys
from dataclasses import replace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

# (name, dtype, capacity factor or None, relative scale of norm1 on the
# two-rank side, whether the one-process side runs)
CASES = (("float32", "float32", None, 0.0, True),
         ("float32, tp norm1 x (1 + 1e-6)", "float32", None, 1e-6, False),
         ("float32, tp norm1 x (1 - 1e-6)", "float32", None, -1e-6, False),
         ("float32, capacity E/k", "float32", "E/k", 0.0, True),
         ("bfloat16", "bfloat16", None, 0.0, True),
         ("float64", "float64", None, 0.0, True))


def routes(cfg, calls, B):
    """Each forward router call's sorted expert ids [N, k] and the share
    of its choices beyond capacity (groups of min(512, N / B) tokens)."""
    import torch.nn.functional as F
    out = []
    k, E = cfg.top_k, cfg.n_experts
    ng = min(512, calls[0].shape[0] // B)
    C = max(1, int(cfg.capacity_factor * ng * k / E))
    for idx in calls[:cfg.n_layers]:
        oh = F.one_hot(idx.long(), E).reshape(-1, ng * k, E)
        pos = (oh.cumsum(1) * oh).sum(-1) - 1
        out.append((idx.sort(-1).values, float((pos >= C).float().mean())))
    return out


def grads_of(model, params, toks, rules=None, mesh=None):
    """(loss, flat gradients, forward routes) of `model.loss`; the
    gradients of sharded leaves gathered, of replicated ones summed over
    the ranks, as the train step does."""
    import torch
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.models import moe
    from repro_torch.sharding import axes as ax
    from repro_torch.sharding import ranks
    from repro_torch.train.step import _value_and_grad
    calls, orig = [], moe.router_topk

    def spy(*a, **kw):
        gate, idx, aux = orig(*a, **kw)
        calls.append(idx.detach().cpu())
        return gate, idx, aux
    moe.router_topk = spy
    try:
        if rules is None:
            loss, _, g = _value_and_grad(model, params, toks)
            flat = [x.double() for x in tree_flatten(g)[0]]
        else:
            with ax.use_rules(rules, mesh):
                loss, _, g = _value_and_grad(model, params, toks)
            sh = model.param_shardings(mesh, rules)
            flat = []
            for (_, pd), x, s in zip(_leaves(model), tree_flatten(g)[0],
                                     tree_flatten(sh)[0]):
                if any(ax.axis_sizes(mesh)[a] > 1 for e in s.spec
                       for a in ax._names(e)):
                    flat.append(ranks.gather_full(x, s, pd.shape).double())
                else:
                    flat.append(ranks.all_sum_(x.clone()).double())
    finally:
        moe.router_topk = orig
    return float(loss), flat, routes(model.cfg, calls,
                                     toks["tokens"].shape[0])


def _leaves(model):
    from repro_torch.models.params import leaves
    return leaves(model.spec)


def rank_fn(rank, world, dev, smoke):
    import torch
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.api import build_model
    from repro_torch.sharding import axes as ax
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = (get_smoke_config("granite-moe-1b-a400m") if smoke else
            replace(get_config("granite-moe-1b-a400m"), n_layers=4))
    toks = {"tokens": torch.as_tensor(TokenPipeline(PipelineConfig(
        8, 32 if smoke else 256, base.vocab))._batch_at(0), device=dev)}
    mesh = make_test_mesh((1, 1, 2), ("pod", "data", "model"), dev.type)
    rules = ax.base_rules(False)
    lines = []
    one = None
    for name, dt, cf, eps, run_one in CASES:
        dtype = getattr(torch, dt)
        cfg = base if cf is None else replace(
            base, capacity_factor=base.n_experts / base.top_k)
        model = build_model(cfg, dev)
        if run_one and rank == 0:
            full = model.init(torch.Generator(device=dev).manual_seed(0),
                              dtype)
            one = grads_of(model, full, toks)
            del full
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dtype, model.param_shardings(mesh, rules))
        with torch.no_grad():
            params["blocks"]["norm1"].to_local().mul_(1 + eps)
        tp = grads_of(model, params, toks, rules, mesh)
        del params
        if rank:
            continue
        lines.append(f"{name}: loss one {one[0]:.7f} tp {tp[0]:.7f}; "
                     "grad norm one "
                     f"{sum(float(g.norm()) ** 2 for g in one[1]) ** .5:.4f}"
                     f" tp {sum(float(g.norm()) ** 2 for g in tp[1]) ** .5:.4f}")
        for (path, _), a, b in zip(_leaves(model), one[1], tp[1]):
            lines.append(f"    {path}: one "
                         f"{float(a.norm()):.4f} tp {float(b.norm()):.4f} "
                         "|tp - one| / |one| "
                         f"{float((b - a).norm() / a.norm().clamp_min(1e-30)):.3e}")
        for layer, ((ia, da), (ib, db)) in enumerate(zip(one[2], tp[2])):
            rows = int((ia != ib).any(-1).sum())
            lines.append(f"    layer {layer}: {rows} of {ia.shape[0]} token "
                         f"rows route to another expert set; dropped "
                         f"choices one {da:.4f} tp {db:.4f}")
    return lines


if __name__ == "__main__":
    import subprocess
    from repro_torch.sharding.ranks import spawn_ranks
    args = [a for a in sys.argv[1:] if a != "--smoke"]
    device = args[0] if args else "cuda:0"
    if "--smoke" not in sys.argv:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    for line in spawn_ranks(rank_fn, 2, "gloo", device,
                            ("--smoke" in sys.argv,))[0]:
        print(line, flush=True)

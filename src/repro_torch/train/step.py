"""Training step factory (port of `repro.train.step`): loss → grads →
(optional compression) → AdamW.

Gradients come from `torch.autograd.grad` over the parameter leaves, in
`jax.tree.flatten`'s order.  `accum_steps > 1` splits the batch along
axis 0 into equal microbatches (`rows // accum_steps` rows each, as
the reference's `dynamic_slice_in_dim` takes them), sums their gradients
in float32 (the reference's zeros are float32), then divides; it returns only
`{"loss": …}` as its metrics, as the reference does.  A
`compressor(grads, opt_state) → (grads, opt_state)` runs between the
gradients and `adamw.update`.  The update is in place (`adamw`), so the
step writes into the `params` and `opt_state` it is given.

The model's kernels have no gradient: with `use_flash_kernel=True` their
ops raise under grad mode, and so does the step.

With a `mesh` (a `DeviceMesh` of ranks, `sharding.ranks`) and `rules`,
the step is what GSPMD makes of the reference's step under them, as
explicit collectives.  Data parallelism: each rank gets its
block of the global batch (the rules' "batch" axes, major first: the
`TokenPipeline` with `shard_id` = that index and `num_shards` = their
product), runs the same `grads_of` on it under `use_rules` (statistics
that couple rows, the MoE load-balance loss, are taken over the whole
batch there: `ranks.batch_mean`), and the gradients and metrics are
averaged over the batch axes ("tokens" summed).  Then the compressor,
and `adamw.update`, which is ZeRO-1 where the moments are sharded
(`adamw.init(params, opt_shardings(model, mesh, rules))`).  With
`accum_steps > 1` the i-th microbatch is, as in the reference, the i-th
contiguous slice of the global batch, each rank taking its block of it:
the global token rows are gathered first (a few kilobytes).

Tensor and expert parallelism over "model" (`base_rules`) and FSDP
(`fsdp_rules`): the parameters are DTensors of each rank's blocks
(`Model.init(..., shardings=model.param_shardings(mesh, rules))`), the
model runs on the blocks (`sharding.tp`) and the gradients stay blocks.
Each leaf's gradient is summed over the axes on which it is partial and
then divided by the batch's rank count: the batch axes that do not
shard it (those that do, FSDP's, were summed by its gather's backward);
for a leaf replicated over the tensor-parallel axis (the norms, a
router or vocabulary whose dimension does not divide, the mixers'
weights under `sequence_parallel_rules`), that axis; and for a mixer's
parameter whole on the mixers' second axis (`sequence_parallel_rules`
with "data" > 1: the qk-norms, the SSM's b and c projections, K/V or
SSM heads that do not divide), that axis, where each rank's gradient is
its heads' part (`sharding.tp`).  So a replicated leaf ends bitwise
equal on every rank.  Parameters that are
not DTensors are full and replicated, as under data parallelism alone.
The error-feedback compressor quantizes each leaf by its largest
element, which a block does not know, so it takes only full gradients.
Layouts the port does not run yet raise `NotImplementedError`
(`Model.check_layout`).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..checkpoint.checkpointer import tree_flatten
from ..models.api import Model, local_blocks
from ..models.params import leaves
from ..optim import adamw
from ..sharding import axes as ax
from ..sharding import ranks
from ..sharding.tp import MIXER_KEY


def _value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads) of `model.loss`, detached; the gradients of
    DTensor leaves are their local blocks'."""
    flat, treedef = tree_flatten(local_blocks(params))
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss, metrics = model.loss(treedef.unflatten(leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, treedef.unflatten(list(grads))


def multi_pod(mesh) -> bool:
    """Whether `mesh` is a multi-pod mesh: it has a "pod" axis, as
    `launch.mesh.make_production_mesh(multi_pod=True)` gives it."""
    return "pod" in mesh.mesh_dim_names


def opt_shardings(model: Model, mesh, rules: ax.Rules):
    """The moments' ZeRO-1 shardings: each parameter's block, its `embed`
    dimension further split over the data axes of `opt_rules` that the
    parameter's spec does not use, as far as the dimension divides.
    Where the parameter's spec uses no data axis this is `opt_rules` of
    `rules` over its logical axes; under `sequence_parallel_rules`, whose
    heads take "data", a moment stays a refinement of its parameter's
    block (`adamw.update` works inside the block)."""
    zero = ax._names(ax.opt_rules(rules, multi_pod(mesh))["embed"])
    order = list(ax.axis_sizes(mesh))

    def one(axes, s, pd):
        used = {a for e in s.spec for a in ax._names(e)}
        spec = list(s.spec) + [None] * (len(axes) - len(s.spec))
        if "embed" in axes:
            d = axes.index("embed")
            names = sorted(ax._names(spec[d]) + tuple(
                a for a in zero if a not in used), key=order.index)
            spec[d] = (tuple(names) if len(names) > 1 else
                       (names[0] if names else None))
        return ax.NamedSharding(mesh, ax.divisible_spec(
            ax.P(*spec), tuple(pd.shape), mesh))
    return ax.map_axes(one, model.param_axes(),
                       model.param_shardings(mesh, rules), model.spec)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    accum_steps: int = 1, compressor=None, mesh=None,
                    rules: ax.Rules | None = None) -> Callable:
    """Returns train_step(params, opt_state, batch) →
    (params, opt_state, metrics); data-parallel over `mesh` under
    `rules` when they are given (the module docstring)."""

    def grads_of(params, batch):
        if accum_steps <= 1:
            return _value_and_grad(model, params, batch)
        flat_p, treedef = tree_flatten(local_blocks(params))
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in flat_p]
        lsum = torch.zeros((), dtype=torch.float32, device=flat_p[0].device)
        for i in range(accum_steps):
            mb = {k: v[i * (v.shape[0] // accum_steps):
                       (i + 1) * (v.shape[0] // accum_steps)]
                  for k, v in batch.items()}
            loss, _, g = _value_and_grad(model, params, mb)
            for a, b in zip(gacc, tree_flatten(g)[0]):
                a.add_(b)
            lsum = lsum + loss
        n = adamw.f32(accum_steps, lsum)
        loss = lsum / n
        return loss, {"loss": loss}, treedef.unflatten(
            [g.div_(n) for g in gacc])

    if mesh is None:
        def train_step(params, opt_state, batch):
            loss, metrics, grads = grads_of(params, batch)
            if compressor is not None:
                grads, opt_state = compressor(grads, opt_state)
            params, opt_state, opt_metrics = adamw.update(
                opt_cfg, grads, opt_state, params)
            return params, opt_state, {**metrics, **opt_metrics}
        return train_step

    if rules is None:
        raise ValueError("a mesh without rules")
    model.check_layout(rules, mesh)
    rows = ax.NamedSharding(mesh, ax.P(ax.batch_axes(rules)))
    group, n = ranks.axis_group(mesh, ax.batch_axes(rules))
    tp_axis = ax.model_axis(rules, mesh)
    mixer_axis = ax.mixer_axis(rules, mesh)
    shardings, _ = tree_flatten(model.param_shardings(mesh, rules))
    in_mixer = [MIXER_KEY in path.split("/") for path, _ in
                leaves(model.spec)]
    sizes = ax.axis_sizes(mesh)

    def sharded(s):
        return any(sizes[a] > 1 for e in s.spec for a in ax._names(e))
    if compressor is not None and any(map(sharded, shardings)):
        raise NotImplementedError("the error-feedback compressor on "
                                  "gradient blocks")

    def partial_over(s, mixer):
        """The mesh axes over which a leaf of sharding `s` (a mixer's
        parameter if `mixer`) has a partial gradient, in mesh order."""
        spec_axes = {a for e in s.spec for a in ax._names(e)}
        want = [a for a in ax.batch_axes(rules) if a not in spec_axes]
        for a in (tp_axis, mixer_axis if mixer else None):
            if a is not None and a not in spec_axes:
                want.append(a)
        return [a for a in mesh.mesh_dim_names if a in want]
    reduce_groups = [ranks.axis_group(mesh, partial_over(s, m))
                     for s, m in zip(shardings, in_mixer)]

    def microbatch_order(batch):
        """This rank's rows of each global microbatch, in order."""
        if accum_steps <= 1 or n == 1:
            return batch
        out = {}
        for k, v in batch.items():
            b = v.shape[0]
            if b % accum_steps:
                raise ValueError(f"{b} rows per rank do not split into "
                                 f"{accum_steps} microbatches")
            full = ranks.gather_full(v, rows, (n * b,) + v.shape[1:])
            m, w = n * b // accum_steps, b // accum_steps
            k0 = rows.block((n * b,))[0].start // b
            out[k] = torch.cat([full[i * m + k0 * w: i * m + (k0 + 1) * w]
                                for i in range(accum_steps)])
        return out

    def check_params(params):
        for p, s in zip(tree_flatten(params)[0], shardings):
            got = ranks.sharding_of(p)
            if got is None and sharded(s):
                raise ValueError(
                    f"a full parameter where the rules shard it ({s.spec}): "
                    "give the blocks, Model.init(..., shardings="
                    "model.param_shardings(mesh, rules))")
            if got is not None and tuple(got.spec) != tuple(s.spec):
                raise ValueError(f"a parameter block of spec {got.spec} "
                                 f"where the rules give {s.spec}")

    def average(metrics, grads):
        flat, treedef = tree_flatten(grads)
        for g, (g_group, g_n) in zip(flat, reduce_groups):
            if g_n > 1:
                ranks.all_sum_(g, g_group)
            if n > 1:
                g.div_(torch.full((), n, dtype=g.dtype, device=g.device))
        if n == 1:
            return metrics, treedef.unflatten(flat)
        keys = sorted(metrics)
        vec = ranks.all_sum_(torch.stack([metrics[k].to(torch.float32)
                                          for k in keys]), group)
        div = torch.tensor([1.0 if k == "tokens" else float(n)
                            for k in keys], device=vec.device)
        return dict(zip(keys, vec / div)), treedef.unflatten(flat)

    def dp_train_step(params, opt_state, batch):
        check_params(params)
        with ax.use_rules(rules, mesh):
            _, metrics, grads = grads_of(params, microbatch_order(batch))
        metrics, grads = average(metrics, grads)
        if compressor is not None:
            grads, opt_state = compressor(grads, opt_state)
        params, opt_state, opt_metrics = adamw.update(
            opt_cfg, grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}

    return dp_train_step

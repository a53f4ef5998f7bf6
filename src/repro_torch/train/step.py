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
"""
from __future__ import annotations

from typing import Callable

import torch

from ..checkpoint.checkpointer import tree_flatten
from ..models.api import Model
from ..optim import adamw


def _value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads) of `model.loss`, detached."""
    flat, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss, metrics = model.loss(treedef.unflatten(leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, treedef.unflatten(list(grads))


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    accum_steps: int = 1, compressor=None) -> Callable:
    """Returns train_step(params, opt_state, batch) →
    (params, opt_state, metrics)."""

    def grads_of(params, batch):
        if accum_steps <= 1:
            return _value_and_grad(model, params, batch)
        flat_p, treedef = tree_flatten(params)
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

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        if compressor is not None:
            grads, opt_state = compressor(grads, opt_state)
        params, opt_state, opt_metrics = adamw.update(
            opt_cfg, grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step

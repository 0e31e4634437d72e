"""The single-device train step: gradient accumulation, global-norm
clipping, the optimizer update in place.

Port of the single-device path of ``quintnet_tpu/parallel/train_step.py``
and ``parallel/dp.py``'s ``accumulate_grads``: the global batch is cut
into ``grad_accum_steps`` equal micro-batches along its first dim, the
loss and gradients are averaged over them, the gradients are clipped to
a global L2 norm (``max_norm / (norm + 1e-6)``, capped at 1), and the
optimizer updates the parameters where they lie. Everything stays on
the device: the step never reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quintnet_tpu_torch.core.pytree import tree_leaves


def accumulate_grads(loss_fn: Callable, params, batch, n_micro: int,
                     generator=None):
    """``(mean loss, {path: mean grad})`` over ``n_micro`` equal slices
    of every tensor in ``batch`` (all [global_batch, ...]).
    ``generator`` (dropout) is consumed by the micro-batches in turn."""
    paths, leaves = zip(*tree_leaves(params))
    n = batch[0].shape[0]
    if n % n_micro:
        raise ValueError(f"batch of {n} rows does not split into "
                         f"{n_micro} equal micro-batches")
    size = n // n_micro
    loss_sum, grads = None, None
    for m in range(n_micro):
        mb = tuple(x[m * size:(m + 1) * size] for x in batch)
        loss = loss_fn(params, mb, generator)
        g = torch.autograd.grad(loss, leaves)
        if grads is None:
            loss_sum, grads = loss.detach(), list(g)
        else:
            loss_sum = loss_sum + loss.detach()
            for acc, gi in zip(grads, g):
                acc.add_(gi)
    if n_micro > 1:
        loss_sum = loss_sum / n_micro
        for acc in grads:
            acc.mul_(1.0 / n_micro)
    return loss_sum, dict(zip(paths, grads))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-6))``, in
    place, where ``norm`` is the L2 norm over all of them. Returns the
    norm (a device scalar)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return norm


def make_train_step(loss_fn: Callable, optimizer, *,
                    grad_accum_steps: int = 1,
                    grad_clip_norm: Optional[float] = None,
                    needs_rng: bool = False):
    """-> ``step(params, opt_state, batch, generator=None) -> (params,
    opt_state, loss)``. ``params`` and ``opt_state`` are updated in place
    and handed back (the JAX step returns new ones); ``loss`` is the
    micro-batch mean, a device scalar. ``generator`` is used only when
    ``needs_rng`` (the model has dropout)."""

    def step(params, opt_state, batch, generator=None):
        loss, grads = accumulate_grads(
            loss_fn, params, batch, grad_accum_steps,
            generator if needs_rng else None)
        if grad_clip_norm is not None:
            clip_by_global_norm(grads, grad_clip_norm)
        optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step

"""Data parallelism: shard the batch over ``dp``, average the gradients.

Port of ``quintnet_tpu/parallel/dp.py``. Gradient accumulation averages
over the micro-batches and steps once at the end (the reference's
intended semantics). :func:`make_dp_train_step` is the dp-only step with
replicated parameters; ``parallel/train_step.make_parallel_train_step``
is the general one the strategies use.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.core.mesh import Mesh
from quintnet_tpu_torch.core.pytree import tree_leaves


def accumulate_grads(loss_fn: Callable, params, batch, n_micro: int,
                     generator=None):
    """``(mean loss, {path: mean grad})`` over ``n_micro`` equal slices
    of every tensor in ``batch`` (all [batch, ...]). ``generator``
    (dropout) is consumed by the micro-batches in turn. A leaf the loss
    does not use gets a zero gradient (a pipeline stage's share of the
    embedding or the head it does not run)."""
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
        g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
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


def make_dp_train_step(mesh: Mesh, loss_fn: Callable, optimizer, *,
                       batch_axes: Sequence[str] = ("dp",),
                       grad_accum_steps: int = 1,
                       grad_clip_norm: Optional[float] = None):
    """-> ``step(params, opt_state, batch, generator=None) -> (params,
    opt_state, loss)`` for one rank: ``loss_fn(params, batch,
    generator)`` on this rank's LOCAL batch, accumulated over
    ``grad_accum_steps`` micro-batches, the gradients and the loss
    averaged over ``batch_axes`` (in place), clipped to the global norm,
    then the update in place. Parameters are replicated, so every rank
    applies the same update."""
    from quintnet_tpu_torch.parallel.train_step import clip_by_global_norm

    axes = tuple(a for a in batch_axes if a in mesh.axis_names)

    def step(params, opt_state, batch, generator=None):
        loss, grads = accumulate_grads(loss_fn, params, batch,
                                       grad_accum_steps, generator)
        if axes:
            ax = mesh.axis(axes)
            for g in grads.values():
                cc.all_reduce_(g, ax, mean=True)
            loss = cc.all_reduce_(loss.clone(), ax, mean=True)
        if grad_clip_norm is not None:
            clip_by_global_norm(grads, grad_clip_norm)
        optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step

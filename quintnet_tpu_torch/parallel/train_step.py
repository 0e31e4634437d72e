"""Train steps: the single-device step, and the step over a dp x tp x pp mesh.

Port of ``quintnet_tpu/parallel/train_step.py`` (and the single-device
path of ``parallel/dp.py``). The global batch (or, on a mesh, this
rank's local batch) is cut into ``grad_accum_steps`` equal micro-batches,
the loss and gradients are averaged over them, the gradients are
reduced over the mesh (:func:`reduce_grads`), clipped to a global L2
norm (``max_norm / (norm + 1e-6)``, capped at 1) and the optimizer
updates the parameters where they lie. Everything stays on the device:
the step never reads a value back to the host.

Gradient reduction (:func:`reduce_grads`), JAX's rule: the loss is
computed redundantly on every member of a model axis (tp), and the
collectives' backward is JAX's transpose (``core/collectives.py``), so
every gradient arrives scaled by the product of the model axes' sizes,
which is divided out; leaves replicated over a model axis hold only
their rank's partial sum and are summed over it; the pipeline axis
(pp) sums the replicated leaves' partial gradients without the
division; the data axes (dp) take the mean. The pipeline schedules are
``parallel/pp.py``, the dp-sharded optimizer state ``parallel/zero.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.core.mesh import Mesh
from quintnet_tpu_torch.core.pytree import tree_leaves
# accumulate_grads moved to parallel/dp.py, where the JAX package keeps
# it; re-exported for the callers that import it from here
from quintnet_tpu_torch.parallel.dp import accumulate_grads  # noqa: F401
from quintnet_tpu_torch.parallel.tp import spec_axes

DROPOUT_AXES = ("dp", "ep", "sp")


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-6))``, in
    place, where ``norm`` is the L2 norm over all of them. Returns the
    norm (a device scalar)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    _scale_(grads, norm, max_norm)
    return norm


def _scale_(grads, norm, max_norm: float):
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads.values():
        g.mul_(scale)


def _specs_by_path(param_specs):
    return dict(tree_leaves(param_specs))


def reduce_grads(grads, param_specs, mesh: Mesh, *,
                 data_axes: Tuple[str, ...], model_axes: Tuple[str, ...],
                 partial_axes: Tuple[str, ...] = ()):
    """The gradient-reduction rule of ``quintnet_tpu``, leaf by leaf and
    in place on ``grads`` ({path: gradient}); returns ``grads``.

    ``model_axes`` (tp): every leaf is divided by the product of their
    sizes (the redundancy the sum-transpose of each in-model all-reduce
    creates), after leaves replicated over a model axis are summed over
    it. ``partial_axes`` (pp) are summed without the division: the loss
    is not redundant there, but the replicated leaves (the embedding on
    stage 0, the head on the last stage) hold partial gradients. ``data_axes`` take the mean, except over an axis a leaf is
    sharded on, which divides by that axis's size."""
    redundancy = 1
    for a in model_axes:
        redundancy *= mesh.axis(a).size
    specs = _specs_by_path(param_specs)
    for path, g in grads.items():
        present = spec_axes(specs[path])
        psum_axes = tuple(a for a in mesh.axis_names
                          if a in (*model_axes, *partial_axes)
                          and a not in present)
        if psum_axes:
            cc.all_reduce_(g, mesh.axis(psum_axes))
        if redundancy != 1:
            g.div_(redundancy)
        mean_axes = tuple(a for a in mesh.axis_names
                          if a in data_axes and a not in present)
        if mean_axes:
            cc.all_reduce_(g, mesh.axis(mean_axes), mean=True)
        for a in data_axes:
            if a in present:
                g.div_(mesh.axis(a).size)
    return grads


def sharded_global_norm(grads, param_specs, mesh: Mesh, *,
                        model_axes: Tuple[str, ...]):
    """Global L2 norm of a sharded gradient tree, the same on every rank:
    a leaf's sum of squares is summed over the axes (of ``model_axes``)
    it is sharded on before the leaves are added up. With no sharded
    leaf it is exactly :func:`clip_by_global_norm`'s norm."""
    specs = _specs_by_path(param_specs)

    def leaf_sumsq(path, g):
        ss = g.float().square().sum()
        shard = tuple(a for a in mesh.axis_names
                      if a in spec_axes(specs[path]) and a in model_axes)
        if shard:
            ss = cc.all_reduce_(ss, mesh.axis(shard))
        return ss

    return torch.sqrt(sum(leaf_sumsq(p, g) for p, g in grads.items()))


def clip_sharded_grads(grads, param_specs, max_norm: float, mesh: Mesh, *,
                       model_axes: Tuple[str, ...]):
    """Clip in place to the global norm of the sharded tree; returns the
    norm."""
    norm = sharded_global_norm(grads, param_specs, mesh,
                               model_axes=model_axes)
    _scale_(grads, norm, max_norm)
    return norm


def _fold(seed: int, index: int) -> int:
    """``seed`` with a mesh coordinate mixed in (splitmix64's finaliser);
    coordinate 0 leaves the seed as it is."""
    if index == 0:
        return seed
    z = (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9) \
        & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def device_dropout_seed(seed: int, mesh: Optional[Mesh]) -> int:
    """The per-rank dropout seed of a step: the rank's (dp, ep, sp)
    coordinate, 0 for an axis the mesh lacks, folded into ``seed``. tp is
    never folded (tp ranks compute replicated activations, whose masks
    must agree) and an all-zero coordinate leaves ``seed`` unchanged, so
    single-device and tp-only runs draw the same masks and dp ranks draw
    distinct ones (the two properties of JAX's ``device_dropout_key``;
    its key stream itself is not reproducible in torch)."""
    for a in DROPOUT_AXES:
        idx = mesh.coords[a] if mesh is not None and a in mesh.coords else 0
        seed = _fold(seed, idx)
    return seed


def device_dropout_generator(seed: int, mesh: Optional[Mesh], device):
    """A ``torch.Generator`` on ``device`` seeded by
    :func:`device_dropout_seed`."""
    return torch.Generator(device=device).manual_seed(
        device_dropout_seed(seed, mesh))


def make_train_step(loss_fn: Callable, optimizer, *,
                    grad_accum_steps: int = 1,
                    grad_clip_norm: Optional[float] = None,
                    needs_rng: bool = False):
    """-> ``step(params, opt_state, batch, generator=None) -> (params,
    opt_state, loss)`` on one device. ``params`` and ``opt_state`` are
    updated in place and handed back (the JAX step returns new ones);
    ``loss`` is the micro-batch mean, a device scalar. ``generator`` is
    used only when ``needs_rng`` (the model has dropout)."""

    def step(params, opt_state, batch, generator=None):
        loss, grads = accumulate_grads(
            loss_fn, params, batch, grad_accum_steps,
            generator if needs_rng else None)
        if grad_clip_norm is not None:
            clip_by_global_norm(grads, grad_clip_norm)
        optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def make_parallel_train_step(mesh: Mesh, loss_fn: Optional[Callable],
                             optimizer, param_specs, *,
                             batch_axes: Sequence[str] = ("dp",),
                             model_axes: Sequence[str] = ("tp", "sp"),
                             partial_axes: Sequence[str] = ("pp",),
                             grad_accum_steps: int = 1,
                             grad_clip_norm: Optional[float] = None,
                             grad_fn: Optional[Callable] = None,
                             zero1_axis: Optional[str] = None,
                             zero_stage: int = 1,
                             needs_rng: bool = False):
    """-> ``step(params, opt_state, batch, generator=None) -> (params,
    opt_state, loss)`` for this rank of ``mesh``: ``loss_fn(params,
    batch, generator)`` sees this rank's parameter shards and its LOCAL
    batch and may run collectives itself (tp sums inside the model, the
    pipeline's shifts). Accumulate over ``grad_accum_steps`` micro-batches,
    reduce the gradients (:func:`reduce_grads`), average the loss over the
    data axes, clip to the global norm of the sharded tree, update in
    place. ``generator``: this rank's dropout generator
    (:func:`device_dropout_generator`), used when ``needs_rng``.

    ``grad_fn(params, batch, generator) -> (loss, {path: grad})``: a
    schedule that computes its own gradients (1F1B, ``parallel/pp.py``)
    in place of accumulating ``loss_fn``'s.

    ``zero1_axis`` (``"dp"``): the optimizer state is sharded over that
    axis (``parallel/zero.py``). ``zero_stage`` 1 takes each rank's chunk
    of the fully reduced gradients; 2 leaves the zero axis out of
    :func:`reduce_grads` and reduce-scatters it into the chunk instead,
    clips in chunk space, and without ``grad_fn`` and with accumulation
    accumulates in chunk space."""
    from quintnet_tpu_torch.parallel import zero

    names = mesh.axis_names
    data_axes = tuple(a for a in batch_axes if a in names)
    maxes = tuple(a for a in model_axes if a in names)
    paxes = tuple(a for a in partial_axes if a in names)
    zero2 = zero1_axis is not None and zero_stage == 2
    if zero2:
        _, zero_update, zero_update_chunk = zero.make_zero2(
            optimizer, param_specs, mesh, axis=zero1_axis,
            clip_norm=grad_clip_norm)
    elif zero1_axis is not None:
        _, zero_update = zero.make_zero1(optimizer, mesh, axis=zero1_axis)

    def mean_loss(loss):
        if data_axes:
            loss = cc.all_reduce_(loss.clone(), mesh.axis(data_axes),
                                  mean=True)
        return loss

    def step(params, opt_state, batch, generator=None):
        gen = generator if needs_rng else None
        if zero2 and grad_fn is None and grad_accum_steps > 1:
            # the full-size gradient never exists across micro-batches
            loss, g_chunk = zero.accumulate_grads_zero2(
                loss_fn, params, batch, grad_accum_steps, mesh=mesh,
                axis=zero1_axis, data_axes=data_axes, model_axes=maxes,
                partial_axes=paxes, param_specs=param_specs, generator=gen)
            zero_update_chunk(g_chunk, opt_state, params)
            return params, opt_state, mean_loss(loss)
        if grad_fn is not None:
            loss, grads = grad_fn(params, batch, gen)
        else:
            loss, grads = accumulate_grads(loss_fn, params, batch,
                                           grad_accum_steps, gen)
        # ZeRO-2: the zero axis's mean is the reduce-scatter into the chunk
        reduce_grads(grads, param_specs, mesh,
                     data_axes=(tuple(a for a in data_axes
                                      if a != zero1_axis)
                                if zero2 else data_axes),
                     model_axes=maxes, partial_axes=paxes)
        loss = mean_loss(loss)
        if grad_clip_norm is not None and not zero2:
            # pp-sharded leaves are partial over pp too: include it so
            # the global norm counts every shard once
            clip_sharded_grads(grads, param_specs, grad_clip_norm, mesh,
                               model_axes=maxes + paxes + data_axes)
        if zero1_axis is not None:
            zero_update(grads, opt_state, params)
        else:
            optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step

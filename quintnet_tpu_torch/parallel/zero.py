"""ZeRO-1/2: the optimizer state (and the gradient reduction) sharded over dp.

Port of ``quintnet_tpu/parallel/zero.py``. This rank's parameter tree
(already cut over tp and pp) is flattened to one vector in JAX's
``ravel_pytree`` order (dict keys sorted at every level:
:func:`flat_order`), padded to a multiple of dp and cut into equal
contiguous chunks; dp rank r owns chunk r. The optimizer runs on the
chunk alone, so Adam's moments cost 1/dp of the replicated footprint,
and one all-gather over dp puts the updated parameters back together.
The weight-decay mask (and ZeRO-2's clipping weights) are flattened in
the same order, so a chunk's mask element is its parameter's.

**ZeRO-1** (:func:`make_zero1`): the gradients arrive fully reduced (the
dp mean included) and the rank takes its chunk.

**ZeRO-2** (:func:`make_zero2`): the gradients arrive reduced over the
model and pipeline axes but not over dp; the dp mean is a
reduce-scatter straight into the rank's chunk, and the global-norm clip
runs on the chunk with a per-element replication weight
(:func:`grad_weights`: a LayerNorm gradient replicated over tp counts
once, not tp times). Under gradient accumulation
:func:`accumulate_grads_zero2` scatters each micro-batch, so the
accumulator is chunk-sized too.

The parameters must share one dtype (one flat vector).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.core.mesh import Mesh
from quintnet_tpu_torch.core.pytree import decay_mask, tree_leaves


def chunk_size(n_local: int, dp: int) -> int:
    """Elements of one rank's chunk: ``ceil(n_local / dp)``."""
    return -(-n_local // dp)


def flat_order(tree):
    """The leaf paths of a nested-dict tree in ``ravel_pytree``'s order
    (sorted keys at every level, which is the lexicographic order of the
    paths)."""
    return sorted(path for path, _ in tree_leaves(tree))


def flatten(leaves_by_path, order):
    """``{path: tensor}`` -> one flat vector in ``order``."""
    return torch.cat([leaves_by_path[p].reshape(-1) for p in order])


def local_chunk(flat, dp: int, rank: int, chunk: int):
    """Chunk ``rank`` of ``flat`` padded with zeros to ``chunk * dp``."""
    padded = torch.nn.functional.pad(flat, (0, chunk * dp - flat.numel()))
    return padded[rank * chunk:(rank + 1) * chunk].clone()


def _unflatten_into_(params, flat, order):
    """Copy ``flat`` back into the leaves of ``params``, in place."""
    leaves = dict(tree_leaves(params))
    off = 0
    with torch.no_grad():
        for p in order:
            leaf = leaves[p]
            leaf.copy_(flat[off:off + leaf.numel()].view_as(leaf))
            off += leaf.numel()


def decay_mask_flat(params, order):
    """The weight-decay mask (``core.pytree.decay_mask``, by leaf key),
    elementwise and flattened like the parameters, in their dtype."""
    leaves = dict(tree_leaves(params))
    mask = dict(tree_leaves(decay_mask(params)))
    return torch.cat([torch.full((leaves[p].numel(),), float(mask[p]),
                                 dtype=leaves[p].dtype,
                                 device=leaves[p].device) for p in order])


def grad_weights(params, param_specs, mesh: Mesh, *, skip_axis: str,
                 order=None):
    """Flat per-element weight ``1 / (replication over every mesh axis
    but skip_axis)``: summed over every mesh axis, ``w * g^2`` is then the
    exact global sum of squares (chunks are disjoint over
    ``skip_axis``, a sharded leaf counts once a shard, a leaf replicated
    over an axis is down-weighted by its size)."""
    from quintnet_tpu_torch.parallel.tp import spec_axes

    order = flat_order(params) if order is None else order
    leaves = dict(tree_leaves(params))
    specs = dict(tree_leaves(param_specs))
    parts = []
    for p in order:
        present = spec_axes(specs[p])
        rep = 1
        for a in mesh.axis_names:
            if a != skip_axis and a not in present:
                rep *= mesh.shape[a]
        parts.append(torch.full((leaves[p].numel(),), 1.0 / rep,
                                dtype=torch.float32,
                                device=leaves[p].device))
    return torch.cat(parts)


def scatter_grad_chunk(grads, order, ax):
    """A gradient tree ({path: grad}) not yet reduced over ``ax``,
    flattened, padded and reduce-scattered into this rank's chunk of its
    ``ax`` mean (an all-reduce would be this plus the discarded chunks:
    twice the traffic)."""
    flat = flatten(grads, order)
    chunk = chunk_size(flat.numel(), ax.size)
    padded = torch.nn.functional.pad(flat, (0, chunk * ax.size - flat.numel()))
    with torch.no_grad():
        return cc.reduce_scatter(padded, ax, scatter_dim=0) / ax.size


class _Chunking:
    """The flat layout of one rank's parameters over ``axis``: order,
    sizes, and the decay mask of this rank's chunk (built at first use)."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.order = None

    def setup(self, params):
        if self.order is None:
            ax = self.mesh.axis(self.axis)
            self.ax = ax
            self.order = flat_order(params)
            self.n = sum(v.numel() for _, v in tree_leaves(params))
            self.chunk = chunk_size(self.n, ax.size)
            self.mask = local_chunk(decay_mask_flat(params, self.order),
                                    ax.size, ax.index, self.chunk)
        return self

    def param_chunk(self, params):
        flat = flatten(dict(tree_leaves(params)), self.order).detach()
        return local_chunk(flat, self.ax.size, self.ax.index, self.chunk)

    def apply(self, optimizer, g_chunk, opt_state, params):
        """The optimizer on this rank's chunk (decay masked
        elementwise), then the updated chunks gathered over the axis back
        into ``params``, in place."""
        p_chunk = self.param_chunk(params)
        optimizer.update({(): g_chunk}, opt_state, p_chunk,
                         decay_mask={(): self.mask})
        with torch.no_grad():
            flat = cc.all_gather(p_chunk, self.ax, gather_dim=0)
        _unflatten_into_(params, flat[:self.n], self.order)


def init_chunk_state(optimizer, params, mesh: Mesh, *, axis: str = "dp"):
    """The optimizer state of this rank's chunk (moments of
    ``chunk_size(n_local, dp)`` elements)."""
    c = _Chunking(mesh, axis).setup(params)
    return optimizer.init(c.param_chunk(params))


def make_zero1(optimizer, mesh: Mesh, *, axis: str = "dp"):
    """``(init_local, update_local)``: ``init_local(params) -> state``
    (chunk-shaped), ``update_local(grads, state, params)`` updates
    ``params`` and ``state`` in place. ``grads`` ({path: grad}) must be
    fully reduced, the dp mean included."""
    c = _Chunking(mesh, axis)

    def init_local(params):
        return init_chunk_state(optimizer, params, mesh, axis=axis)

    def update_local(grads, opt_state, params):
        c.setup(params)
        g = local_chunk(flatten(grads, c.order), c.ax.size, c.ax.index,
                        c.chunk)
        c.apply(optimizer, g, opt_state, params)

    return init_local, update_local


def make_zero2(optimizer, param_specs, mesh: Mesh, *, axis: str = "dp",
               clip_norm: Optional[float] = None):
    """``(init_local, update_local, update_from_chunk)``.
    ``update_local(grads, state, params)``: ``grads`` reduced over the
    model and pipeline axes and the data axes other than ``axis``; the
    ``axis`` mean happens here, as a reduce-scatter.
    ``update_from_chunk(g_chunk, state, params)``: the same from a
    gradient already in chunk form (:func:`accumulate_grads_zero2`).
    With ``clip_norm`` the chunk is clipped to the global norm, computed
    with :func:`grad_weights` so that it equals ``clip_sharded_grads``'s
    norm of the whole tree."""
    init_local, _ = make_zero1(optimizer, mesh, axis=axis)
    c = _Chunking(mesh, axis)
    weights = {}

    def update_from_chunk(g_chunk, opt_state, params):
        c.setup(params)
        if clip_norm is not None:
            if "w" not in weights:
                weights["w"] = local_chunk(
                    grad_weights(params, param_specs, mesh, skip_axis=axis,
                                 order=c.order),
                    c.ax.size, c.ax.index, c.chunk)
            ss = (weights["w"] * g_chunk.float().square()).sum()
            ss = cc.all_reduce_(ss, mesh.axis(mesh.axis_names))
            norm = torch.sqrt(ss)
            g_chunk = g_chunk * torch.clamp(clip_norm / (norm + 1e-6),
                                            max=1.0)
        c.apply(optimizer, g_chunk, opt_state, params)

    def update_local(grads, opt_state, params):
        c.setup(params)
        update_from_chunk(scatter_grad_chunk(grads, c.order, c.ax),
                          opt_state, params)

    return init_local, update_local, update_from_chunk


def accumulate_grads_zero2(loss_fn: Callable, params, batch, n_micro: int,
                           *, mesh: Mesh, axis: str,
                           data_axes: Sequence[str],
                           model_axes: Sequence[str],
                           partial_axes: Sequence[str], param_specs,
                           generator=None):
    """Micro-batch accumulation in chunk space: each micro-batch's whole
    gradient tree exists only transiently, is reduced over the model,
    pipeline and other data axes, and is reduce-scattered into this
    rank's chunk; only the chunk accumulates. Every reduction then runs
    once a micro-batch (the trade ZeRO-2 makes for memory). Returns
    ``(mean loss, mean gradient chunk)``, normalised as
    ``parallel/dp.accumulate_grads``."""
    from quintnet_tpu_torch.parallel.dp import accumulate_grads
    from quintnet_tpu_torch.parallel.train_step import reduce_grads

    other_data = tuple(a for a in data_axes if a != axis)
    ax = mesh.axis(axis)
    order = flat_order(params)
    n = batch[0].shape[0]
    if n % n_micro:
        raise ValueError(f"batch of {n} rows does not split into "
                         f"{n_micro} equal micro-batches")
    size = n // n_micro
    loss_sum, acc = None, None
    for m in range(n_micro):
        mb = tuple(x[m * size:(m + 1) * size] for x in batch)
        loss, grads = accumulate_grads(loss_fn, params, mb, 1, generator)
        reduce_grads(grads, param_specs, mesh, data_axes=other_data,
                     model_axes=tuple(model_axes),
                     partial_axes=tuple(partial_axes))
        c = scatter_grad_chunk(grads, order, ax)
        del grads
        if acc is None:
            loss_sum, acc = loss, c
        else:
            loss_sum, acc = loss_sum + loss, acc.add_(c)
    return loss_sum / n_micro, acc.mul_(1.0 / n_micro)

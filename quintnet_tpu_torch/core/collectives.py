"""Named-axis collectives over ``torch.distributed``, differentiable.

Port of ``quintnet_tpu/core/collectives.py``. Each collective takes the
axis it runs over as a :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`
(``mesh.axis("tp")``), or as a name (or tuple of names, in mesh order)
together with ``mesh=``. Over an axis of size 1 every collective is the
identity.

The backward rules are JAX's transposes under ``shard_map(...,
check_vma=False)``, not the reference's Megatron rules, so that
``parallel/train_step.reduce_grads`` ports line for line:

- ``all_reduce`` (psum)      -> ``all_reduce`` of the cotangent (the
  per-rank gradient is the SUM of the cotangents over the axis, which
  ``reduce_grads`` divides back out for model axes);
- ``all_gather``             -> ``reduce_scatter``;
- ``reduce_scatter``         -> ``all_gather``;
- ``all_to_all``             -> the reverse ``all_to_all``;
- ``ppermute`` (a shift is one) -> the inverse permutation (the
  opposite shift), zeros where nothing is sent;
- ``all_reduce_max`` (pmax) has none, as JAX's pmax has no JVP rule:
  its callers take it of a detached value (a stabiliser).

Every call runs inside a ``torch.profiler.record_function`` range named
``collective:<name>`` (:func:`communicate`), which is also where the
collective census counts (:func:`count_collectives`: per mesh axis
name, JAX's op names ``all_reduce``, ``all_gather``,
``reduce_scatter``, ``all_to_all`` and ``ppermute``). A backend that
cannot run a collective on the tensors' device raises; nothing is
staged elsewhere (gloo stages CUDA tensors through host memory inside
its own collectives, for a shift as for an all-reduce).

A permutation's implementation (``ppermute``, and the shift that the
pipelines and the ring run) is chosen by the axis group's backend, not
by trying one and catching its failure: NCCL, and gloo on CPU tensors,
run point-to-point (``dist.batch_isend_irecv``); gloo on CUDA tensors
would be handed a device pointer for point-to-point, so there it is one
``dist.all_to_all_single`` over the axis whose split sizes are zero
except toward the destination (:func:`_permute_all_to_all`).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from quintnet_tpu_torch.core.mesh import AxisNames, Mesh, MeshAxis
from quintnet_tpu_torch.core.pytree import tree_map


def resolve_axis(axis, mesh: Optional[Mesh] = None) -> MeshAxis:
    """A :class:`MeshAxis` as it is, or axis name(s) looked up in
    ``mesh``."""
    if isinstance(axis, MeshAxis):
        return axis
    if mesh is None:
        raise ValueError(f"axis {axis!r} given by name needs mesh=")
    return mesh.axis(axis)


CensusCounts = Dict[str, Dict[str, int]]

# {axis: {op: n}} while a census is open (count_collectives)
_census: Optional[CensusCounts] = None

# the census op of each communicate() name (JAX's: pmax is an all_reduce)
_CENSUS_OP = {"all_reduce_max": "all_reduce"}


@contextmanager
def count_collectives():
    """Count every collective this process starts while the block is
    open, backward ones included (the transposes, as JAX's census counts
    them; a CUDA backward runs on the autograd engine's device thread and
    counts all the same), into the dict the block receives: ``{axis:
    {op: n}}``, one count per axis name of a multi-axis collective. A
    rank is one process: its census is the process's. Off (the default)
    :func:`communicate` pays one branch."""
    global _census
    prev, _census = _census, {}
    counts = _census
    try:
        yield counts
    finally:
        _census = prev


def communicate(name: str, ax: MeshAxis, fn, *args, **kwargs):
    """Run one ``torch.distributed`` call over ``ax`` inside the profiler
    range ``collective:<name>``; every collective of the port goes
    through here, and the census counts it here."""
    counts = _census
    if counts is not None:
        op = _CENSUS_OP.get(name, name)
        for axis in ax.names:
            per = counts.setdefault(axis, {})
            per[op] = per.get(op, 0) + 1
    with record_function(f"collective:{name}"):
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------
# the raw operations (no autograd), on contiguous tensors
# ---------------------------------------------------------------------

def _psum(x, ax: MeshAxis):
    out = x.contiguous().clone()
    communicate("all_reduce", ax, dist.all_reduce, out, group=ax.group)
    return out


def _gather_stacked(x, ax: MeshAxis):
    """[n, *x.shape]: member i's x at row i."""
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty((ax.size * flat.numel(),))
    communicate("all_gather", ax, dist.all_gather_into_tensor, out, flat,
                group=ax.group)
    return out.reshape((ax.size,) + tuple(x.shape))


def _gather(x, ax: MeshAxis, dim: int):
    return torch.cat(_gather_stacked(x, ax).unbind(0), dim=dim)


def _psum_scatter(x, ax: MeshAxis, dim: int):
    n = ax.size
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size "
                         f"{x.shape[dim]} does not split over {n} members")
    stacked = torch.stack(x.chunk(n, dim=dim))
    out = stacked.new_empty((stacked[0].numel(),))
    communicate("reduce_scatter", ax, dist.reduce_scatter_tensor, out,
                stacked.reshape(-1), group=ax.group)
    return out.reshape(stacked.shape[1:])


def _all_to_all(x, ax: MeshAxis, split_dim: int, concat_dim: int):
    n = ax.size
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over {n} "
                         f"members")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    communicate("all_to_all", ax, dist.all_to_all_single, recv, send,
                group=ax.group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _neighbours(ax: MeshAxis, shift: int, wrap: bool):
    """(member this one sends to, member it receives from) along ``ax``;
    None where there is none (the edges without ``wrap``)."""
    n, i = ax.size, ax.index
    dst, src = i + shift, i - shift
    if wrap:
        dst, src = dst % n, src % n
    return (dst if 0 <= dst < n else None), (src if 0 <= src < n else None)


def _endpoints(ax: MeshAxis, perm):
    """(member this one sends to, member it receives from) under ``perm``
    (JAX's ``lax.ppermute`` pairs ``(source, destination)``); None where
    the permutation names none."""
    i = ax.index
    dsts = [d for s, d in perm if s == i]
    srcs = [s for s, d in perm if d == i]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"ppermute: {perm} sends or receives twice at "
                         f"member {i}")
    for s, d in perm:
        if not (0 <= s < ax.size and 0 <= d < ax.size):
            raise ValueError(f"ppermute: {perm} names a member outside "
                             f"0..{ax.size - 1}")
    return (dsts[0] if dsts else None), (srcs[0] if srcs else None)


def _permute(x, ax: MeshAxis, dst, src):
    """This member's x goes to member ``dst`` and it receives member
    ``src``'s (either None: nothing sent, zeros received)."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(ax.group) == "gloo":
        return _permute_all_to_all(x, ax, dst, src)
    return _permute_p2p(x, ax, dst, src)


def _permute_p2p(x, ax: MeshAxis, dst, src):
    if dst == ax.index:          # a fixed point: kept, nothing on the wire
        return x.clone()
    out = torch.zeros_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x, ax.ranks[dst], group=ax.group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, ax.ranks[src],
                              group=ax.group))
    if ops:
        for req in communicate("ppermute", ax, dist.batch_isend_irecv,
                               ops):
            req.wait()
    return out


def _permute_all_to_all(x, ax: MeshAxis, dst, src):
    """The permutation as one all-to-all over the whole axis: this
    member's flat x is the split toward its destination, every other
    split is empty, and the one non-empty split that arrives comes from
    its source. Every member of the axis takes part, senders or not."""
    n = x.numel()
    send_sizes = [n if j == dst else 0 for j in range(ax.size)]
    recv_sizes = [n if j == src else 0 for j in range(ax.size)]
    recv = x.new_empty((n if src is not None else 0,))
    communicate("ppermute", ax, dist.all_to_all_single, recv,
                x.reshape(-1) if dst is not None else x.new_empty((0,)),
                output_split_sizes=recv_sizes, input_split_sizes=send_sizes,
                group=ax.group)
    if src is None:
        return torch.zeros_like(x)
    return recv.reshape(x.shape)


# ---------------------------------------------------------------------
# autograd Functions: forward and JAX's transpose
# ---------------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _psum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.ax), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.ax, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _psum_scatter(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.ax, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim):
        ctx.ax, ctx.dims = ax, (split_dim, concat_dim)
        return _all_to_all(x, ax, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.ax, concat_dim, split_dim), None, None, None


class _Permute(torch.autograd.Function):
    """A permutation (a shift is one); its backward is the inverse
    permutation: the cotangent goes back from destination to source."""

    @staticmethod
    def forward(ctx, x, ax, dst, src):
        ctx.ax, ctx.ends = ax, (dst, src)
        return _permute(x, ax, dst, src)

    @staticmethod
    def backward(ctx, g):
        dst, src = ctx.ends
        return _permute(g, ctx.ax, src, dst), None, None, None


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, *others):
        ctx.n = len(others)
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * ctx.n


def tie(a, *others):
    """``a`` as it is, with ``others`` made inputs of it in the autograd
    graph: they get no gradient, but every backward that reaches ``a``
    also reaches (with zeros) whatever they depend on. A collective's
    backward is a collective that every member of its axis must enter:
    a result that one rank does not use (a masked ring chunk, a pipeline
    tick with nothing to compute) is tied in so that its collective's
    backward still runs there."""
    return _Tie.apply(a, *others)


# ---------------------------------------------------------------------
# the public collectives (JAX names)
# ---------------------------------------------------------------------

def all_reduce(x, axis: AxisNames, mesh: Optional[Mesh] = None):
    """Sum over the members of ``axis`` (psum)."""
    ax = resolve_axis(axis, mesh)
    return x if ax.size == 1 else _AllReduce.apply(x, ax)


def all_reduce_max(x, axis: AxisNames, mesh: Optional[Mesh] = None):
    """Elementwise max over the members of ``axis`` (pmax). It has no
    gradient, as JAX's pmax has no JVP rule: ``x`` must not require one
    (the callers detach it first, as JAX puts ``stop_gradient`` before
    the pmax)."""
    ax = resolve_axis(axis, mesh)
    if x.requires_grad:
        raise ValueError("all_reduce_max has no gradient: detach x first")
    if ax.size == 1:
        return x
    out = x.contiguous().clone()
    communicate("all_reduce_max", ax, dist.all_reduce, out,
                op=dist.ReduceOp.MAX, group=ax.group)
    return out


def all_reduce_mean(x, axis: AxisNames, mesh: Optional[Mesh] = None):
    """Mean over the members of ``axis`` (pmean: the sum, then / size)."""
    ax = resolve_axis(axis, mesh)
    return x if ax.size == 1 else _AllReduce.apply(x, ax) / ax.size


def all_gather(x, axis: AxisNames, mesh: Optional[Mesh] = None, *,
               gather_dim: int = -1, tiled: bool = True):
    """Gather every member's ``x``: ``tiled`` concatenates along
    ``gather_dim`` in axis order; otherwise the copies are stacked on a
    new dim at ``gather_dim`` of the result (JAX's ``lax.all_gather``
    with ``tiled=False``: the default -1 stacks on a new last dim)."""
    ax = resolve_axis(axis, mesh)
    if not tiled:
        gather_dim %= x.ndim + 1
        x = x.unsqueeze(gather_dim)
    if ax.size == 1:
        return x
    return _AllGather.apply(x, ax, gather_dim % x.ndim)


def reduce_scatter(x, axis: AxisNames, mesh: Optional[Mesh] = None, *,
                   scatter_dim: int = -1):
    """Sum over the members, then member i keeps chunk i of
    ``scatter_dim`` (psum_scatter, tiled)."""
    ax = resolve_axis(axis, mesh)
    if ax.size == 1:
        return x
    return _ReduceScatter.apply(x, ax, scatter_dim % x.ndim)


def all_to_all(x, axis: AxisNames, mesh: Optional[Mesh] = None, *,
               split_dim: int, concat_dim: int):
    """Split ``split_dim`` into one chunk per member, send chunk j to
    member j, concatenate what arrives along ``concat_dim`` in source
    order."""
    ax = resolve_axis(axis, mesh)
    if ax.size == 1:
        return x
    return _AllToAll.apply(x, ax, split_dim % x.ndim, concat_dim % x.ndim)


def axis_index(axis: AxisNames, mesh: Optional[Mesh] = None) -> int:
    """This rank's coordinate along ``axis``."""
    return resolve_axis(axis, mesh).index


def axis_size(axis: AxisNames, mesh: Optional[Mesh] = None) -> int:
    return resolve_axis(axis, mesh).size


def ppermute_shift(x, axis: AxisNames, mesh: Optional[Mesh] = None, *,
                   shift: int = 1, wrap: bool = True):
    """Member i sends to member i + shift (modulo the size with
    ``wrap``; without it the members nobody sends to get zeros)."""
    ax = resolve_axis(axis, mesh)
    if ax.size == 1:
        return x if wrap or shift == 0 else torch.zeros_like(x)
    return _Permute.apply(x, ax, *_neighbours(ax, int(shift), bool(wrap)))


def ppermute(x, axis: AxisNames, perm, mesh: Optional[Mesh] = None):
    """JAX's ``lax.ppermute``: ``perm`` is a list of ``(source,
    destination)`` members of ``axis``; member ``source``'s x arrives at
    ``destination``, and a member nobody sends to receives zeros. The
    backward is the inverse permutation. A permutation of fixed points
    only (zigzag's even chunks at sp = 2) puts nothing on the wire: every
    member sees the same ``perm``, so all of them skip it together."""
    ax = resolve_axis(axis, mesh)
    dst, src = _endpoints(ax, perm)
    if ax.size == 1 or all(s == d for s, d in perm):
        return x if src is not None else torch.zeros_like(x)
    return _Permute.apply(x, ax, dst, src)


def send_forward(x, axis: AxisNames = "pp", mesh: Optional[Mesh] = None):
    """Stage i -> stage i + 1; the first stage receives zeros."""
    return ppermute_shift(x, axis, mesh, shift=1, wrap=False)


def send_backward(x, axis: AxisNames = "pp", mesh: Optional[Mesh] = None):
    """Stage i -> stage i - 1; the last stage receives zeros."""
    return ppermute_shift(x, axis, mesh, shift=-1, wrap=False)


def broadcast_from(x, axis: AxisNames, mesh: Optional[Mesh] = None, *,
                   src: int = 0):
    """Every member gets member ``src``'s value: a masked sum, with
    ``where`` rather than a multiply so that NaN or Inf on the other
    members cannot reach the sum."""
    ax = resolve_axis(axis, mesh)
    masked = torch.where(torch.tensor(ax.index == src, device=x.device), x,
                         torch.zeros_like(x))
    return all_reduce(masked, ax)


def all_reduce_(x, axis: AxisNames, mesh: Optional[Mesh] = None, *,
                mean: bool = False):
    """In place and outside autograd (gradient buffers): ``x`` becomes
    the sum over ``axis`` (or, with ``mean``, the sum / size, exactly as
    :func:`all_reduce_mean` computes it). Returns ``x``."""
    ax = resolve_axis(axis, mesh)
    if ax.size == 1:
        return x
    if not x.is_contiguous():
        raise ValueError("all_reduce_ needs a contiguous tensor")
    with torch.no_grad():
        communicate("all_reduce", ax, dist.all_reduce, x, group=ax.group)
        if mean:
            x.div_(ax.size)
    return x


def tree_all_reduce(tree, axis: AxisNames, mesh: Optional[Mesh] = None):
    ax = resolve_axis(axis, mesh)
    return tree_map(lambda g: all_reduce(g, ax), tree)


def tree_all_reduce_mean(tree, axis: AxisNames,
                         mesh: Optional[Mesh] = None):
    ax = resolve_axis(axis, mesh)
    return tree_map(lambda g: all_reduce_mean(g, ax), tree)

"""Tensor parallelism: Megatron-style 1D sharding as functions and specs.

Port of ``quintnet_tpu/parallel/tp.py``. The layer functions run on
this rank's shard of each weight; ``axis`` is the tp
:class:`~quintnet_tpu_torch.core.mesh.MeshAxis` (None: no tp). A spec is
the port's counterpart of a ``PartitionSpec``: a tuple with one entry
per dim, each an axis name, a tuple of names, or None (replicated); ``()``
is a fully replicated leaf.

Fused-QKV layout: the global [D, 3D] QKV weight is stored tp-blocked,
its columns ordered [q_0|k_0|v_0|q_1|k_1|v_1|...] per tp shard, so a
contiguous column slice gives each rank whole heads of q, k and v
(:func:`qkv_blocked_from_standard`). The ZeRO-3/FSDP spec transforms
(:func:`fsdp_shard_specs`, :func:`fsdp_gather_dims`, :func:`fsdp_info`)
give the dp-sharded storage layout of the stacked blocks and the dim
each layer is all-gathered along before use.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quintnet_tpu_torch.core import collectives as cc


def column_parallel_linear(p, x, *, axis=None, gather_output: bool = False):
    """y = x @ W_col (+ b_col) with W column-sharded [in, out/tp];
    ``gather_output`` all-gathers the feature dim."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    if gather_output and axis is not None:
        y = cc.all_gather(y, axis, gather_dim=-1)
    return y


def row_parallel_linear(p, x, *, axis=None, input_is_parallel: bool = True):
    """y = sum_tp(x_shard @ W_row) + b with W row-sharded [in/tp, out]; the
    bias is added once, after the sum. ``input_is_parallel=False``: the
    (replicated) input is cut to this rank's rows first."""
    if axis is not None and not input_is_parallel:
        shard = p["w"].shape[0]
        x = x.narrow(-1, cc.axis_index(axis) * shard, shard)
    y = x @ p["w"]
    if axis is not None:
        y = cc.all_reduce(y, axis)
    if "b" in p:
        y = y + p["b"]
    return y


def vocab_parallel_embedding(p, ids, *, axis=None):
    """Embedding lookup with the vocabulary sharded over ``axis``: ids
    outside this rank's rows contribute zeros, and one sum assembles the
    full embedding."""
    table = p["table"]
    if axis is None:
        return table[ids]
    per_shard = table.shape[0]
    local = ids - cc.axis_index(axis) * per_shard
    in_shard = (local >= 0) & (local < per_shard)
    out = table[local.clamp(0, per_shard - 1)]
    out = torch.where(in_shard[..., None], out, torch.zeros_like(out))
    return cc.all_reduce(out, axis)


def vocab_parallel_logits(p, x, *, axis=None):
    """lm head with a vocab-sharded weight [D, V/tp]: the full logits by
    an all-gather over the vocab dim."""
    y = x @ (p["w"] if isinstance(p, dict) else p)
    if axis is not None:
        y = cc.all_gather(y, axis, gather_dim=-1)
    return y


# ---------------------------------------------------------------------
# fused-QKV layout (pure reshapes: numpy arrays or tensors)
# ---------------------------------------------------------------------

def _moveaxis(x, src: int, dst: int):
    if isinstance(x, np.ndarray):
        return np.moveaxis(x, src, dst)
    return torch.movedim(x, src, dst)


def qkv_blocked_from_standard(w, num_heads: int, tp: int):
    """Permute the last axis of a fused-QKV weight [.., 3D] (or bias
    [3D]) from standard [q|k|v] to the tp-blocked layout; tp = 1 is the
    identity."""
    d3 = w.shape[-1]
    d = d3 // 3
    if num_heads % tp or d % num_heads:
        raise ValueError(f"{num_heads} heads of width {d} do not split "
                         f"over tp={tp}")
    hpr, dh = num_heads // tp, d // num_heads
    x = w.reshape(tuple(w.shape[:-1]) + (3, tp, hpr * dh))
    x = _moveaxis(x, -2, -3)
    return x.reshape(tuple(w.shape[:-1]) + (d3,))


def qkv_standard_from_blocked(w, num_heads: int, tp: int):
    """Inverse of :func:`qkv_blocked_from_standard`."""
    d3 = w.shape[-1]
    d = d3 // 3
    hpr, dh = num_heads // tp, d // num_heads
    x = w.reshape(tuple(w.shape[:-1]) + (tp, 3, hpr * dh))
    x = _moveaxis(x, -3, -2)
    return x.reshape(tuple(w.shape[:-1]) + (d3,))


def tree_qkv_layout(params, num_heads: int, tp: int, *,
                    to_blocked: bool = True):
    """A pre-LN model's param tree with its stacked fused-QKV weight and
    bias (``blocks.attn.qkv``) moved to the tp-blocked layout (or back,
    ``to_blocked=False``); a new tree sharing every other leaf. Identity
    at tp = 1."""
    if tp == 1:
        return params
    fn = qkv_blocked_from_standard if to_blocked else \
        qkv_standard_from_blocked
    out = {k: dict(v) if isinstance(v, dict) else v
           for k, v in params.items()}
    attn = out["blocks"]["attn"] = dict(out["blocks"]["attn"])
    qkv = attn["qkv"] = dict(attn["qkv"])
    for k in ("w", "b"):
        if k in qkv:
            qkv[k] = fn(qkv[k], num_heads, tp)
    return out


# ---------------------------------------------------------------------
# spec helpers. ``stacked`` prepends the depth dim of stacked block
# trees; ``pp_axis`` shards it over the pipeline stages.
# ---------------------------------------------------------------------

def _lead(tail, stacked: bool, pp_axis: Optional[str]):
    return (pp_axis, *tail) if stacked else tuple(tail)


def column_spec(*, tp_axis="tp", stacked=False, pp_axis=None):
    """Specs for a column-parallel linear {w: [in, out], b: [out]}."""
    return {"w": _lead((None, tp_axis), stacked, pp_axis),
            "b": _lead((tp_axis,), stacked, pp_axis)}


def row_spec(*, tp_axis="tp", stacked=False, pp_axis=None):
    """Specs for a row-parallel linear; the bias is replicated (added
    once after the sum)."""
    return {"w": _lead((tp_axis, None), stacked, pp_axis),
            "b": _lead((None,), stacked, pp_axis)}


def replicated_spec(*, stacked=False, pp_axis=None):
    return _lead((), stacked, pp_axis) if stacked else ()


def layer_norm_spec(*, stacked=False, pp_axis=None):
    lead = _lead((None,), stacked, pp_axis)
    return {"scale": lead, "bias": lead}


def block_specs(*, tp_axis="tp", stacked=True, pp_axis=None):
    """Specs for one (stacked) pre-LN block: attention qkv column-sharded,
    proj row-sharded, MLP fc column / proj row, LayerNorms replicated."""
    kw = dict(stacked=stacked, pp_axis=pp_axis)
    return {
        "ln1": layer_norm_spec(**kw),
        "attn": {"qkv": column_spec(tp_axis=tp_axis, **kw),
                 "proj": row_spec(tp_axis=tp_axis, **kw)},
        "ln2": layer_norm_spec(**kw),
        "mlp": {"fc": column_spec(tp_axis=tp_axis, **kw),
                "proj": row_spec(tp_axis=tp_axis, **kw)},
    }


# ---------------------------------------------------------------------
# ZeRO-3 / FSDP spec transforms
# ---------------------------------------------------------------------

def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def fsdp_shard_specs(specs_tree, axis: str):
    """Insert ``axis`` into the first free (None) dim >= 1 of every
    stacked leaf's spec: the ZeRO-3/FSDP storage layout, in which each
    block leaf keeps 1/axis_size of one dimension resident and the layer
    loop all-gathers the layer just before use
    (``nn/transformer.stacked_blocks_apply(fsdp=)``). A leaf with no free
    dim (a tp-sharded bias vector) stays replicated: correct, just not
    sharded."""

    def one(spec):
        parts = list(spec)
        for i in range(1, len(parts)):
            if parts[i] is None:
                parts[i] = axis
                return tuple(parts)
        return spec

    return _map_specs(one, specs_tree)


def fsdp_gather_dims(specs_tree, axis: str):
    """Per leaf, the dim to gather in the PER-LAYER view (the stacked dim
    0 removed): the index of ``axis`` in the spec minus 1, or -1 when the
    leaf is not fsdp-sharded (no gather)."""

    def one(spec):
        for i, part in enumerate(spec):
            if part == axis or (isinstance(part, (tuple, list))
                                and axis in part):
                return i - 1
        return -1

    return _map_specs(one, specs_tree)


def fsdp_info(partition_specs_fn, fsdp_axis, **spec_kw):
    """``(fsdp_axis, per-leaf gather dims)`` for ``stacked_blocks_apply``,
    or None without ``fsdp_axis`` (an axis name, or this rank's
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`, handed back as it
    is). One derivation for every model family: the blocks' specs are
    rebuilt through the SAME spec builder that lays the storage out
    (``pp_axis=None``: fsdp under pp is refused by the strategy), so the
    gather dims cannot drift from the sharding."""
    if fsdp_axis is None:
        return None
    name = axis_name(fsdp_axis)
    bspecs = partition_specs_fn(pp_axis=None, fsdp_axis=name,
                                **spec_kw)["blocks"]
    return fsdp_axis, fsdp_gather_dims(bspecs, name)


def axis_name(axis) -> Optional[str]:
    """The name of an axis given as a name or as this rank's
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis` (None stays None)."""
    if axis is None or isinstance(axis, str):
        return axis
    return axis.names[0]


def spec_axes(spec) -> set:
    """Mesh axis names appearing in a spec."""
    axes = set()
    for part in spec:
        if part is None:
            continue
        if isinstance(part, (tuple, list)):
            axes.update(part)
        else:
            axes.add(part)
    return axes


def block_index(part, sizes, coords):
    """``(index, count)`` of the block that the rank at ``coords`` (axis
    name -> coordinate) holds along one spec entry (an axis name or a
    tuple of names, row-major over them), on a mesh of ``sizes`` (axis
    name -> size): where a shard lives in its whole leaf, for
    :func:`shard_leaf` and the sharded checkpoints alike."""
    idx, count = 0, 1
    for a in ((part,) if isinstance(part, str) else part):
        idx, count = idx * sizes[a] + coords[a], count * sizes[a]
    return idx, count


def shard_leaf(x, spec, mesh):
    """This rank's block of a full (host-global) leaf under ``spec``:
    each dim that names axes of size > 1 is cut to this rank's chunk
    along them (a copy, so the full leaf can be freed)."""
    out = x
    for dim, part in enumerate(spec):
        if part is None:
            continue
        ax = mesh.axis(part)     # names the mesh's axes, in its order
        idx, count = block_index(part, mesh.shape, mesh.coords)
        if count == 1:
            continue
        if out.shape[dim] % count:
            raise ValueError(f"dim {dim} of size {out.shape[dim]} does not "
                             f"split over {ax!r}")
        size = out.shape[dim] // count
        out = out.narrow(dim, idx * size, size)
    return out if out is x else out.contiguous().clone()


def gather_leaf(x, spec, mesh):
    """Inverse of :func:`shard_leaf` over the collective: the full leaf
    from every rank's block (every rank gets it)."""
    out = x
    for dim, part in reversed(list(enumerate(spec))):
        if part is None or mesh.axis(part).size == 1:
            continue
        out = cc.all_gather(out.contiguous(), mesh.axis(part),
                            gather_dim=dim)
    return out

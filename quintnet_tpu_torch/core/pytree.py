"""Parameter-tree helpers: leaves, map, the weight-decay mask, and the
tree arithmetic of the JAX package (counting, stacking, casting, the
global norm).

Port of ``quintnet_tpu/core/pytree.py``. Parameter trees are nested
dicts of tensors (the JAX pytree layout).
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch

# Dict keys naming weight matrices and embedding tables: the leaves that
# AdamW weight decay applies to. Everything else (biases, LayerNorm
# scales and shifts) is skipped. Name-based on purpose: a test on ndim
# would decay a stacked bias, which is [L, out].
DECAY_KEYS = frozenset({
    "w", "w1", "w2",                # linear / MoE expert matrices
    "wg", "wu", "wd",               # SwiGLU MoE expert matrices
    "wte", "wpe", "tok", "table",   # embedding tables
})


def tree_leaves(tree, prefix=()):
    """``(path, leaf)`` for every leaf of a nested-dict tree, in
    insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more trees of the same layout."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def decay_mask(params):
    """A tree of bools, one per leaf: True where the leaf's own dict key
    is in :data:`DECAY_KEYS` (the JAX package's mask holds the same
    value broadcast to the leaf's shape)."""
    def mask(tree, key):
        if isinstance(tree, dict):
            return {k: mask(v, k) for k, v in tree.items()}
        return key in DECAY_KEYS

    return mask(params, "")


def tree_count_params(tree) -> int:
    return sum(x.numel() for _, x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in tree_leaves(tree))


def tree_stack(trees: Sequence[Any]):
    """Stack trees of one layout along a new leading axis (per-layer
    blocks -> the stacked ``[L, ...]`` blocks the models hold)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree, n: int) -> List[Any]:
    """Inverse of :func:`tree_stack`."""
    return [tree_map(lambda x: x[i], tree) for i in range(n)]


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree, dtype):
    """Floating leaves to ``dtype``; integer leaves unchanged."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every leaf, in f32 (a 0-d tensor)."""
    sums = [x.float().square().sum() for _, x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled by min(1, max_norm / (norm + 1e-6)), norm)``: a new
    tree (the train step's in-place clip is
    ``parallel/train_step.clip_by_global_norm``)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda x: x * scale, tree), norm

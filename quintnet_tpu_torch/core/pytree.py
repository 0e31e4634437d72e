"""Parameter-tree helpers: leaves, map, and the weight-decay mask.

Port of the part of ``quintnet_tpu/core/pytree.py`` that training uses.
Parameter trees are nested dicts of tensors (the JAX pytree layout).
"""

from __future__ import annotations

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

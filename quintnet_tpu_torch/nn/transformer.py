"""Pre-LN transformer block (GPT-2): dense, paged-decode and paged-prefill.

Port of ``quintnet_tpu/nn/transformer.py`` for one device, dense MLP
only. Block parameters arrive as ONE layer's slice of the stacked
``[L, ...]`` tree (:func:`layer_params`); a Python loop over layers
stands in for ``lax.scan``.
"""

from __future__ import annotations

from typing import Callable

from quintnet_tpu_torch.nn.attention import (mha_apply, mha_decode,
                                             mha_prefill_paged)
from quintnet_tpu_torch.nn.layers import gelu, layer_norm_apply, mlp_apply


def layer_params(tree, layer: int):
    """Layer ``layer``'s view of a stacked ``[L, ...]`` param tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, layer) for k, v in tree.items()}
    return tree[layer]


def _block_mlp(p, x, *, act):
    return x + mlp_apply(p["mlp"], layer_norm_apply(p["ln2"], x), act=act)


def block_apply(p, x, *, num_heads: int, causal: bool = False,
                act: Callable = gelu):
    """Eval-mode block forward (no dropout)."""
    x = x + mha_apply(p["attn"], layer_norm_apply(p["ln1"], x),
                      num_heads=num_heads, causal=causal)
    return _block_mlp(p, x, act=act)


def block_prefill_paged(p, x, k_cache, v_cache, positions, tail_len, *,
                        num_heads: int, act: Callable = gelu,
                        block_tables, block_size: int):
    """Chunked-prefill block step over the paged pool (x [1, P, D] at
    absolute ``positions``). Returns (x, k_cache, v_cache); the pool
    views are updated in place."""
    y, k_cache, v_cache = mha_prefill_paged(
        p["attn"], layer_norm_apply(p["ln1"], x), k_cache, v_cache,
        positions, tail_len, num_heads=num_heads,
        block_tables=block_tables, block_size=block_size)
    return _block_mlp(p, x + y, act=act), k_cache, v_cache


def block_decode(p, x, k_cache, v_cache, pos, *, num_heads: int,
                 act: Callable = gelu, block_tables, block_size: int):
    """Single-token paged block step for every row (x [S, 1, D], per-row
    ``pos``). Returns (x, k_cache, v_cache); pools updated in place."""
    y, k_cache, v_cache = mha_decode(
        p["attn"], layer_norm_apply(p["ln1"], x), k_cache, v_cache, pos,
        num_heads=num_heads, block_tables=block_tables,
        block_size=block_size)
    return _block_mlp(p, x + y, act=act), k_cache, v_cache

"""Pre-LN transformer block (GPT-2): training/eval, paged decode and
paged prefill.

Port of ``quintnet_tpu/nn/transformer.py`` for one device, dense MLP
only. Block parameters arrive as ONE layer's slice of the stacked
``[L, ...]`` tree (:func:`layer_params`); a Python loop over layers
stands in for ``lax.scan`` (:func:`stacked_blocks_apply`).
"""

from __future__ import annotations

from typing import Callable

from torch.utils.checkpoint import checkpoint

from quintnet_tpu_torch.core.pytree import tree_leaves
from quintnet_tpu_torch.nn.attention import (mha_apply, mha_decode,
                                             mha_prefill_paged)
from quintnet_tpu_torch.nn.layers import gelu, layer_norm_apply, mlp_apply


def layer_params(tree, layer: int):
    """Layer ``layer``'s view of a stacked ``[L, ...]`` param tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, layer) for k, v in tree.items()}
    return tree[layer]


def unstack_layers(tree, depth: int):
    """A stacked ``[L, ...]`` tree -> a list of ``depth`` per-layer
    trees, each leaf split once with ``unbind``: its backward stacks the
    layers' gradients into one ``[L, ...]`` gradient (indexing each layer
    separately would build ``depth`` full-size zero-padded gradients)."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, depth) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(depth)]
    return list(tree.unbind(0))


def _block_mlp(p, x, *, act, pdrop: float = 0.0, generator=None):
    return x + mlp_apply(p["mlp"], layer_norm_apply(p["ln2"], x), act=act,
                         pdrop=pdrop, generator=generator)


def block_apply(p, x, *, num_heads: int, causal: bool = False,
                act: Callable = gelu, use_flash: bool = False,
                attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                generator=None, segment_ids=None):
    """Block forward. ``generator`` turns on training dropout
    (``attn_pdrop`` on the attention probabilities, ``resid_pdrop`` after
    the attention and MLP projections); None is eval. ``use_flash``
    sends attention through ``ops.flash_attention``."""
    x = x + mha_apply(p["attn"], layer_norm_apply(p["ln1"], x),
                      num_heads=num_heads, causal=causal,
                      use_flash=use_flash, attn_pdrop=attn_pdrop,
                      resid_pdrop=resid_pdrop, generator=generator,
                      segment_ids=segment_ids)
    return _block_mlp(p, x, act=act, pdrop=resid_pdrop, generator=generator)


def stacked_blocks_apply(stacked_params, x, *, num_heads: int,
                         causal: bool = False, act: Callable = gelu,
                         use_flash: bool = False, remat=False,
                         attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                         generator=None, segment_ids=None):
    """Run a ``[depth, ...]``-stacked block tree layer by layer.

    ``remat=True`` recomputes each block in backward
    (``torch.utils.checkpoint``, non-reentrant), trading compute for
    activation memory; the flash forward then runs twice per layer.
    ``generator`` (training dropout) is consumed layer after layer;
    under remat each layer records the generator's state before it runs
    and its recomputation replays from that state, so backward sees the
    forward's masks and the generator ends where the forward left it.
    ``remat="dots"`` (keep matmul outputs, recompute the rest) is not
    ported: ROADMAP.md §1, slice 2."""
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save matmul outputs, recompute the rest) is not "
            "ported; use remat=True or False (ROADMAP.md §1, slice 2)")
    if remat not in (True, False):
        raise ValueError(f"unknown remat {remat!r}")
    depth = next(tree_leaves(stacked_params))[1].shape[0]
    kw = dict(num_heads=num_heads, causal=causal, act=act,
              use_flash=use_flash, attn_pdrop=attn_pdrop,
              resid_pdrop=resid_pdrop, segment_ids=segment_ids)
    for p in unstack_layers(stacked_params, depth):
        if not remat:
            x = block_apply(p, x, generator=generator, **kw)
            continue
        state = None if generator is None else generator.get_state()
        calls = []

        def body(p, x, state=state, calls=calls):
            if state is None:
                return block_apply(p, x, generator=None, **kw)
            replay = bool(calls)
            calls.append(1)
            outer = generator.get_state()
            generator.set_state(state)
            try:
                return block_apply(p, x, generator=generator, **kw)
            finally:
                # a recomputation leaves no trace (it may also be cut
                # short by checkpoint's early stop, which raises)
                if replay:
                    generator.set_state(outer)

        x = checkpoint(body, p, x, use_reentrant=False)
    return x


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

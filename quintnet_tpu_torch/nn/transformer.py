"""Pre-LN transformer block (GPT-2, ViT): training/eval, dense KV-cache
prefill and decode, paged decode, paged prefill (also sequence-parallel)
and paged verify.

Port of ``quintnet_tpu/nn/transformer.py`` with the tp hooks
(``tp_axis``), sequence parallelism (``sp_axis``, ``sp_mode``: the
attention of ``nn/attention.mha_apply``), ZeRO-3/FSDP (``fsdp``: the
layer's shards gathered just before use) and the MoE FFN
(``moe_args``, experts sharded over ``ep_axis``). Block parameters
arrive as ONE layer's slice of the stacked ``[L, ...]`` tree
(:func:`layer_params`); a Python loop over layers stands in for
``lax.scan`` (:func:`stacked_blocks_apply`, which also runs Llama's
block through ``body_fn``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
from quintnet_tpu_torch.nn.attention import (mha_apply, mha_decode,
                                             mha_prefill_paged,
                                             mha_prefill_paged_sp,
                                             mha_verify_paged)
from quintnet_tpu_torch.nn.layers import (dropout, gelu, layer_norm_apply,
                                          mlp_apply)
from quintnet_tpu_torch.nn.moe import moe_apply

# where the options not ported yet are queued
REMAT_DOTS_ITEM = "ROADMAP.md §2, K1-K3 still owed, item 4"


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


def _block_mlp(p, x, *, act, tp_axis=None, pdrop: float = 0.0,
               generator=None):
    return x + mlp_apply(p["mlp"], layer_norm_apply(p["ln2"], x), act=act,
                         tp_axis=tp_axis, pdrop=pdrop, generator=generator)


def block_apply(p, x, *, num_heads: int, causal: bool = False,
                act: Callable = gelu, tp_axis=None, sp_axis=None,
                sp_mode: str = "ring", use_flash: bool = False,
                moe_args=None, ep_axis=None,
                attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                generator=None, segment_ids=None):
    """Block forward: ``x`` for a dense block, ``(x, aux_loss)`` with
    ``moe_args`` (the MLP is then a MoE FFN, ``p["moe"]``, experts
    sharded over ``ep_axis``; aux is this rank's load-balance term).
    ``generator`` turns on training dropout (``attn_pdrop`` on the
    attention probabilities, ``resid_pdrop`` after the attention and MLP
    projections); None is eval. ``use_flash`` sends attention through
    ``ops.flash_attention``. ``tp_axis``: the block's shards are
    tp-sharded (qkv and fc column, the projections row, LayerNorms
    replicated) and ``num_heads`` is the local count. ``sp_axis``: ``x``
    is this rank's slice of the sequence, attended by ``sp_mode``."""
    x = x + mha_apply(p["attn"], layer_norm_apply(p["ln1"], x),
                      num_heads=num_heads, causal=causal, tp_axis=tp_axis,
                      sp_axis=sp_axis, sp_mode=sp_mode, use_flash=use_flash,
                      attn_pdrop=attn_pdrop, resid_pdrop=resid_pdrop,
                      generator=generator, segment_ids=segment_ids)
    if moe_args is None:
        return _block_mlp(p, x, act=act, tp_axis=tp_axis, pdrop=resid_pdrop,
                          generator=generator)
    y, aux = moe_apply(p["moe"], layer_norm_apply(p["ln2"], x), moe_args,
                       ep_axis=ep_axis, tp_axis=tp_axis, act=act)
    if generator is not None and resid_pdrop > 0.0:
        # after the combine, whose output every tp rank holds whole: the
        # mask agrees on every tp rank
        y = dropout(generator, y, resid_pdrop, deterministic=False)
    return x + y, aux


def gather_layer(p, fsdp):
    """One layer's FSDP shards all-gathered whole: ``fsdp = (axis,
    gather dims)``, a dim of -1 leaves the leaf as it is
    (``parallel/tp.fsdp_gather_dims``). The gather's backward is a
    reduce-scatter, so the layer's gradients come back sharded."""
    axis, dims = fsdp
    return tree_map(lambda x, dim: (cc.all_gather(x, axis, gather_dim=dim)
                                    if dim >= 0 else x), p, dims)


def stacked_blocks_apply(stacked_params, x, *, num_heads: int = 0,
                         causal: bool = False, act: Callable = gelu,
                         tp_axis=None, sp_axis=None, sp_mode: str = "ring",
                         use_flash: bool = False, remat=False,
                         moe_args=None, ep_axis=None,
                         attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                         generator=None, segment_ids=None, fsdp=None,
                         body_fn: Optional[Callable] = None):
    """Run a ``[depth, ...]``-stacked block tree layer by layer.

    ``body_fn(layer_params, x, generator)`` replaces the pre-LN block
    (:func:`block_apply` with the keywords here): Llama's block plugs in
    and keeps the loop, remat and fsdp. With ``moe_args`` each layer
    returns ``(x, aux)`` and the result is ``(out, sum of the layers'
    aux)``, the sum averaged over ``sp_axis`` (each sp rank routes its
    own positions; the mean keeps the aux as redundant over sp as the
    main loss, whose gradient ``reduce_grads`` divides by sp).

    ``remat=True`` recomputes each block in backward
    (``torch.utils.checkpoint``, non-reentrant), trading compute for
    activation memory; the flash forward then runs twice per layer.
    ``generator`` (training dropout) is consumed layer after layer;
    under remat each layer records the generator's state before it runs
    and its recomputation replays from that state, so backward sees the
    forward's masks and the generator ends where the forward left it.

    ``fsdp = (axis, gather_dims)`` (ZeRO-3/FSDP): the stacked params
    arrive sharded over ``axis`` (a
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`; one dim a leaf,
    ``parallel/tp.fsdp_shard_specs``) and each layer is all-gathered
    here, just before use (:func:`gather_layer`), so one layer's full
    weights exist at a time. Under remat the gather sits inside the
    checkpointed body: backward gathers again rather than keeping the
    full layers.

    ``remat="dots"`` (keep matmul outputs, recompute the rest) is not
    ported: ROADMAP.md §2, K1-K3 still owed, item 4."""
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save matmul outputs, recompute the rest) is not "
            f"ported; use remat=True or False ({REMAT_DOTS_ITEM})")
    if remat not in (True, False):
        raise ValueError(f"unknown remat {remat!r}")
    depth = next(tree_leaves(stacked_params))[1].shape[0]
    if body_fn is None:
        kw = dict(num_heads=num_heads, causal=causal, act=act,
                  tp_axis=tp_axis, sp_axis=sp_axis, sp_mode=sp_mode,
                  use_flash=use_flash, moe_args=moe_args,
                  ep_axis=ep_axis, attn_pdrop=attn_pdrop,
                  resid_pdrop=resid_pdrop, segment_ids=segment_ids)

        def body_fn(p, x, generator):
            return block_apply(p, x, generator=generator, **kw)

    def apply(p, x, generator):
        if fsdp is not None:
            p = gather_layer(p, fsdp)
        return body_fn(p, x, generator)

    auxes = []
    for p in unstack_layers(stacked_params, depth):
        if not remat:
            out = apply(p, x, generator)
        else:
            state = None if generator is None else generator.get_state()
            calls = []

            def body(p, x, state=state, calls=calls):
                if state is None:
                    return apply(p, x, None)
                replay = bool(calls)
                calls.append(1)
                outer = generator.get_state()
                generator.set_state(state)
                try:
                    return apply(p, x, generator)
                finally:
                    # a recomputation leaves no trace (it may also be cut
                    # short by checkpoint's early stop, which raises)
                    if replay:
                        generator.set_state(outer)

            out = checkpoint(body, p, x, use_reentrant=False)
        if moe_args is not None:
            x, aux = out
            auxes.append(aux)
        else:
            x = out
    if moe_args is not None:
        aux = torch.stack(auxes).sum()
        if sp_axis is not None:
            aux = cc.all_reduce_mean(aux, sp_axis)
        return x, aux
    return x


def _serve_mlp(p, x, *, act, moe_args=None, ep_axis=None, tp_axis=None):
    """The MLP half of a serving block step -> ``(x, routing stats or
    None)``: a MoE block also hands back its routing counts
    (``nn/moe.moe_apply(return_stats=True)``), which the serving
    contracts append to their return; the aux loss has no use here."""
    if moe_args is None:
        return _block_mlp(p, x, act=act, tp_axis=tp_axis), None
    y, _aux, stats = moe_apply(p["moe"], layer_norm_apply(p["ln2"], x),
                               moe_args, ep_axis=ep_axis, tp_axis=tp_axis,
                               act=act, return_stats=True)
    return x + y, stats


def _serve_out(x, pools, stats):
    """(x, *pools[, stats]): a MoE block appends its routing stats."""
    return (x, *pools) if stats is None else (x, *pools, stats)


def block_prefill_paged(p, x, k_cache, v_cache, positions, tail_len, *,
                        num_heads: int, act: Callable = gelu,
                        moe_args=None, ep_axis=None, tp_axis=None,
                        block_tables, block_size: int, kv_scales=None,
                        policy=None):
    """Chunked-prefill block step over the paged pool (x [1, P, D] at
    absolute ``positions``). ``kv_scales``/``policy``: this layer's
    (k_scale, v_scale) views under a scaled KV layout. ``tp_axis``:
    head-sharded pool and ``num_heads`` local; ``moe_args``/``ep_axis``:
    a MoE FFN, experts sharded over ep. Returns (x, k_cache, v_cache[,
    k_scale, v_scale][, moe_stats]); the pool views are updated in
    place."""
    y, *pools = mha_prefill_paged(
        p["attn"], layer_norm_apply(p["ln1"], x), k_cache, v_cache,
        positions, tail_len, num_heads=num_heads, tp_axis=tp_axis,
        block_tables=block_tables, block_size=block_size,
        kv_scales=kv_scales, policy=policy)
    x, stats = _serve_mlp(p, x + y, act=act, moe_args=moe_args,
                          ep_axis=ep_axis, tp_axis=tp_axis)
    return _serve_out(x, pools, stats)


def block_prefill_paged_sp(p, x, k_cache, v_cache, start: int, t0: int, *,
                           num_heads: int, sp_axis, act: Callable = gelu,
                           tp_axis=None, block_tables, block_size: int,
                           kv_scales=None, policy=None):
    """Sequence-parallel chunked-prefill block step
    (``nn/attention.mha_prefill_paged_sp``): x [1, Pl, D] is this sp
    rank's slice of the chunk at positions ``start + rank*Pl +
    arange(Pl)``; the attention rides the ring over ``sp_axis``, the
    LN/MLP halves are position-wise and stay local. A MoE block never
    gets here (the engine refuses MoE with sp). Returns (x, k_cache,
    v_cache[, k_scale, v_scale]) with the whole chunk's K/V written into
    the sp-replicated pool."""
    y, *pools = mha_prefill_paged_sp(
        p["attn"], layer_norm_apply(p["ln1"], x), k_cache, v_cache, start,
        t0, num_heads=num_heads, sp_axis=sp_axis, tp_axis=tp_axis,
        block_tables=block_tables, block_size=block_size,
        kv_scales=kv_scales, policy=policy)
    return (_block_mlp(p, x + y, act=act, tp_axis=tp_axis), *pools)


def block_verify_paged(p, x, k_cache, v_cache, positions, tail_lens, *,
                       num_heads: int, act: Callable = gelu, moe_args=None,
                       ep_axis=None, tp_axis=None, block_tables,
                       block_size: int, kv_scales=None, policy=None):
    """Batched verify block step (x [S, P, D] per-row runs at absolute
    ``positions`` [S, P]); ``tp_axis``, ``moe_args``, ``ep_axis`` as
    :func:`block_prefill_paged`. Returns (x, k_cache, v_cache[, k_scale,
    v_scale][, moe_stats]); pools updated in place."""
    y, *pools = mha_verify_paged(
        p["attn"], layer_norm_apply(p["ln1"], x), k_cache, v_cache,
        positions, tail_lens, num_heads=num_heads, tp_axis=tp_axis,
        block_tables=block_tables, block_size=block_size,
        kv_scales=kv_scales, policy=policy)
    x, stats = _serve_mlp(p, x + y, act=act, moe_args=moe_args,
                          ep_axis=ep_axis, tp_axis=tp_axis)
    return _serve_out(x, pools, stats)


def block_prefill(p, x, *, num_heads: int, act: Callable = gelu,
                  moe_args=None, tp_axis=None):
    """Causal block forward that also returns this layer's (k, v)
    [B, H, S, Dh]: the prefill half of KV-cache generation, plain
    attention. ``tp_axis``: head-sharded, ``num_heads`` is LOCAL heads
    and the cache holds only this rank's heads."""
    a, (k, v) = mha_apply(p["attn"], layer_norm_apply(p["ln1"], x),
                          num_heads=num_heads, causal=True, return_kv=True,
                          tp_axis=tp_axis)
    x, _stats = _serve_mlp(p, x + a, act=act, moe_args=moe_args,
                           tp_axis=tp_axis)
    return x, (k, v)


def block_decode(p, x, k_cache, v_cache, pos, *, num_heads: int,
                 act: Callable = gelu, moe_args=None, ep_axis=None,
                 tp_axis=None, block_tables=None, block_size=None,
                 kv_scales=None, policy=None):
    """Single-token cached block step (``nn/attention.mha_decode``).
    Dense (``block_tables=None``, the generation decoders): caches
    [B, H, T, Dh], ``pos`` the host write position, ``moe_args`` and
    ``tp_axis`` as :func:`block_prefill`. Paged (the serving engine):
    x [S, 1, D], flat pool views, per-row ``pos``; ``ep_axis`` shards a
    MoE block's experts. Returns (x, k_cache, v_cache[, k_scale,
    v_scale][, moe_stats]); caches and pools updated in place."""
    y, *pools = mha_decode(
        p["attn"], layer_norm_apply(p["ln1"], x), k_cache, v_cache, pos,
        num_heads=num_heads, tp_axis=tp_axis, block_tables=block_tables,
        block_size=block_size, kv_scales=kv_scales, policy=policy)
    x, stats = _serve_mlp(p, x + y, act=act, moe_args=moe_args,
                          ep_axis=ep_axis, tp_axis=tp_axis)
    return _serve_out(x, pools, stats)

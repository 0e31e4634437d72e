"""Multi-head attention: the dense causal path and the paged serving path.

Port of ``quintnet_tpu/nn/attention.py`` (tp; sp in training: ring,
zigzag and Ulysses), with Llama's rotary tables and GQA's
``repeat_kv``.
The dense half (:func:`sdpa`, :func:`mha_apply`) is the training and
eval forward: plain attention, or with ``use_flash`` the
``ops.flash_attention`` dispatcher (the flash kernels on the card);
attention-probability and residual dropout draw from a
``torch.Generator``. The dense KV-cache decoders
(``models/gpt2_generate.py``, ``models/llama_generate.py``) prefill
through ``mha_apply(return_kv=True)`` and decode through
:func:`mha_decode`'s dense branch, both plain attention. The paged half
writes a
run's K/V through the block table into the flat pool views and reads
the row back through ``ops.paged_attention.paged_attention`` — the
CUDA kernel on the card, the gathered-view math on the CPU. There is
no ``attn_kernel`` switch.

Pool writes are IN PLACE: ``k_cache``/``v_cache`` are views of the
engine's ``[L, slots, H, Dh]`` pool tensors and are updated where they
lie (the JAX package returns new arrays; the functions here return the
same tensors so the call sites read alike). Under a scaled layout
policy (``serve/kv_quant.py``: int8, fake_quant) the layer's [nb, H]
scale views ride along as ``kv_scales`` and are updated in place too.
"""

from __future__ import annotations

import math

import torch

from quintnet_tpu_torch.nn.layers import dropout, linear_apply, linear_init
from quintnet_tpu_torch.ops.flash_attention import flash_attention
# the gathered-view reads live in the ops layer, beside the kernel's
# plain version that uses them; re-exported here, where the JAX package
# keeps them
from quintnet_tpu_torch.ops.paged_attention import (  # noqa: F401
    _gather_kv, paged_attention, paged_gather, paged_gather_dequant,
    paged_gather_scales, paged_quant_window_update, store_rows)
from quintnet_tpu_torch.parallel.tp import row_parallel_linear


def mha_init(generator: torch.Generator, dim: int, *, lead=()):
    return {"qkv": linear_init(generator, dim, 3 * dim, lead=lead),
            "proj": linear_init(generator, dim, dim, lead=lead)}


def rope_cos_sin(positions, head_dim: int, *, theta: float = 10000.0,
                 inv_freq=None):
    """Rotary tables for integer ``positions`` [...]: (cos, sin), each
    [..., head_dim] f32, the half-dim frequencies duplicated (HF Llama's
    layout: lanes i and i + d/2 share a frequency). ``inv_freq`` [d/2]
    replaces the plain ``1 / theta^(2i/d)`` (rope scaling:
    ``models/llama.llama3_scaled_inv_freq``)."""
    if inv_freq is None:
        inv_freq = 1.0 / (theta ** (torch.arange(
            0, head_dim, 2, dtype=torch.float32, device=positions.device)
            / head_dim))
    ang = positions.float()[..., None] * inv_freq.to(positions.device)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotate [B, H, S, Dh] by tables broadcastable to it ([S, Dh]): HF's
    rotate_half, computed in f32 and cast back to ``x``'s dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def repeat_kv(x, n_rep: int):
    """[B, Hkv, S, Dh] -> [B, Hkv * n_rep, S, Dh] (GQA: each kv head
    shared by ``n_rep`` query heads; groups contiguous, HF's order)."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep,
                                                           s, d)


def _split_heads(qkv, num_heads: int):
    """[B, S, 3*H*Dh] -> q, k, v each [B, H, S, Dh] (contiguous)."""
    B, S, _ = qkv.shape
    q, k, v = qkv.chunk(3, dim=-1)
    return tuple(t.reshape(B, S, num_heads, -1).transpose(1, 2).contiguous()
                 for t in (q, k, v))


def _merge_heads(o):
    """[B, H, S, Dh] -> [B, S, H*Dh]."""
    B, H, S, Dh = o.shape
    return o.transpose(1, 2).reshape(B, S, H * Dh)


def sdpa(q, k, v, *, causal: bool, pdrop: float = 0.0, generator=None,
         segment_ids=None):
    """Plain scaled-dot-product attention [B, H, S, Dh] -> same; f32
    softmax, masked scores set to ``finfo.min``. ``segment_ids`` [B, S]:
    pairs from different packed documents are masked. With
    ``generator``, dropout at ``pdrop`` on the probabilities."""
    dh = q.shape[-1]
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).float() / math.sqrt(dh)
    if causal:
        s, t = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        scores = scores.masked_fill(~same, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if generator is not None and pdrop > 0.0:
        probs = dropout(generator, probs, pdrop, deterministic=False)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


SP_MODES = ("ring", "zigzag", "ulysses")


def sp_attention(q, k, v, *, sp_axis, sp_mode: str = "ring",
                 causal: bool = False, use_flash: bool = False,
                 pdrop: float = 0.0, generator=None, segment_ids=None):
    """Attention over a sequence sharded on ``sp_axis`` by ``sp_mode``:
    ``"ring"`` (K/V rotation, ``ops/ring_attention.py``), ``"zigzag"``
    (the load-balanced causal ring) or ``"ulysses"`` (the head-scatter
    all-to-all, ``ops/ulysses_attention.py``: the flash kernels with
    ``use_flash``; ring and zigzag are plain attention per chunk, as in
    JAX). Another mode raises JAX's ``ValueError``."""
    kw = dict(axis=sp_axis, causal=causal, pdrop=pdrop, generator=generator,
              segment_ids=segment_ids)
    if sp_mode == "ulysses":
        from quintnet_tpu_torch.ops.ulysses_attention import \
            ulysses_attention

        return ulysses_attention(q, k, v, use_flash=use_flash, **kw)
    if sp_mode not in SP_MODES:
        raise ValueError(f"unknown sp_mode {sp_mode!r}; expected 'ring', "
                         "'zigzag' or 'ulysses'")
    from quintnet_tpu_torch.ops import ring_attention as ring

    fn = (ring.zigzag_ring_attention if sp_mode == "zigzag"
          else ring.ring_attention)
    return fn(q, k, v, **kw)


def mha_apply(p, x, *, num_heads: int, causal: bool = False,
              tp_axis=None, sp_axis=None, sp_mode: str = "ring",
              use_flash: bool = False, return_kv: bool = False,
              attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
              generator=None, segment_ids=None):
    """x [B, S, D] -> [B, S, D]: fused qkv, attention (plain, or the
    flash dispatcher with ``use_flash``), proj. With ``generator``
    (training): dropout at ``attn_pdrop`` on the attention
    probabilities and at ``resid_pdrop`` after the projection.
    ``segment_ids`` [B, S] masks attention across packed documents.

    ``num_heads`` is the number of LOCAL heads: with ``tp_axis`` (a
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`) qkv is
    column-sharded in the tp-blocked layout (``parallel/tp.py``), so this
    rank computes ``num_heads = heads / tp`` whole heads ([B, H/tp, S,
    Dh] into the flash kernels), and proj is row-sharded with one sum
    over tp before its bias; the residual dropout comes after the sum,
    so its mask agrees on every tp rank.

    ``sp_axis`` (a MeshAxis): ``x`` is this rank's slice of the sequence
    and attention runs sequence-parallel by ``sp_mode``
    (:func:`sp_attention`); ``segment_ids`` is then this rank's [B,
    S_local] slice of the GLOBAL ids (``models/gpt2.
    segment_ids_from_input(sp_axis=)``).

    ``return_kv=True`` also returns this rank's per-head (k, v) [B, H, S,
    Dh]: the prefill half of the dense KV-cache decoder
    (``models/gpt2_generate.py``)."""
    q, k, v = _split_heads(linear_apply(p["qkv"], x), num_heads)
    kw = dict(causal=causal, pdrop=attn_pdrop, generator=generator,
              segment_ids=segment_ids)
    if sp_axis is not None:
        o = sp_attention(q, k, v, sp_axis=sp_axis, sp_mode=sp_mode,
                         use_flash=use_flash, **kw)
    else:
        o = (flash_attention if use_flash else sdpa)(q, k, v, **kw)
    y = row_parallel_linear(p["proj"], _merge_heads(o), axis=tp_axis)
    if generator is not None and resid_pdrop > 0.0:
        y = dropout(generator, y, resid_pdrop, deterministic=False)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------
# paged pool
# ---------------------------------------------------------------------

def paged_cache_update(k_cache, v_cache, k, v, pos, *, block_tables,
                       block_size: int):
    """Write one token's (k, v) [B, H, Dh] per row at that row's
    position ``pos`` [B] through ``block_tables`` [B, M], narrowed to the
    pool's dtype. Inactive rows carry an all-zero table row and pos 0:
    their writes land in the null block 0, which nobody reads. In
    place."""
    pos = pos.long()
    blk = block_tables.gather(1, (pos // block_size)[:, None])[:, 0].long()
    idx = blk * block_size + pos % block_size
    store_rows(k_cache, idx, k.to(k_cache.dtype))
    store_rows(v_cache, idx, v.to(v_cache.dtype))
    return k_cache, v_cache


def paged_prefill_update(k_cache, v_cache, k, v, positions, tail_len, *,
                         block_tables, block_size: int):
    """Write one request's tail (k, v) [H, P, Dh] at absolute
    ``positions`` [P] through its table row ``block_tables`` [M]. Pad
    columns (index >= ``tail_len``) and positions past the table go to
    the null block. In place."""
    P = positions.shape[0]
    positions = positions.long()
    blk_idx = (positions // block_size).clamp(0, block_tables.shape[0] - 1)
    live = torch.arange(P, device=positions.device) < int(tail_len)
    idx = torch.where(live,
                      block_tables.long()[blk_idx] * block_size
                      + positions % block_size,
                      torch.zeros_like(positions))
    store_rows(k_cache, idx, k.transpose(0, 1).to(k_cache.dtype))
    store_rows(v_cache, idx, v.transpose(0, 1).to(v_cache.dtype))
    return k_cache, v_cache


def paged_verify_update(k_cache, v_cache, k, v, positions, tail_lens, *,
                        block_tables, block_size: int):
    """Write EVERY row's short run (k, v) [S, H, P, Dh] at ``positions``
    [S, P] (``start_s + arange(P)``) through ``block_tables`` [S, M] in
    one scatter. Columns at or beyond a row's ``tail_lens[s]`` (pad,
    inactive rows) go to the null block. In place."""
    S, P = positions.shape
    M = block_tables.shape[1]
    positions = positions.long()
    blk = block_tables.long().gather(
        1, (positions // block_size).clamp(0, M - 1))               # [S, P]
    live = (torch.arange(P, device=positions.device)[None, :]
            < tail_lens.long()[:, None])
    idx = torch.where(live, blk * block_size + positions % block_size,
                      torch.zeros_like(positions)).reshape(S * P)
    H, Dh = k.shape[1], k.shape[3]
    store_rows(k_cache, idx,
               k.transpose(1, 2).reshape(S * P, H, Dh).to(k_cache.dtype))
    store_rows(v_cache, idx,
               v.transpose(1, 2).reshape(S * P, H, Dh).to(v_cache.dtype))
    return k_cache, v_cache


def _quant_span(p_tokens: int, block_size: int, table_width: int) -> int:
    """Window width of :func:`paged_quant_window_update`: the most blocks
    a ``p_tokens``-long write run can touch."""
    return min(-(-p_tokens // block_size) + 1, table_width)


def _paged_attention_scaled(policy, k_cache, v_cache, ks, vs, q, k, v,
                            positions, lens, block_tables, *,
                            block_size: int, max_blocks: int):
    """The scaled-policy step every paged entry point shares: score the
    run's exact f32 K/V against the PRE-write pool (the kernel's fresh
    override), THEN requantize the run's touched blocks, k and v
    (``paged_quant_window_update``, in place). The order matters: the
    pools are updated in place, so a write before the read would make
    the scores see the quantization round trip. ``positions`` [S, P]
    contiguous runs; ``lens`` [S]. Returns (o, k_cache, v_cache, ks,
    vs)."""
    o = paged_attention(q, k_cache, v_cache, block_tables,
                        positions[:, 0].contiguous(), block_size=block_size,
                        kv_scales=(ks, vs), fresh_kv=(k, v))
    for cache, scales, vals in ((k_cache, ks, k), (v_cache, vs, v)):
        paged_quant_window_update(policy, cache, scales, vals, positions,
                                  lens, block_tables=block_tables,
                                  block_size=block_size,
                                  max_blocks=max_blocks)
    return o, k_cache, v_cache, ks, vs


def _paged_out(p, o, pools):
    """proj of the merged heads, then the pools the caller hands back:
    (y, k, v) passthrough, (y, k, v, k_scale, v_scale) scaled."""
    return (linear_apply(p["proj"], _merge_heads(o)), *pools)


def mha_prefill_paged(p, x, k_cache, v_cache, positions, tail_len, *,
                      num_heads: int, block_tables, block_size: int,
                      kv_scales=None, policy=None):
    """Chunked prefill over the paged pool for ONE request: ``x``
    [1, P, D] tail hidden states at ``positions`` (``start +
    arange(P)``, int32). Each tail query attends causally to the whole
    row — cached prefix plus fresh tail — through the paged-attention
    kernel. Passthrough pools take the tail's K/V first and the kernel
    reads it back; under a scaled policy (``kv_scales`` = this layer's
    (k_scale, v_scale), ``policy``) the kernel reads the pre-write pool
    with the fresh run overriding it, then the touched blocks are
    requantized. Returns (y [1, P, D], k_cache, v_cache[, k_scale,
    v_scale])."""
    q, k, v = _split_heads(linear_apply(p["qkv"], x), num_heads)
    tables = block_tables[None]
    if kv_scales is None:
        paged_prefill_update(k_cache, v_cache, k[0], v[0], positions,
                             tail_len, block_tables=block_tables,
                             block_size=block_size)
        o = paged_attention(q, k_cache, v_cache, tables, positions[:1],
                            block_size=block_size)
        return _paged_out(p, o, (k_cache, v_cache))
    lens = torch.full((1,), int(tail_len), dtype=torch.int32,
                      device=positions.device)
    o, *pools = _paged_attention_scaled(
        policy, k_cache, v_cache, *kv_scales, q, k, v, positions[None, :],
        lens, tables, block_size=block_size,
        max_blocks=_quant_span(positions.shape[0], block_size,
                               block_tables.shape[0]))
    return _paged_out(p, o, pools)


def mha_verify_paged(p, x, k_cache, v_cache, positions, tail_lens, *,
                     num_heads: int, block_tables, block_size: int,
                     kv_scales=None, policy=None):
    """Batched verify attention over the paged pool: EVERY row scores a
    short run ``x`` [S, P, D] at ``positions`` [S, P] against its own
    cached row — the decode step widened from 1 to P tokens a row (the
    teacher-forced scoring of ``serve/kv_quant.paged_eval_nll``, and
    speculative decoding's target step). Columns at or beyond
    ``tail_lens[s]`` are pad. Pool handling as in
    :func:`mha_prefill_paged`, batched over rows. Returns (y [S, P, D],
    k_cache, v_cache[, k_scale, v_scale])."""
    q, k, v = _split_heads(linear_apply(p["qkv"], x), num_heads)
    if kv_scales is None:
        paged_verify_update(k_cache, v_cache, k, v, positions, tail_lens,
                            block_tables=block_tables,
                            block_size=block_size)
        o = paged_attention(q, k_cache, v_cache, block_tables,
                            positions[:, 0].contiguous(),
                            block_size=block_size)
        return _paged_out(p, o, (k_cache, v_cache))
    o, *pools = _paged_attention_scaled(
        policy, k_cache, v_cache, *kv_scales, q, k, v, positions, tail_lens,
        block_tables, block_size=block_size,
        max_blocks=_quant_span(positions.shape[1], block_size,
                               block_tables.shape[1]))
    return _paged_out(p, o, pools)


def dense_cache_attend(q, k_cache, v_cache, pos: int):
    """One query position against a dense cache: ``q`` [B, H, 1, Dh],
    caches [B, H, T, Dh] whose positions ``<= pos`` are written; the
    unwritten tail is masked with ``finfo.min`` (f32 scores and softmax,
    as :func:`sdpa`). Returns o [B, H, 1, Dh]."""
    dh = q.shape[-1]
    scores = torch.einsum("bhsd,bhtd->bhst", q, k_cache).float() \
        / math.sqrt(dh)
    valid = torch.arange(k_cache.shape[2], device=q.device) <= pos
    scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bhtd->bhsd", probs, v_cache)


def mha_decode(p, x, k_cache, v_cache, pos, *, num_heads: int,
               tp_axis=None, block_tables=None, block_size=None,
               kv_scales=None, policy=None):
    """Single-token cached attention.

    Dense (the generation decoders, ``block_tables=None``): ``x``
    [B, 1, D], caches [B, H, T, Dh] (this rank's heads under
    ``tp_axis``, whose proj is row-sharded with one sum over tp), ``pos``
    the host int write position shared by the batch. The token's (k, v)
    are written at ``pos`` in place and the query attends to positions
    ``<= pos`` in plain PyTorch (no kernel, as the JAX package's dense
    branch runs no Pallas kernel). Returns (y, k_cache, v_cache).

    Paged (the serving engine): ``x`` [B, 1, D], flat pool views,
    ``pos`` [B] int32 per-row positions, ``block_tables`` [B, M] int32.
    Pool handling as in :func:`mha_prefill_paged`; a scaled decode
    requantizes one block a row (``max_blocks=1``). Returns (y, k_cache,
    v_cache[, k_scale, v_scale]). tp serving meshes are not ported
    (ROADMAP.md §1, item 7)."""
    q, k, v = _split_heads(linear_apply(p["qkv"], x), num_heads)
    if block_tables is None:
        if kv_scales is not None:
            raise ValueError(
                "scaled KV layout policies exist only for the paged pool "
                "(block_tables is required)")
        k_cache[:, :, pos] = k[:, :, 0].to(k_cache.dtype)
        v_cache[:, :, pos] = v[:, :, 0].to(v_cache.dtype)
        o = dense_cache_attend(q, k_cache, v_cache, pos)
        y = row_parallel_linear(p["proj"], _merge_heads(o), axis=tp_axis)
        return y, k_cache, v_cache
    if tp_axis is not None:
        raise NotImplementedError(
            "paged decode on a tp mesh is not ported yet (ROADMAP.md §1, "
            "item 7)")
    if kv_scales is None:
        paged_cache_update(k_cache, v_cache, k[:, :, 0], v[:, :, 0], pos,
                           block_tables=block_tables, block_size=block_size)
        o = paged_attention(q, k_cache, v_cache, block_tables, pos,
                            block_size=block_size)
        return _paged_out(p, o, (k_cache, v_cache))
    o, *pools = _paged_attention_scaled(
        policy, k_cache, v_cache, *kv_scales, q, k, v, pos[:, None],
        torch.ones_like(pos), block_tables, block_size=block_size,
        max_blocks=1)
    return _paged_out(p, o, pools)

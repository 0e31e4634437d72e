"""Multi-head attention: the dense causal path and the paged serving path.

Port of ``quintnet_tpu/nn/attention.py`` (tp; sp in training: ring,
zigzag and Ulysses; sp in serving: the ring over the paged pool), with
Llama's rotary tables and GQA's ``repeat_kv``.
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
no ``attn_kernel`` switch. Under ``tp_axis`` (a
:class:`~quintnet_tpu_torch.core.mesh.MeshAxis`) every paged function
works on this rank's heads of a head-sharded pool, and the output
projection is row-parallel with one sum over tp.
:func:`ring_paged_prefill` (sequence-parallel prefill over ``sp_axis``)
runs plain attention, as JAX's ring does: no kernel.

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

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.nn.layers import (dropout, linear_apply, linear_init,
                                         lora_delta, quantized_matmul)
from quintnet_tpu_torch.ops.flash_attention import flash_attention
# the gathered-view reads live in the ops layer, beside the kernel's
# plain version that uses them; re-exported here, where the JAX package
# keeps them
from quintnet_tpu_torch.ops.paged_attention import (  # noqa: F401
    _gather_kv, paged_attention, paged_gather, paged_gather_dequant,
    last_null_rows, paged_gather_scales, paged_quant_window_update,
    store_rows)
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
    their writes land in the null block's row 0 (the last such row's
    values, :func:`last_null_rows`), which only they read. In place."""
    pos = pos.long()
    blk = block_tables.gather(1, (pos // block_size)[:, None])[:, 0].long()
    idx = blk * block_size + pos % block_size
    k, v = last_null_rows(idx, k, v)
    store_rows(k_cache, idx, k.to(k_cache.dtype))
    store_rows(v_cache, idx, v.to(v_cache.dtype))
    return k_cache, v_cache


def paged_prefill_update(k_cache, v_cache, k, v, positions, tail_len, *,
                         block_tables, block_size: int):
    """Write one request's tail (k, v) [H, P, Dh] at absolute
    ``positions`` [P] through its table row ``block_tables`` [M]. Pad
    columns (index >= ``tail_len``) and positions past the table go to
    the null block (the last pad column's values, :func:`last_null_rows`).
    In place."""
    P = positions.shape[0]
    positions = positions.long()
    blk_idx = (positions // block_size).clamp(0, block_tables.shape[0] - 1)
    live = torch.arange(P, device=positions.device) < int(tail_len)
    idx = torch.where(live,
                      block_tables.long()[blk_idx] * block_size
                      + positions % block_size,
                      torch.zeros_like(positions))
    k, v = last_null_rows(idx, k.transpose(0, 1), v.transpose(0, 1))
    store_rows(k_cache, idx, k.to(k_cache.dtype))
    store_rows(v_cache, idx, v.to(v_cache.dtype))
    return k_cache, v_cache


def paged_verify_update(k_cache, v_cache, k, v, positions, tail_lens, *,
                        block_tables, block_size: int):
    """Write EVERY row's short run (k, v) [S, H, P, Dh] at ``positions``
    [S, P] (``start_s + arange(P)``) through ``block_tables`` [S, M] in
    one scatter. Columns at or beyond a row's ``tail_lens[s]`` (pad,
    inactive rows) go to the null block (the last such column's values,
    :func:`last_null_rows`). In place."""
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
    k, v = last_null_rows(idx, k.transpose(1, 2).reshape(S * P, H, Dh),
                          v.transpose(1, 2).reshape(S * P, H, Dh))
    store_rows(k_cache, idx, k.to(k_cache.dtype))
    store_rows(v_cache, idx, v.to(v_cache.dtype))
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


def _serve_qkv(p, x, num_heads: int, lora=None, lora_scale=None):
    """The serving paths' qkv projection through ``quantized_matmul``
    (packed weights), a packed per-slot LoRA delta on it before the head
    split (``nn/layers.lora_delta``), then q, k, v [B, H, S, Dh]."""
    qkv = linear_apply(p["qkv"], x)
    if lora is not None and "qkv" in lora:
        qkv = qkv + lora_delta(x, lora["qkv"], lora_scale)
    return _split_heads(qkv, num_heads)


def _paged_out(p, o, pools, tp_axis=None, lora=None, lora_scale=None):
    """proj of the merged heads through ``quantized_matmul``, its LoRA
    delta, one sum over tp under ``tp_axis`` (row-parallel), then the
    bias; then the pools the caller hands back: (y, k, v) passthrough,
    (y, k, v, k_scale, v_scale) scaled."""
    o = _merge_heads(o)
    y = quantized_matmul(o, p["proj"])
    if lora is not None and "proj" in lora:
        y = y + lora_delta(o, lora["proj"], lora_scale)
    if tp_axis is not None:
        y = cc.all_reduce(y, tp_axis)
    if "b" in p["proj"]:
        y = y + p["proj"]["b"]
    return (y, *pools)


def paged_attend_prefill(q, k, v, k_cache, v_cache, positions, tail_len,
                         *, block_tables, block_size: int, kv_scales=None,
                         policy=None):
    """The pool half of a one-request prefill: ``q`` [1, Hq, P, Dh] and
    the tail's UNrepeated ``k``/``v`` [1, Hkv, P, Dh] at ``positions``
    [P] (``start + arange(P)``, int32), ``block_tables`` [M] its table
    row. Each query attends causally to the whole row (cached prefix
    plus fresh tail) through ``ops.paged_attention``, which takes the GQA
    group itself. Passthrough pools take the tail's K/V first and the
    kernel reads it back; under a scaled policy (``kv_scales`` = this
    layer's (k_scale, v_scale), ``policy``) the kernel reads the
    pre-write pool with the fresh run overriding it, then the touched
    blocks are requantized. The kernel takes contiguous q and runs
    (Llama's come transposed). Returns (o [1, Hq, P, Dh], k_cache,
    v_cache[, k_scale, v_scale])."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    tables = block_tables[None]
    if kv_scales is None:
        paged_prefill_update(k_cache, v_cache, k[0], v[0], positions,
                             tail_len, block_tables=block_tables,
                             block_size=block_size)
        return (paged_attention(q, k_cache, v_cache, tables, positions[:1],
                                block_size=block_size), k_cache, v_cache)
    lens = torch.full((1,), int(tail_len), dtype=torch.int32,
                      device=positions.device)
    return _paged_attention_scaled(
        policy, k_cache, v_cache, *kv_scales, q, k, v, positions[None, :],
        lens, tables, block_size=block_size,
        max_blocks=_quant_span(positions.shape[0], block_size,
                               block_tables.shape[0]))


def paged_attend_verify(q, k, v, k_cache, v_cache, positions, tail_lens,
                        *, block_tables, block_size: int, kv_scales=None,
                        policy=None):
    """:func:`paged_attend_prefill` batched over rows: ``q`` [S, Hq, P,
    Dh], runs ``k``/``v`` [S, Hkv, P, Dh] at ``positions`` [S, P],
    ``block_tables`` [S, M]; columns at or beyond ``tail_lens[s]`` are
    pad (their writes go to the null block)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kv_scales is None:
        paged_verify_update(k_cache, v_cache, k, v, positions, tail_lens,
                            block_tables=block_tables,
                            block_size=block_size)
        return (paged_attention(q, k_cache, v_cache, block_tables,
                                positions[:, 0].contiguous(),
                                block_size=block_size), k_cache, v_cache)
    return _paged_attention_scaled(
        policy, k_cache, v_cache, *kv_scales, q, k, v, positions, tail_lens,
        block_tables, block_size=block_size,
        max_blocks=_quant_span(positions.shape[1], block_size,
                               block_tables.shape[1]))


def paged_attend_decode(q, k, v, k_cache, v_cache, pos, *, block_tables,
                        block_size: int, kv_scales=None, policy=None):
    """One token a row: ``q`` [S, Hq, 1, Dh], ``k``/``v`` [S, Hkv, 1,
    Dh] at ``pos`` [S] int32; a scaled decode requantizes one block a
    row (``max_blocks=1``)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kv_scales is None:
        paged_cache_update(k_cache, v_cache, k[:, :, 0], v[:, :, 0], pos,
                           block_tables=block_tables, block_size=block_size)
        return (paged_attention(q, k_cache, v_cache, block_tables, pos,
                                block_size=block_size), k_cache, v_cache)
    return _paged_attention_scaled(
        policy, k_cache, v_cache, *kv_scales, q, k, v, pos[:, None],
        torch.ones_like(pos), block_tables, block_size=block_size,
        max_blocks=1)


def mha_prefill_paged(p, x, k_cache, v_cache, positions, tail_len, *,
                      num_heads: int, block_tables, block_size: int,
                      tp_axis=None, lora=None, lora_scale=None,
                      kv_scales=None, policy=None):
    """Chunked prefill over the paged pool for ONE request: ``x``
    [1, P, D] tail hidden states at ``positions`` (``start +
    arange(P)``, int32), attended by :func:`paged_attend_prefill`.
    ``num_heads`` is LOCAL heads under ``tp_axis``. ``lora``/
    ``lora_scale``: the request's packed adapter rows [1, ...]
    (``nn/layers.lora_delta``) on qkv and proj. Returns (y [1, P, D],
    k_cache, v_cache[, k_scale, v_scale])."""
    q, k, v = _serve_qkv(p, x, num_heads, lora, lora_scale)
    o, *pools = paged_attend_prefill(
        q, k, v, k_cache, v_cache, positions, tail_len,
        block_tables=block_tables, block_size=block_size,
        kv_scales=kv_scales, policy=policy)
    return _paged_out(p, o, pools, tp_axis, lora, lora_scale)


def mha_verify_paged(p, x, k_cache, v_cache, positions, tail_lens, *,
                     num_heads: int, block_tables, block_size: int,
                     tp_axis=None, lora=None, lora_scale=None,
                     kv_scales=None, policy=None):
    """Batched verify attention over the paged pool: EVERY row scores a
    short run ``x`` [S, P, D] at ``positions`` [S, P] against its own
    cached row — the decode step widened from 1 to P tokens a row (the
    teacher-forced scoring of ``serve/kv_quant.paged_eval_nll``, and
    speculative decoding's target step). Columns at or beyond
    ``tail_lens[s]`` are pad (:func:`paged_attend_verify`); ``tp_axis``
    and ``lora`` (every slot's rows) as :func:`mha_prefill_paged`.
    Returns (y [S, P, D], k_cache, v_cache[, k_scale, v_scale])."""
    q, k, v = _serve_qkv(p, x, num_heads, lora, lora_scale)
    o, *pools = paged_attend_verify(
        q, k, v, k_cache, v_cache, positions, tail_lens,
        block_tables=block_tables, block_size=block_size,
        kv_scales=kv_scales, policy=policy)
    return _paged_out(p, o, pools, tp_axis, lora, lora_scale)


# ---------------------------------------------------------------------
# sequence-parallel prefill over the paged pool
# ---------------------------------------------------------------------

def _online_merge(m, l, acc, m_new, l_new, o_new):
    """Fold one chunk's (row max, probability sum, weighted V) into the
    running online-softmax accumulators; identity (-inf, 0, 0)."""
    m_tot = torch.maximum(m, m_new)
    m_base = torch.where(torch.isfinite(m_tot), m_tot,
                         torch.zeros_like(m_tot))

    def rescale(mm):
        c = torch.exp(torch.where(torch.isfinite(mm), mm - m_base,
                                  torch.full_like(mm, -math.inf)))
        return torch.where(torch.isfinite(c), c, torch.zeros_like(c))

    c_old, c_new = rescale(m), rescale(m_new)
    return (m_tot, l * c_old + l_new * c_new,
            acc * c_old[..., None] + o_new * c_new[..., None])


def ring_paged_prefill(q, k, v, start: int, t0: int, k_cache, v_cache, *,
                       sp_axis, block_tables, block_size: int,
                       kv_scales=None, policy=None):
    """Sequence-parallel chunk attention over the paged pool: ring
    attention across ``sp_axis`` (a
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`) for the chunk's own
    K/V, merged online with each local query's attention over the
    already-resident pool prefix; then ONE all-gather reassembles the
    whole chunk's K/V for the pool write, which every rank makes (the
    pool is replicated over sp).

    ``q`` [1, Hq, Pl, Dh] is this rank's slice of the chunk's queries
    (rank i owns positions ``start + i*Pl .. start + (i+1)*Pl``),
    ``k``/``v`` [1, Hkv, Pl, Dh] the matching UNrepeated slice (GQA
    repeats locally, never on the wire). Positions at or beyond ``t0``
    are bucket pad: their keys are masked out of every score and their
    pool writes land in the null block. The K/V pair rotates ``sp - 1``
    times by ``core/collectives.ppermute`` (JAX's scan makes an ``sp``-th
    rotation whose result it discards); a chunk's positions need no wire,
    since the chunk a rank holds at step j came from rank ``i - j``.
    Plain attention (f32 scores, -inf masks), as JAX's ring: no kernel.

    Returns (o [1, Hq, Pl, Dh], k_cache, v_cache[, k_scale, v_scale]),
    the pools updated in place."""
    from quintnet_tpu_torch.core import collectives as cc

    sp, idx = sp_axis.size, sp_axis.index
    _, hq, pl, dh = q.shape
    rep = hq // k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    q_pos = start + idx * pl + torch.arange(pl, device=dev)        # [Pl]
    qf = q.float()

    def contrib(k_in, v_in, mask):
        """(m, l, o) of the local queries against one K/V chunk under
        ``mask`` [Pl, T]; fully masked rows give the merge identity."""
        kf = repeat_kv(k_in, rep).float()
        vf = repeat_kv(v_in, rep).float()
        s = torch.einsum("bhqd,bhtd->bhqt", qf, kf) * scale
        s = s.masked_fill(~mask, -math.inf)
        m = s.amax(dim=-1)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.where(mask, torch.exp(s - m_safe[..., None]),
                        torch.zeros_like(s))
        return m, p.sum(dim=-1), torch.einsum("bhqt,bhtd->bhqd", p, vf)

    # the resident prefix: before this chunk's write the pool holds
    # exactly positions [0, start) of the request, which every local
    # query sees (a scaled pool dequantized, identically on every rank)
    tables = block_tables[None]
    k_pool, v_pool = _gather_kv(k_cache, v_cache, kv_scales, tables,
                                block_size=block_size)
    pool_mask = (torch.arange(k_pool.shape[2], device=dev)
                 < start)[None, :].expand(pl, -1)
    m, l, acc = contrib(k_pool, v_pool, pool_mask)

    kv = torch.stack([k, v])
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    for step in range(sp):
        src = (idx - step) % sp
        k_pos = start + src * pl + torch.arange(pl, device=dev)
        mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < t0)
        m, l, acc = _online_merge(m, l, acc, *contrib(kv[0], kv[1], mask))
        if step < sp - 1:
            kv = cc.ppermute(kv, sp_axis, perm)
    o = (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)

    # the chunk's K/V in rank (= sequence) order for the pool write;
    # positions are start + arange(P) by construction
    kv_full = cc.all_gather(torch.stack([k[0], v[0]]), sp_axis,
                            gather_dim=2)                 # [2, Hkv, P, Dh]
    positions = start + torch.arange(pl * sp, dtype=torch.int32,
                                     device=dev)
    if kv_scales is None:
        paged_prefill_update(k_cache, v_cache, kv_full[0], kv_full[1],
                             positions, t0 - start,
                             block_tables=block_tables,
                             block_size=block_size)
        return o, k_cache, v_cache
    lens = torch.full((1,), t0 - start, dtype=torch.int32, device=dev)
    span = _quant_span(pl * sp, block_size, block_tables.shape[0])
    for cache, sc, vals in ((k_cache, kv_scales[0], kv_full[0]),
                            (v_cache, kv_scales[1], kv_full[1])):
        paged_quant_window_update(policy, cache, sc, vals[None],
                                  positions[None, :], lens,
                                  block_tables=tables,
                                  block_size=block_size, max_blocks=span)
    return (o, k_cache, v_cache, *kv_scales)


def sp_last_hidden(h, start: int, t0: int, *, sp_axis):
    """The chunk's LAST true position's hidden row on every sp rank: ``h``
    [1, Pl, D] is a rank's slice (positions ``start + rank*Pl +
    arange(Pl)``); position ``t0 - 1`` lives on one rank, and one sum of
    that row and the other ranks' zeros hands every rank the [1, 1, D]
    row the logits head reads."""
    from quintnet_tpu_torch.core import collectives as cc

    pl = h.shape[1]
    j = t0 - 1 - start - sp_axis.index * pl
    row = (h[:, j:j + 1] if 0 <= j < pl
           else torch.zeros_like(h[:, :1]))
    return cc.all_reduce(row, sp_axis)


def mha_prefill_paged_sp(p, x, k_cache, v_cache, start: int, t0: int, *,
                         num_heads: int, sp_axis, tp_axis=None,
                         block_tables, block_size: int, kv_scales=None,
                         policy=None):
    """:func:`mha_prefill_paged`'s sequence-parallel sibling: ``x``
    [1, Pl, D] is this sp rank's slice of the chunk's hidden states, the
    attention :func:`ring_paged_prefill`; the output projection is
    position-wise and stays local. Returns (y, k_cache, v_cache[,
    k_scale, v_scale]). Takes no adapters (the engine refuses adapters
    on an sp mesh)."""
    q, k, v = _serve_qkv(p, x, num_heads)
    o, *pools = ring_paged_prefill(
        q, k, v, start, t0, k_cache, v_cache, sp_axis=sp_axis,
        block_tables=block_tables, block_size=block_size,
        kv_scales=kv_scales, policy=policy)
    return _paged_out(p, o, pools, tp_axis)


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
               lora=None, lora_scale=None, kv_scales=None, policy=None):
    """Single-token cached attention.

    Dense (the generation decoders, ``block_tables=None``): ``x``
    [B, 1, D], caches [B, H, T, Dh] (this rank's heads under
    ``tp_axis``, whose proj is row-sharded with one sum over tp), ``pos``
    the host int write position shared by the batch. The token's (k, v)
    are written at ``pos`` in place and the query attends to positions
    ``<= pos`` in plain PyTorch (no kernel, as the JAX package's dense
    branch runs no Pallas kernel). Returns (y, k_cache, v_cache).

    Paged (the serving engine): ``x`` [B, 1, D], flat pool views,
    ``pos`` [B] int32 per-row positions, ``block_tables`` [B, M] int32,
    attended by :func:`paged_attend_decode`; ``tp_axis`` and ``lora``
    (every slot's rows) as :func:`mha_prefill_paged`. Returns (y,
    k_cache, v_cache[, k_scale, v_scale])."""
    q, k, v = _serve_qkv(p, x, num_heads, lora, lora_scale)
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
    o, *pools = paged_attend_decode(
        q, k, v, k_cache, v_cache, pos, block_tables=block_tables,
        block_size=block_size, kv_scales=kv_scales, policy=policy)
    return _paged_out(p, o, pools, tp_axis, lora, lora_scale)

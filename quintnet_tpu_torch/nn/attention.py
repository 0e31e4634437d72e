"""Multi-head attention: the dense causal path and the paged serving path.

Port of ``quintnet_tpu/nn/attention.py`` for one device (no tp/sp).
The dense half (:func:`sdpa`, :func:`mha_apply`) is the training and
eval forward: plain attention, or with ``use_flash`` the
``ops.flash_attention`` dispatcher (the flash kernels on the card);
attention-probability and residual dropout draw from a
``torch.Generator``. The paged half writes a
run's K/V through the block table into the flat pool views and reads
the row back through ``ops.paged_attention.paged_attention`` — the
CUDA kernel on the card, the gathered-view math on the CPU. There is
no ``attn_kernel`` switch.

Pool writes are IN PLACE: ``k_cache``/``v_cache`` are views of the
engine's ``[L, slots, H, Dh]`` pool tensors and are updated where they
lie (the JAX package returns new arrays; the functions here return the
same tensors so the call sites read alike).
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
    _gather_kv, paged_attention, paged_gather)


def mha_init(generator: torch.Generator, dim: int, *, lead=()):
    return {"qkv": linear_init(generator, dim, 3 * dim, lead=lead),
            "proj": linear_init(generator, dim, dim, lead=lead)}


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


def mha_apply(p, x, *, num_heads: int, causal: bool = False,
              use_flash: bool = False, attn_pdrop: float = 0.0,
              resid_pdrop: float = 0.0, generator=None, segment_ids=None):
    """x [B, S, D] -> [B, S, D]: fused qkv, attention (plain, or the
    flash dispatcher with ``use_flash``), proj. With ``generator``
    (training): dropout at ``attn_pdrop`` on the attention
    probabilities and at ``resid_pdrop`` after the projection.
    ``segment_ids`` [B, S] masks attention across packed documents."""
    q, k, v = _split_heads(linear_apply(p["qkv"], x), num_heads)
    attend = flash_attention if use_flash else sdpa
    o = attend(q, k, v, causal=causal, pdrop=attn_pdrop,
               generator=generator, segment_ids=segment_ids)
    y = linear_apply(p["proj"], _merge_heads(o))
    if generator is not None and resid_pdrop > 0.0:
        y = dropout(generator, y, resid_pdrop, deterministic=False)
    return y


# ---------------------------------------------------------------------
# paged pool
# ---------------------------------------------------------------------

def paged_cache_update(k_cache, v_cache, k, v, pos, *, block_tables,
                       block_size: int):
    """Write one token's (k, v) [B, H, Dh] per row at that row's
    position ``pos`` [B] through ``block_tables`` [B, M]. Inactive rows
    carry an all-zero table row and pos 0: their writes land in the
    null block 0, which nobody reads. In place."""
    pos = pos.long()
    blk = block_tables.gather(1, (pos // block_size)[:, None])[:, 0].long()
    idx = blk * block_size + pos % block_size
    k_cache[idx] = k.to(k_cache.dtype)
    v_cache[idx] = v.to(v_cache.dtype)
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
    k_cache[idx] = k.transpose(0, 1).to(k_cache.dtype)
    v_cache[idx] = v.transpose(0, 1).to(v_cache.dtype)
    return k_cache, v_cache


def mha_prefill_paged(p, x, k_cache, v_cache, positions, tail_len, *,
                      num_heads: int, block_tables, block_size: int):
    """Chunked prefill over the paged pool for ONE request: ``x``
    [1, P, D] tail hidden states at ``positions`` (``start +
    arange(P)``, int32). The tail's K/V land in the pool first, then
    each tail query attends causally to the whole row — cached prefix
    plus fresh tail — through the paged-attention kernel. Returns
    (y [1, P, D], k_cache, v_cache)."""
    q, k, v = _split_heads(linear_apply(p["qkv"], x), num_heads)
    paged_prefill_update(k_cache, v_cache, k[0], v[0], positions,
                         tail_len, block_tables=block_tables,
                         block_size=block_size)
    o = paged_attention(q, k_cache, v_cache, block_tables[None],
                        positions[:1], block_size=block_size)
    y = linear_apply(p["proj"], _merge_heads(o))
    return y, k_cache, v_cache


def mha_decode(p, x, k_cache, v_cache, pos, *, num_heads: int,
               block_tables, block_size: int):
    """Single-token paged attention for every row: ``x`` [B, 1, D],
    flat pool views, ``pos`` [B] int32 per-row positions,
    ``block_tables`` [B, M] int32. The token's K/V are written first,
    then read back with the rest of the row. Returns (y, k_cache,
    v_cache). The JAX package's dense single-request branch
    (``block_tables=None``) is not ported (ROADMAP.md, 'Generation')."""
    q, k, v = _split_heads(linear_apply(p["qkv"], x), num_heads)
    paged_cache_update(k_cache, v_cache, k[:, :, 0], v[:, :, 0], pos,
                       block_tables=block_tables, block_size=block_size)
    o = paged_attention(q, k_cache, v_cache, block_tables, pos,
                        block_size=block_size)
    y = linear_apply(p["proj"], _merge_heads(o))
    return y, k_cache, v_cache

"""Ring attention: exact attention over a sequence-sharded ``sp`` axis.

Port of ``quintnet_tpu/ops/ring_attention.py``. The sequence dim of
Q/K/V is sharded over ``sp`` (rank i holds positions ``[i S/sp, (i + 1)
S/sp)``). Each rank keeps running (max, denominator, numerator)
accumulators for its own queries while the K/V chunks travel around the
ring (``core/collectives.ppermute_shift``); after sp steps every query
has seen every key once. Peak memory is O(S/sp) a rank.

Causal masking is at chunk granularity: a chunk from an earlier rank is
fully visible, the rank's own chunk is diagonal-masked, a later rank's
contributes nothing. :func:`zigzag_ring_attention` balances that work:
each rank owns chunk i and its mirror 2 sp - 1 - i of 2 sp, so every
rank computes the same number of useful chunk pairs at every step.

Both are plain attention per chunk pair (``torch.einsum`` in f32), as
the JAX package's ``_chunk_attention`` is plain XLA: no flash kernel
runs here. Where the JAX package keeps one SPMD program (masked chunks
computed and thrown away, ``where`` selecting between pairs), each rank
here decides in Python which pairs it computes; it still enters every
shift and permutation in the same order as every other rank, and a
received chunk it has no use for is tied into its output
(``core/collectives.tie``), so the shift's backward runs on every rank.

The running max is a stabiliser the result does not depend on, so it
carries no gradient (JAX differentiates through it, to the same
result). Dropout (``pdrop`` with a ``torch.Generator``, training only)
is drawn for each (step, chunk pair) from the rank's generator, in the
fixed order of the steps and pairs; the ranks' generators are seeded
apart (``parallel/train_step.device_dropout_seed`` folds the sp
coordinate), so every (query, key) pair draws its mask once. JAX's key
stream cannot be reproduced in torch.
"""

from __future__ import annotations

import math

import torch

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.nn.layers import dropout

NEG_INF = float("-inf")


def _chunk_attention(q, k, v, *, mode: int, scale: float, pdrop: float = 0.0,
                     generator=None, seg_q=None, seg_k=None):
    """One (local queries x one K/V chunk) step. q [B, H, Sq, D], k/v
    [B, H, Sk, D]; ``mode`` 0 = fully visible, 1 = causal diagonal.
    Returns (row max [B, H, Sq], probability sum [B, H, Sq], weighted V
    [B, H, Sq, D]) in f32, the max without gradient. ``seg_q`` [B, Sq] /
    ``seg_k`` [B, Sk]: GLOBAL packed-segment ids; cross-segment pairs
    are masked (a row whose whole chunk is foreign gets max -inf, sum 0).
    With ``generator`` the numerator drops probabilities at ``pdrop``
    (scaled 1 / keep) while the sum keeps them all: dropout after the
    softmax."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, sk = scores.shape[-2:]
    mask = None
    if mode == 1:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril()
    elif mode != 0:
        raise ValueError(f"chunk mode {mode}: 0 (full) or 1 (diagonal)")
    if seg_q is not None:
        same = seg_q[:, None, :, None] == seg_k[:, None, None, :]
        mask = same if mask is None else mask & same
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m_raw = scores.detach().amax(dim=-1)   # -inf where a row is masked
    m_safe = torch.where(torch.isfinite(m_raw), m_raw,
                         torch.zeros_like(m_raw))
    p = torch.exp(scores - m_safe[..., None])
    l = p.sum(dim=-1)
    if generator is not None and pdrop > 0.0:
        p = dropout(generator, p, pdrop, deterministic=False)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m_raw, l, o


def _merge(m, l, acc, m_new, l_new, o_new):
    """Fold one chunk's (max, probability sum, weighted V) into the
    running accumulators. Identity element: (-inf, 0, 0). The rescale
    factors use a finite base, so a row that has seen no visible key yet
    never computes ``exp(-inf - -inf)``."""
    m_tot = torch.maximum(m, m_new)
    zero = torch.zeros_like(m_tot)
    m_base = torch.where(torch.isfinite(m_tot), m_tot, zero)

    def factor(mx):
        c = torch.exp(torch.where(torch.isfinite(mx), mx - m_base,
                                  torch.full_like(mx, NEG_INF)))
        return torch.where(torch.isfinite(c), c, zero)

    c_old, c_new = factor(m), factor(m_new)
    return (m_tot, l * c_old + l_new * c_new,
            acc * c_old[..., None] + o_new * c_new[..., None])


def _identity(b, h, s, d, device):
    return (torch.full((b, h, s), NEG_INF, device=device),
            torch.zeros((b, h, s), device=device),
            torch.zeros((b, h, s, d), device=device))


def _finish(state, dtype):
    _, l, acc = state
    return (acc / l.clamp_min(1e-30)[..., None]).to(dtype)


def ring_attention(q, k, v, *, axis, causal: bool = False,
                   pdrop: float = 0.0, generator=None, segment_ids=None,
                   mesh=None):
    """[B, H, S_local, D] attention over the sequence sharded on ``axis``
    (a :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`, or a name with
    ``mesh``): equal to attention over the gathered sequence.
    ``segment_ids`` [B, S_local]: this rank's slice of the GLOBAL
    packed-segment ids (``models/gpt2.segment_ids_from_input(sp_axis=)``
    derives it); they travel around the ring with their K/V. K and V
    travel as one stacked tensor: one shift a step (sp - 1 in all; the
    JAX scan's last rotation, whose result nobody reads, is not made)."""
    ax = cc.resolve_axis(axis, mesh)
    sp, idx = ax.size, ax.index
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    seg_local = (None if segment_ids is None
                 else segment_ids.to(torch.int32))
    state = _identity(b, h, s, d, q.device)
    kv, seg = torch.stack([k, v]), seg_local
    used = True
    for step in range(sp):
        if step:
            # rank i sends to i + 1: now holding the chunk of rank idx - step
            kv = cc.ppermute_shift(kv, ax, shift=1)
            if seg is not None:
                seg = cc.ppermute_shift(seg, ax, shift=1)
        src = (idx - step) % sp
        used = not causal or src <= idx
        if used:
            state = _merge(*state, *_chunk_attention(
                q, kv[0], kv[1], mode=int(causal and src == idx),
                scale=scale, pdrop=pdrop, generator=generator,
                seg_q=seg_local, seg_k=seg))
    out = _finish(state, q.dtype)
    return out if used else cc.tie(out, kv)


def zigzag_ring_attention(q, k, v, *, axis, causal: bool = True,
                          pdrop: float = 0.0, generator=None,
                          segment_ids=None, mesh=None):
    """Load-balanced causal ring attention over ``axis``, with the
    ordinary CONTIGUOUS sequence sharding in and out (rank i holds global
    chunks 2i and 2i + 1 of 2 sp). Inside, two permutations each way
    relayout to the zigzag pair (chunks i and 2 sp - 1 - i, "head" and
    "tail"); the K/V pairs then rotate as in :func:`ring_attention`, and
    at every step each rank computes the tail queries against the
    incoming head chunk (always visible) and exactly one of head-vs-head
    (incoming from an earlier rank) or tail-vs-tail (from a later one);
    step 0 adds the two diagonal blocks. Non-causal calls are plain
    :func:`ring_attention`, already balanced."""
    if not causal:
        return ring_attention(q, k, v, axis=axis, causal=False, pdrop=pdrop,
                              generator=generator, segment_ids=segment_ids,
                              mesh=mesh)
    ax = cc.resolve_axis(axis, mesh)
    sp, idx = ax.size, ax.index
    b, h, s, d = q.shape
    if s % 2:
        raise ValueError(f"zigzag needs an even local sequence, got {s}")
    c = s // 2
    scale = 1.0 / math.sqrt(d)

    # ---- relayout: contiguous -> zigzag --------------------------------
    # global chunk j goes to rank min(j, 2sp-1-j); the even chunks and the
    # odd chunks each form one permutation (i and 2sp-1-i have opposite
    # parity)
    perm0 = [(i, 2 * i if 2 * i < sp else 2 * sp - 1 - 2 * i)
             for i in range(sp)]
    perm1 = [(i, 2 * i + 1 if 2 * i + 1 < sp else 2 * sp - 2 - 2 * i)
             for i in range(sp)]
    t = torch.stack([q, k, v])                      # [3, B, H, 2c, D]
    ev = cc.ppermute(t[..., :c, :], ax, perm0)      # an even global chunk
    od = cc.ppermute(t[..., c:, :], ax, perm1)      # an odd global chunk
    even = idx % 2 == 0
    head, tail = (ev, od) if even else (od, ev)     # chunks idx, 2sp-1-idx
    q_lo, q_hi = head[0], tail[0]
    if segment_ids is not None:
        sg = segment_ids.to(torch.int32)
        ev_s = cc.ppermute(sg[:, :c].contiguous(), ax, perm0)
        od_s = cc.ppermute(sg[:, c:].contiguous(), ax, perm1)
        s_lo, s_hi = (ev_s, od_s) if even else (od_s, ev_s)
    else:
        s_lo = s_hi = None

    def attend(state, qq, kk, vv, mode, sq, sk):
        return _merge(*state, *_chunk_attention(
            qq, kk, vv, mode=mode, scale=scale, pdrop=pdrop,
            generator=generator, seg_q=sq, seg_k=sk))

    # ---- step 0: the local chunks ----------------------------------------
    lo = attend(_identity(b, h, c, d, q.device), q_lo, head[1], head[2], 1,
                s_lo, s_lo)
    hi = attend(_identity(b, h, c, d, q.device), q_hi, tail[1], tail[2], 1,
                s_hi, s_hi)
    hi = attend(hi, q_hi, head[1], head[2], 0, s_hi, s_lo)

    # ---- steps 1..sp-1: the K/V pairs rotate -----------------------------
    kv = torch.stack([head[1], head[2], tail[1], tail[2]])
    sg_pair = None if s_lo is None else torch.stack([s_lo, s_hi])
    for step in range(1, sp):
        kv = cc.ppermute_shift(kv, ax, shift=1)
        if sg_pair is not None:
            sg_pair = cc.ppermute_shift(sg_pair, ax, shift=1)
        s_lo_in, s_hi_in = ((None, None) if sg_pair is None
                            else (sg_pair[0], sg_pair[1]))
        # the incoming pair comes from rank idx - step: its head chunk j <=
        # sp - 1 < 2sp-1-idx is visible to the tail queries, always
        hi = attend(hi, q_hi, kv[0], kv[1], 0, s_hi, s_lo_in)
        if step <= idx:      # j < idx: head-vs-head is fully visible
            lo = attend(lo, q_lo, kv[0], kv[1], 0, s_lo, s_lo_in)
        else:                # j > idx: tail-vs-tail is fully visible
            hi = attend(hi, q_hi, kv[2], kv[3], 0, s_hi, s_hi_in)

    out_lo, out_hi = _finish(lo, q.dtype), _finish(hi, q.dtype)

    # ---- relayout back: zigzag -> contiguous -----------------------------
    inv0 = [(dst, src) for src, dst in perm0]
    inv1 = [(dst, src) for src, dst in perm1]
    send_even, send_odd = (out_lo, out_hi) if even else (out_hi, out_lo)
    slot0 = cc.ppermute(send_even, ax, inv0)        # chunk 2i
    slot1 = cc.ppermute(send_odd, ax, inv1)         # chunk 2i + 1
    return torch.cat([slot0, slot1], dim=2)

"""Long-context serving: the host side of chunked prefill.

Port of the chunked half of ``quintnet_tpu/serve/longctx.py``
(``ChunkState``, ``plan_chunks``); its sequence-parallel half
(``validate_sp_buckets`` and the sp prefill) is not ported (ROADMAP.md
§1, item 7).

With ``ServeEngine(chunked_prefill=True)`` a prompt longer than the
largest prefill bucket is admitted WHOLE (its block table allocated up
front, so the ceiling is pool capacity, not the bucket ladder) and fed
through the same bucket-width prefill calls across engine steps, each
chunk at its offset like a prefix-cache tail, at most
``prefill_chunk_budget`` prompt tokens a step (Sarathi-Serve): the
decode step of the slots already generating runs every step, so their
streams keep a token a step while a long document prefills. Each
chunk's attention reads the pool the earlier chunks wrote, so the
output is a single-shot prefill's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass
class ChunkState:
    """Progress of one slot's chunked prefill. ``next``: the first
    position whose K/V is not in the pool yet (from the admission plan's
    cached tokens); ``t0``: the prefill's end (``prompt + generated``),
    after whose last chunk the first new token is drawn.
    ``cow_src``/``cow_len``: the admission plan's copy-on-write, for the
    first chunk; ``cow_pinned``: the copy's source still holds its
    admission pin (released once, after the first chunk or when the slot
    is cleared before one ran)."""

    next: int
    t0: int
    cow_src: Optional[int] = None
    cow_len: int = 0
    cow_pinned: bool = False

    @property
    def remaining(self) -> int:
        return self.t0 - self.next

    @property
    def done(self) -> bool:
        return self.next >= self.t0


def plan_chunks(tail_len: int, *, buckets: Sequence[int],
                budget: int) -> List[Tuple[int, int]]:
    """A ``tail_len``-token prefill as ``[(offset, length), ...]`` chunks
    of at most ``min(budget, buckets[-1])`` tokens (each in the smallest
    bucket that holds it). A planning helper: the engine feeds chunks
    step by step under its per-step budget."""
    if tail_len < 0:
        raise ValueError(f"tail_len must be >= 0; got {tail_len}")
    if budget < 1:
        raise ValueError(f"budget must be >= 1; got {budget}")
    cap = min(int(budget), int(buckets[-1]))
    out: List[Tuple[int, int]] = []
    off = 0
    while off < tail_len:
        n = min(cap, tail_len - off)
        out.append((off, n))
        off += n
    return out

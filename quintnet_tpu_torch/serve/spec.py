"""Speculative decoding: n-gram self-drafting and the config of the
batched verify step.

Port of ``quintnet_tpu/serve/spec.py`` (pure numpy, copied: the port
imports nothing of the JAX package). The engine (``serve/engine.py``)
asks :class:`NgramDrafter` for each decoding slot's continuation of its
own prompt + generated history, scores every slot's last token + draft
in ONE verify forward through the paged attention kernel
(``families.verify``), and commits the longest prefix of the draft that
matches what the model produces there, plus one bonus token. Draft K/V
lands in tentative pool blocks (``KVPool.tentative_acquire``) that are
committed or rolled back within the step.

The committed stream is the plain decode stream, sampled too: the
candidate at run position j of a slot is drawn at the port's chain
counter ``len(generated) + j`` (``models/gpt2_generate.sample_logits``),
exactly the counter plain decoding would draw that token at, and a draft
is accepted only where it equals that draw; a rejected draft draws
nothing that a committed token uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from quintnet_tpu_torch.analysis.specs import verify_buckets as _buckets

_EMPTY = np.zeros((0,), np.int32)


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs of ``ServeEngine(spec=...)``.

    ``max_draft`` caps the drafted tokens a request a step and is the
    largest verify bucket; ``buckets`` defaults to the ladder
    ``analysis/specs.verify_buckets(max_draft)``. ``min_draft``: a step
    speculates only when some slot drafted at least this many tokens
    (shorter drafts ride along once another slot triggers the step).
    ``ngram_max``/``ngram_min`` bound the suffix n-gram the drafter
    matches on."""

    max_draft: int = 8
    min_draft: int = 2
    ngram_max: int = 3
    ngram_min: int = 1
    buckets: Tuple[int, ...] = field(default=None)

    def __post_init__(self):
        if self.max_draft < 1:
            raise ValueError(f"max_draft must be >= 1; got {self.max_draft}")
        # the default min_draft=2 must not make max_draft=1 (1 draft +
        # the bonus token) unconstructible
        object.__setattr__(self, "min_draft",
                           min(self.min_draft, self.max_draft))
        if self.min_draft < 1:
            raise ValueError(
                f"min_draft must be >= 1; got {self.min_draft}")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max; got "
                f"{self.ngram_min}, {self.ngram_max}")
        buckets = (tuple(sorted(set(int(b) for b in self.buckets)))
                   if self.buckets is not None
                   else _buckets(self.max_draft))
        if not buckets or buckets[0] < 1 or buckets[-1] != self.max_draft:
            raise ValueError(
                f"verify buckets {buckets} must be positive and end at "
                f"max_draft={self.max_draft} (the largest draft must fit)")
        object.__setattr__(self, "buckets", buckets)

    def bucket_for(self, draft_len: int) -> int:
        """Smallest verify bucket holding ``draft_len`` drafted tokens."""
        for b in self.buckets:
            if b >= draft_len:
                return b
        raise AssertionError(
            f"draft {draft_len} exceeds max_draft={self.max_draft} — "
            f"the engine caps proposals before bucketing")


class NgramDrafter:
    """Prompt-lookup self-drafting: propose the continuation of the most
    recent earlier occurrence of the sequence's own suffix.

    For n from ``ngram_max`` down to ``ngram_min``, the last n tokens of
    ``ctx`` are searched for an earlier occurrence; on a hit the sequence
    is taken as periodic with the period that occurrence witnesses, and
    the draft (up to ``max_tokens``) cycles the last period. Stateless
    and host-side: drafts touch no request state and no pool index."""

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg

    def draft(self, ctx: np.ndarray, max_tokens: int) -> np.ndarray:
        cfg = self.cfg
        ctx = np.asarray(ctx, np.int32).reshape(-1)
        T = ctx.size
        max_tokens = min(int(max_tokens), cfg.max_draft)
        if max_tokens < 1 or T < cfg.ngram_min + 1:
            return _EMPTY
        for n in range(min(cfg.ngram_max, T - 1), cfg.ngram_min - 1, -1):
            pattern = ctx[T - n:]
            # windows starting at i <= T-1-n: every match has a following
            # token, and the suffix itself (start T-n) is excluded
            win = np.lib.stride_tricks.sliding_window_view(ctx[:T - 1], n)
            hits = np.nonzero((win == pattern).all(axis=1))[0]
            if hits.size:
                # the most recent occurrence at i gives the period
                # p = (T - n) - i: draft[j] = ctx[T - p + (j mod p)]
                p = T - n - int(hits[-1])
                idx = T - p + (np.arange(max_tokens) % p)
                return ctx[idx].astype(np.int32)
        return _EMPTY

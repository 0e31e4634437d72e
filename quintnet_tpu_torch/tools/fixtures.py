"""Deterministic fixtures shared by the evaluation tools.

Port of ``quintnet_tpu/tools/fixtures.py``: the token batch is a seeded
``default_rng`` draw, not global numpy state, so two tools (or the two
packages) score the same batch.
"""

from __future__ import annotations

import numpy as np


def random_token_ids(vocab_size: int, batch: int, seq: int, *,
                     seed: int = 0) -> np.ndarray:
    """Deterministic [batch, seq] int32 token ids in [0, vocab_size)."""
    return np.random.default_rng(seed).integers(
        0, vocab_size, (batch, seq), dtype=np.int32)

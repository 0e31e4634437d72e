"""Shape ladders the serving engine derives its programs from.

The port's own copy of ``quintnet_tpu/analysis/specs.py::prefill_buckets``
(the JAX module is pure Python, but importing anything under
``quintnet_tpu`` pulls in jax).
"""

from __future__ import annotations

from typing import Tuple


def prefill_buckets(prefill_len: int, *, floor: int = 16) -> Tuple[int, ...]:
    """The padded-length ladder for bucketed prefill: powers of two from
    ``floor`` up to (and capped at) ``prefill_len``. A prompt tail of
    length t runs in the smallest bucket >= t."""
    if prefill_len < 1:
        raise ValueError(f"prefill_len must be >= 1; got {prefill_len}")
    out = []
    b = floor
    while b < prefill_len:
        out.append(b)
        b *= 2
    out.append(prefill_len)
    return tuple(out)

"""Shape ladders the serving engine derives its programs from.

The port's own copies of ``quintnet_tpu/analysis/specs.py``'s
``prefill_buckets``, ``verify_buckets``, ``kv_layout_policies``,
``weight_layout_policies`` and ``lora_rank_buckets`` (the JAX module
is pure Python, but importing anything under ``quintnet_tpu`` pulls in
jax).
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


def verify_buckets(max_draft: int, *, floor: int = 2) -> Tuple[int, ...]:
    """The draft-length ladder of the speculative verify step
    (``serve/spec.py``): powers of two from ``floor`` up to (and capped
    at) ``max_draft``; ``max_draft=8`` gives ``(2, 4, 8)``. A step whose
    longest draft is k runs at the smallest bucket >= k, its width the
    bucket + 1 tokens a row (the slot's last token rides in front)."""
    if max_draft < 1:
        raise ValueError(f"max_draft must be >= 1; got {max_draft}")
    out = []
    b = floor
    while b < max_draft:
        out.append(b)
        b *= 2
    out.append(max_draft)
    return tuple(out)


def kv_layout_policies() -> Tuple[str, ...]:
    """The KV-pool layout-policy ladder (``serve/kv_quant.py``):
    ``f32``/``bf16`` passthrough, ``int8`` with per-block-per-head
    absmax scales, ``fp8`` unscaled float8_e4m3fn passthrough, and the
    ``fake_quant`` identity-scale proof policy."""
    return ("f32", "bf16", "int8", "fp8", "fake_quant")


def weight_layout_policies() -> Tuple[str, ...]:
    """The weight layout-policy ladder (``serve/weight_quant.py``):
    ``f32`` identity, ``bf16`` passthrough narrowing, ``int8``/``fp8``
    with per-output-channel absmax scales, and the ``fake_quant``
    identity-scale proof policy (bit-identical to f32)."""
    return ("f32", "bf16", "int8", "fp8", "fake_quant")


def lora_rank_buckets(max_rank: int, *, floor: int = 4) -> Tuple[int, ...]:
    """The adapter-rank ladder of multi-tenant LoRA serving
    (``serve/adapters.py``): powers of two from ``floor`` up to, and
    capped at, ``max_rank``. A decode step runs at the smallest bucket
    covering the largest bound adapter's rank; prefill and verify run at
    the top bucket."""
    if max_rank < 1:
        raise ValueError(f"max_rank must be >= 1; got {max_rank}")
    out = []
    b = floor
    while b < max_rank:
        out.append(b)
        b *= 2
    out.append(max_rank)
    return tuple(out)

"""KV-pool layout policies: what dtype a paged block is stored in, and
how it gets there.

Port of ``quintnet_tpu/serve/kv_quant.py``. The pool's size bounds how
many requests run at once; a narrower block layout holds more of them
in the same bytes (int8: about 4x the blocks of f32).

- ``f32`` / ``bf16`` — passthrough: the pool tensors carry that dtype,
  every write is a narrowing cast and every read an upcast.
- ``int8`` — int8 storage with per-block, per-head absmax scales
  (``scale[b, h] = max |block b, head h| / 127``) kept in f32 beside
  the pools, one ``[L, num_blocks, H_kv]`` tensor each for k and v.
  A block is written by one request only (shared prefix blocks are
  read-only by copy-on-write), so requantizing on append touches only
  private blocks.
- ``fp8`` — unscaled ``torch.float8_e4m3fn`` storage: the same 1 byte a
  slot as int8 and no scale tensors; writes narrow with a cast, reads
  upcast.
- ``fake_quant`` — the proof policy: f32 storage, scale tensors that
  stay all ones, and every kernel runs the full scaled path
  (dequantize, insert, requantize, scatter) with quantization exactly
  the identity. Its engine is bit-identical to the f32 engine.

The attention entry points (``nn/attention.py``) take the policy as an
argument and call its methods.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class LayoutPolicy:
    """The quantize / dequantize / scale-layout contract of paged KV
    blocks.

    ``scaled`` selects the code path: False is the passthrough
    scatter/gather (no scale tensors), True carries absmax scales
    beside the stored data. ``qmax == 0`` marks the identity
    (fake-quant) policy: no rounding, no clipping, scales pinned at
    1.0. ``dequant(q, None)`` is the plain f32 upcast, which is how the
    unscaled fp8 layout shares the contract."""

    name: str
    store_dtype: Any
    scaled: bool
    qmax: float = 0.0

    def compute_scale(self, x, axes: Tuple[int, ...]):
        """Absmax scale of one quantization group: reduce ``axes`` of
        f32 ``x``. Identity policy: exactly 1.0 everywhere. The 1e-8
        floor keeps an all-zero group's scale finite (its dequant is
        exactly 0.0)."""
        axes = tuple(a % x.dim() for a in axes)
        if self.qmax == 0.0:
            shape = [d for i, d in enumerate(x.shape) if i not in axes]
            return torch.ones(shape, dtype=torch.float32, device=x.device)
        amax = x.float().abs().amax(dim=axes)
        # divide by a tensor: CUDA turns a division by a host scalar into
        # a multiplication by its reciprocal, which can be one ulp off
        return torch.clamp_min(amax / amax.new_full((), self.qmax), 1e-8)

    def quant(self, x, scale=None):
        """f32 data -> stored data. ``scale`` broadcastable to x; None
        (unscaled policies) is the plain narrowing cast. Integer storage
        rounds half to even (``torch.round``, as ``jnp.round``); float
        storage keeps the fraction. ``x / scale``, not
        ``x * (1 / scale)``: the quotient is what the reference
        computes."""
        if scale is None or self.qmax == 0.0:
            return x.to(self.store_dtype)
        q = x.float() / scale
        if not self.store_dtype.is_floating_point:
            q = torch.round(q)
        return q.clamp(-self.qmax, self.qmax).to(self.store_dtype)

    def dequant(self, q, scale=None):
        """Stored data -> f32. With the identity policy this is
        ``x * 1.0``, bit-exact for every finite f32."""
        if scale is None:
            return q.float()
        return q.float() * scale


@dataclass(frozen=True)
class KVLayoutPolicy(LayoutPolicy):
    """The KV face of :class:`LayoutPolicy`, plus the pool capacity
    equation."""

    def bytes_per_block(self, *, n_layers: int, n_kv_heads: int,
                        head_dim: int, block_size: int) -> int:
        """Device bytes one pool block costs: k + v slot data across
        layers, plus the two f32 per-block-per-head scale rows when
        scaled."""
        item = torch.empty((), dtype=self.store_dtype).element_size()
        data = 2 * n_layers * block_size * n_kv_heads * head_dim * item
        scale = 2 * n_layers * n_kv_heads * 4 if self.scaled else 0
        return data + scale


_POLICIES = {
    "f32": KVLayoutPolicy("f32", torch.float32, scaled=False),
    "bf16": KVLayoutPolicy("bf16", torch.bfloat16, scaled=False),
    "int8": KVLayoutPolicy("int8", torch.int8, scaled=True, qmax=127.0),
    "fp8": KVLayoutPolicy("fp8", torch.float8_e4m3fn, scaled=False),
    "fake_quant": KVLayoutPolicy("fake_quant", torch.float32, scaled=True,
                                 qmax=0.0),
}


def policy_names() -> Tuple[str, ...]:
    """The policy ladder (``analysis/specs.kv_layout_policies``)."""
    return tuple(_POLICIES)


def make_policy(kv_dtype) -> KVLayoutPolicy:
    """``None`` / a policy / a name / a torch dtype -> the policy. A raw
    dtype maps to its passthrough policy."""
    if kv_dtype is None:
        return _POLICIES["f32"]
    if isinstance(kv_dtype, KVLayoutPolicy):
        return kv_dtype
    if isinstance(kv_dtype, str):
        if kv_dtype not in _POLICIES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected one "
                             f"of {policy_names()}")
        return _POLICIES[kv_dtype]
    for name in ("f32", "bf16", "fp8"):
        if kv_dtype == _POLICIES[name].store_dtype:
            return _POLICIES[name]
    raise ValueError(f"no passthrough policy for dtype {kv_dtype}; use one "
                     f"of {policy_names()}")


# ---------------------------------------------------------------------
# quality gates
# ---------------------------------------------------------------------

def dequant_roundtrip_error(policy: KVLayoutPolicy, x,
                            axes: Tuple[int, ...] = (-2, -1)):
    """(max |dequant(quant(x)) - x| per group, the group scales). For
    int8 every element's error is at most ``scale / 2``; the identity
    policy's is exactly zero."""
    x = torch.as_tensor(x, dtype=torch.float32)
    sc = policy.compute_scale(x, axes)
    sc_b = sc
    for a in sorted(a % x.dim() for a in axes):
        sc_b = sc_b.unsqueeze(a)
    dq = policy.dequant(policy.quant(x, sc_b), sc_b)
    return (dq - x).abs().amax(dim=tuple(a % x.dim() for a in axes)), sc


def acquire_rows(pool, S: int, P: int):
    """Fresh blocks for ``S`` rows of ``P`` tokens: (block tables
    [S, blocks] int32, the per-row block lists to release). Raises,
    holding nothing, if the pool has too few free blocks."""
    need = pool.blocks_for(P)
    tables = np.zeros((S, need), np.int32)
    held = []
    for s in range(S):
        got = pool.acquire(need)
        if got is None:
            for b in held:
                pool.release(b)
            raise ValueError(
                f"pool too small to score {S} rows of {P} tokens "
                f"({need} blocks each, {pool.num_available} available)")
        tables[s] = got
        held.append(got)
    return tables, held


def paged_eval_nll(family, params, pool, rows) -> float:
    """Mean next-token NLL of ``rows`` [S, P] scored THROUGH the paged
    pool: each row's tokens are written into freshly acquired blocks
    and teacher-forced in ONE ``family.verify`` call, so the number
    measures the model as the quantized pool serves it. ``exp(nll)`` is
    the perplexity. The blocks are released before returning."""
    rows = np.asarray(rows, np.int32)
    S, P = rows.shape
    tables, held = acquire_rows(pool, S, P)
    dev = pool.k.device
    caches = pool.caches()
    kv_scales = caches[2:] if pool.policy.scaled else None
    with torch.no_grad():
        out = family.verify(
            params, caches[0], caches[1],
            torch.from_numpy(rows).to(dev),
            torch.zeros((S,), dtype=torch.int32, device=dev),
            torch.full((S,), P, dtype=torch.int32, device=dev),
            torch.from_numpy(tables).to(dev), pool.block_size,
            kv_scales=kv_scales, policy=pool.policy)
    logits = out[0]                                   # [S, P, V]
    pool.update(*out[1:])
    for b in held:
        pool.release(b)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = torch.from_numpy(rows[:, 1:].astype(np.int64)).to(dev)
    picked = logp.gather(-1, tgt[..., None])[..., 0]
    return float(-picked.mean())

"""KV-pool layout policies: what dtype a paged block is stored in.

Port of ``quintnet_tpu/serve/kv_quant.py``, passthrough policies only:
``f32`` and ``bf16`` pools simply carry that dtype, every write is a
narrowing cast and every read an upcast in the attention math. The
scaled policies (``int8``, ``fake_quant``) and the unscaled ``fp8``
pool are not ported; naming one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

_NOT_PORTED = ("int8", "fp8", "fake_quant")


@dataclass(frozen=True)
class LayoutPolicy:
    """How stored data is laid out. ``scaled`` is False for every
    ported policy: no scale arrays ride beside the data."""

    name: str
    store_dtype: Any
    scaled: bool


@dataclass(frozen=True)
class KVLayoutPolicy(LayoutPolicy):
    """The KV face of :class:`LayoutPolicy`, plus the pool capacity
    equation."""

    def bytes_per_block(self, *, n_layers: int, n_kv_heads: int,
                        head_dim: int, block_size: int) -> int:
        """Device bytes one pool block costs: k + v slot data across
        layers."""
        item = torch.empty((), dtype=self.store_dtype).element_size()
        return 2 * n_layers * block_size * n_kv_heads * head_dim * item


_POLICIES = {
    "f32": KVLayoutPolicy("f32", torch.float32, scaled=False),
    "bf16": KVLayoutPolicy("bf16", torch.bfloat16, scaled=False),
}


def policy_names() -> Tuple[str, ...]:
    """The ported policy ladder."""
    return tuple(_POLICIES)


def make_policy(kv_dtype) -> KVLayoutPolicy:
    """``None`` / a policy / a name / a torch dtype -> the policy."""
    if kv_dtype is None:
        return _POLICIES["f32"]
    if isinstance(kv_dtype, KVLayoutPolicy):
        return kv_dtype
    if isinstance(kv_dtype, str):
        if kv_dtype in _NOT_PORTED:
            raise NotImplementedError(
                f"kv_dtype {kv_dtype!r} is not ported yet (ROADMAP.md, "
                f"'TPU kernels to port': K4 scaled/override variant + "
                f"paged_quant_window_update); ported: {policy_names()}")
        if kv_dtype not in _POLICIES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected one "
                             f"of {policy_names()}")
        return _POLICIES[kv_dtype]
    for pol in _POLICIES.values():
        if kv_dtype == pol.store_dtype:
            return pol
    raise ValueError(f"no passthrough policy for dtype {kv_dtype}; use one "
                     f"of {policy_names()}")

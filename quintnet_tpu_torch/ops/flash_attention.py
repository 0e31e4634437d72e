"""Flash attention: the dispatch surface and its plain blockwise twin.

Port of ``quintnet_tpu/ops/flash_attention.py``. :func:`flash_attention`
is what ``nn/attention.mha_apply(use_flash=True)`` calls:

- without attention dropout it runs :class:`~quintnet_tpu_torch.ops.
  flash_kernels.FlashAttentionFunction` for every sequence length: the
  K1-K3 CUDA kernels for CUDA tensors, their plain versions for CPU
  tensors. The JAX dispatcher's TPU rule (S a multiple of 512, S >=
  4096 — a v5e crossover and a v5e MXU tile choice) says nothing about
  the H100 and is not carried over; the kernels take any S.
- a call on CUDA tensors outside the kernels' domain (a head dim not in
  ``HEAD_DIMS``, a dtype other than float32 and bfloat16 (float16),
  B x H > 65,535:
  :func:`~quintnet_tpu_torch.ops.flash_kernels.kernels_take`) runs
  :func:`blockwise_attention` under autograd, as the JAX dispatcher
  sends every call its Pallas kernel cannot take to its blockwise path
  (``quintnet_tpu/ops/flash_attention.py:177-192``). Each such call
  counts one in ``flash_attention.routed``. This is a rule on shapes and
  dtypes, not a fallback: a call inside the domain launches the kernels
  or raises.
- with attention dropout (``pdrop > 0`` and a ``generator``) it runs
  :func:`blockwise_attention` under autograd, as the JAX dispatcher
  does: the kernels carry no random numbers, so a training run with
  ``attn_pdrop > 0`` reaches no kernel.
"""

from __future__ import annotations

import math

import torch

from quintnet_tpu_torch.ops.flash_kernels import (FlashAttentionFunction,
                                                  kernels_take, visible_pairs)


def blockwise_attention(q, k, v, *, causal: bool, block_k: int = 128,
                        pdrop: float = 0.0, generator=None,
                        segment_ids=None):
    """Exact attention [B, H, S, D] -> [B, H, S, D] as an online softmax
    over key blocks of ``block_k`` (any S; the last block may be
    ragged), in plain torch: f32 inside whatever the input dtype, the
    output in q's dtype (the JAX twin's policy). ``segment_ids`` [B, S]:
    pairs from different packed documents are masked. Masked scores are
    ``-inf`` with the JAX twin's guards for rows that have seen no
    visible key yet.

    ``pdrop``/``generator``: dropout on the attention probabilities with
    sdpa's drop-after-softmax semantics: the normaliser ``l`` sums the
    undropped probabilities while the numerator sums the dropped ones
    scaled by ``1 / (1 - pdrop)``."""
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    m = torch.full((B, H, S), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    use_drop = generator is not None and pdrop > 0.0
    for k0 in range(0, S, block_k):
        cols = torch.arange(k0, min(k0 + block_k, S), device=q.device)
        s = torch.einsum("bhsd,bhtd->bhst", qf,
                         k[:, :, k0:k0 + block_k].float()) * scale
        vis = visible_pairs(S, causal, segment_ids, q.device, cols=cols)
        s = torch.where(vis, s, torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.where(vis, torch.exp(s - m_safe[..., None]),
                        torch.zeros_like(s))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        if use_drop:
            keep = torch.rand(p.shape, generator=generator,
                              device=p.device) < 1.0 - pdrop
            p = torch.where(keep, p / (1.0 - pdrop), torch.zeros_like(p))
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", p, v[:, :, k0:k0 + block_k].float())
        m = m_safe
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _on_card(q) -> bool:
    return q.device.type == "cuda"


def flash_attention(q, k, v, *, causal: bool = False, pdrop: float = 0.0,
                    generator=None, segment_ids=None):
    """[B, H, S, D] fused attention: the flash kernels (through
    :class:`FlashAttentionFunction`), or :func:`blockwise_attention` when
    attention dropout is asked for (``pdrop > 0`` with a ``generator``)
    or, on the card, when the kernels cannot take the call (counted in
    ``flash_attention.routed``). ``segment_ids`` [B, S] masks attention
    across packed documents on every path."""
    if generator is not None and pdrop > 0.0:
        return blockwise_attention(q, k, v, causal=causal, pdrop=pdrop,
                                   generator=generator,
                                   segment_ids=segment_ids)
    if _on_card(q) and not kernels_take(q):
        flash_attention.routed += 1
        return blockwise_attention(q, k, v, causal=causal,
                                   segment_ids=segment_ids)
    seg = (None if segment_ids is None
           else segment_ids.to(torch.int32).contiguous())
    return FlashAttentionFunction.apply(q.contiguous(), k.contiguous(),
                                        v.contiguous(), seg, causal)


flash_attention.routed = 0

"""Token embedding, logits and next-token selection for GPT-2 serving.

Port of the pieces of ``quintnet_tpu/models/gpt2_generate.py`` the
serving families use. The dense KV-cache decoder (``gpt2_generate``,
beam search) is not ported yet (ROADMAP.md, 'Generation').

:func:`sample_logits` carries the temperature / top-k / top-p filters
with an explicit ``torch.Generator``. The serving engine decodes
greedily only: torch cannot reproduce the JAX engine's per-request key
chains, and the port's own counter-based chain is still to design
(ROADMAP.md, 'per-request RNG chain for sampled serving').
"""

from __future__ import annotations

from typing import Optional

import torch

from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_logits


def sample_logits(logits, generator: Optional[torch.Generator] = None, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Next tokens from [B, V] logits: temperature, then top-k, then
    nucleus (top-p). ``temperature <= 0`` is greedy argmax regardless of
    the filters (first index on ties, as ``jnp.argmax``). Sampling draws
    from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    neg = torch.finfo(logits.dtype).min
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg)
    if 0.0 < top_p < 1.0:
        srt, idx = torch.sort(logits, dim=-1, descending=True)
        probs = torch.softmax(srt, dim=-1)
        # keep the first token whose preceding mass crosses top_p; the
        # few-ulp slack matches the JAX package's boundary rule
        tol = 16 * torch.finfo(probs.dtype).eps
        drop = torch.cumsum(probs, dim=-1) - probs > top_p - tol
        srt = srt.masked_fill(drop, neg)
        logits = torch.empty_like(srt).scatter_(-1, idx, srt)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def _embed_tok(emb, ids, cfg: GPT2Config):
    """Token embedding (the vocab-parallel branch is not ported)."""
    del cfg
    return emb["wte"][ids]


def _logits(params, h, cfg: GPT2Config):
    """Full-vocab f32 logits."""
    return gpt2_logits(params, h, cfg)

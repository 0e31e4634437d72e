"""GPT-2 (124M "base" through XL): config, init and the eval forward.

Port of ``quintnet_tpu/models/gpt2.py`` for one device. Parameters keep
the JAX pytree layout::

    {"embedding": {"wte": [V, D], "wpe": [T, D]},
     "blocks": {"ln1", "attn": {"qkv", "proj"}, "ln2", "mlp": {"fc",
                "proj"}}      # every leaf stacked [L, ...]
     "head": {"ln_f": {"scale", "bias"}}}

with linear weights ``[in, out]`` and the lm head tied to ``wte``.
:func:`gpt2_apply` is the dense causal forward (no dropout) — the
oracle the paged serving path is held to on the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from quintnet_tpu_torch.nn.attention import mha_init
from quintnet_tpu_torch.nn.layers import (layer_norm_apply,
                                          layer_norm_init, linear_init)
from quintnet_tpu_torch.nn.transformer import block_apply, layer_params


@dataclass(frozen=True)
class GPT2Config:
    """Sizes follow the reference presets. The port serves dense,
    unpadded-vocab configs; the JAX config's training and parallelism
    fields are accepted by :meth:`from_dict` and ignored there."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    # MoE (0 = dense) and vocab padding: carried so a JAX config maps
    # over field for field; the port rejects non-default values where
    # it serves (serve/families.py)
    n_experts: int = 0
    padded_vocab_size: Optional[int] = None

    @property
    def mlp_hidden(self) -> int:
        return 4 * self.n_embd

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def table_vocab_size(self) -> int:
        return self.padded_vocab_size or self.vocab_size

    @staticmethod
    def base() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def medium() -> "GPT2Config":
        return GPT2Config(n_embd=1024, n_layer=24, n_head=16)

    @staticmethod
    def large() -> "GPT2Config":
        return GPT2Config(n_embd=1280, n_layer=36, n_head=20)

    @staticmethod
    def xl() -> "GPT2Config":
        return GPT2Config(n_embd=1600, n_layer=48, n_head=25)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        """Test-scale config (same sizes as the JAX package's)."""
        d = dict(vocab_size=128, n_positions=64, n_embd=32, n_layer=4,
                 n_head=4)
        d.update(kw)
        return GPT2Config(**d)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GPT2Config":
        names = {f.name for f in dataclasses.fields(GPT2Config)}
        return GPT2Config(**{k: v for k, v in d.items() if k in names})


def gpt2_init(generator: torch.Generator, cfg: GPT2Config):
    """Random f32 GPT-2 params on ``generator.device``, drawn like the JAX
    package's ``gpt2_init`` (wte ~ N(0, 0.02), wpe ~ N(0, 0.01),
    Kaiming-uniform linears, unit LayerNorms) but from torch's RNG — the
    two never give the same numbers, so parity goes through
    :mod:`quintnet_tpu_torch.bridge`."""
    dev = generator.device
    L, D = cfg.n_layer, cfg.n_embd

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    blocks = {
        "ln1": layer_norm_init(D, lead=(L,), device=dev),
        "attn": mha_init(generator, D, lead=(L,)),
        "ln2": layer_norm_init(D, lead=(L,), device=dev),
        "mlp": {"fc": linear_init(generator, D, cfg.mlp_hidden, lead=(L,)),
                "proj": linear_init(generator, cfg.mlp_hidden, D,
                                    lead=(L,))},
    }
    return {
        "embedding": {"wte": normal((cfg.table_vocab_size, D), 0.02),
                      "wpe": normal((cfg.n_positions, D), 0.01)},
        "blocks": blocks,
        "head": {"ln_f": layer_norm_init(D, device=dev)},
    }


def gpt2_embed(params, input_ids):
    """[B, T] ids -> token + position embeddings [B, T, D]."""
    emb = params["embedding"]
    T = input_ids.shape[-1]
    return emb["wte"][input_ids] + emb["wpe"][:T][None]


def mask_padded_cols(logits, cfg: GPT2Config):
    """``finfo.min`` on the vocab-padding columns of full-width logits."""
    col = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= cfg.vocab_size,
                              torch.finfo(torch.float32).min)


def gpt2_logits(params, h, cfg: GPT2Config):
    """ln_f, then the tied head: logits = ln_f(h) @ wte^T, in f32."""
    h = layer_norm_apply(params["head"]["ln_f"], h,
                         eps=cfg.layer_norm_epsilon)
    logits = (h @ params["embedding"]["wte"].T).float()
    if (cfg.padded_vocab_size
            and params["embedding"]["wte"].shape[0] == cfg.table_vocab_size):
        logits = mask_padded_cols(logits, cfg)
    return logits


def gpt2_apply(params, input_ids, cfg: GPT2Config):
    """Eval-mode causal forward: [B, T] ids -> [B, T, V] f32 logits."""
    h = gpt2_embed(params, input_ids)
    for layer in range(cfg.n_layer):
        h = block_apply(layer_params(params["blocks"], layer), h,
                        num_heads=cfg.n_head, causal=True)
    return gpt2_logits(params, h, cfg)

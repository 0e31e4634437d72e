"""GPT-2 (124M "base" through XL): config, init, forward and CLM loss.

Port of ``quintnet_tpu/models/gpt2.py`` for one device. Parameters keep
the JAX pytree layout::

    {"embedding": {"wte": [V, D], "wpe": [T, D]},
     "blocks": {"ln1", "attn": {"qkv", "proj"}, "ln2", "mlp": {"fc",
                "proj"}}      # every leaf stacked [L, ...]
     "head": {"ln_f": {"scale", "bias"}}}

with linear weights ``[in, out]`` and the lm head tied to ``wte``.
:func:`gpt2_apply` is the dense causal forward — the oracle the paged
serving path is held to on the card; :func:`gpt2_model_spec` is the
single-device training model (forward, CLM loss, dropout from a
``torch.Generator``, optional flash attention and remat).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from quintnet_tpu_torch.nn.attention import mha_init
from quintnet_tpu_torch.nn.layers import (dropout, gelu, layer_norm_apply,
                                          layer_norm_init, linear_init)
from quintnet_tpu_torch.nn.transformer import stacked_blocks_apply

IGNORE_INDEX = -100  # labels at -100 carry no loss (prompt and padding)


@dataclass(frozen=True)
class GPT2Config:
    """Sizes follow the reference presets. Training fields: ``dropout``
    and the per-site rates (None falls back to ``dropout``),
    ``loss_chunk`` (CLM loss in sequence chunks of this many positions,
    0 = off) and ``segment_eos_id`` (packed-document isolation: a new
    attention segment starts after each such token). :meth:`from_dict`
    keeps every field named here and drops the JAX config's other keys
    (MoE routing, vocab and sequence parallelism)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    dropout: float = 0.0
    embd_pdrop: Optional[float] = None
    attn_pdrop: Optional[float] = None
    resid_pdrop: Optional[float] = None
    loss_chunk: int = 0
    segment_eos_id: Optional[int] = None
    # MoE (0 = dense) and vocab padding: carried so a JAX config maps
    # over field for field; the port rejects MoE where it serves
    # (serve/families.py) and where it trains (gpt2_model_spec)
    n_experts: int = 0
    padded_vocab_size: Optional[int] = None

    @property
    def pdrops(self):
        """(embd, attn, resid) dropout rates with ``dropout`` fallback."""
        d = self.dropout
        return (d if self.embd_pdrop is None else self.embd_pdrop,
                d if self.attn_pdrop is None else self.attn_pdrop,
                d if self.resid_pdrop is None else self.resid_pdrop)

    @property
    def needs_dropout(self) -> bool:
        return any(p > 0.0 for p in self.pdrops)

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


def gpt2_embed(params, input_ids, *, embd_pdrop: float = 0.0,
               generator=None):
    """[B, T] ids -> token + position embeddings [B, T, D]; with
    ``generator``, dropout at ``embd_pdrop`` on the sum."""
    emb = params["embedding"]
    T = input_ids.shape[-1]
    h = emb["wte"][input_ids] + emb["wpe"][:T][None]
    if generator is not None and embd_pdrop > 0.0:
        h = dropout(generator, h, embd_pdrop, deterministic=False)
    return h


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


def segment_ids_from_input(input_ids, cfg: GPT2Config):
    """[B, S] token ids -> [B, S] int32 attention segment ids, or None
    when ``cfg.segment_eos_id`` is unset: the exclusive running count of
    the separator (each EOS closes its own document)."""
    if cfg.segment_eos_id is None:
        return None
    is_eos = (input_ids == cfg.segment_eos_id).to(torch.int32)
    return (torch.cumsum(is_eos, dim=1, dtype=torch.int32) - is_eos)


def gpt2_blocks(params_blocks, h, cfg: GPT2Config, *, remat=False,
                use_flash: bool = False, generator=None, segment_ids=None):
    """The stacked causal blocks; ``generator`` enables training
    dropout."""
    _, attn_p, resid_p = cfg.pdrops
    return stacked_blocks_apply(
        params_blocks, h, num_heads=cfg.n_head, causal=True, act=gelu,
        use_flash=use_flash, remat=remat, attn_pdrop=attn_p,
        resid_pdrop=resid_p, generator=generator, segment_ids=segment_ids)


def gpt2_hidden(params, input_ids, cfg: GPT2Config, *, remat=False,
                use_flash: bool = False, generator=None):
    """embed + blocks -> final hidden states [B, T, D] (the pre-head
    half of :func:`gpt2_forward`; the chunked loss starts from here).
    The JAX twin also returns the MoE aux loss; the port is dense-only."""
    if generator is not None and not cfg.needs_dropout:
        generator = None
    h = gpt2_embed(params, input_ids, embd_pdrop=cfg.pdrops[0],
                   generator=generator)
    return gpt2_blocks(params["blocks"], h, cfg, remat=remat,
                       use_flash=use_flash, generator=generator,
                       segment_ids=segment_ids_from_input(input_ids, cfg))


def gpt2_forward(params, input_ids, cfg: GPT2Config, *, remat=False,
                 use_flash: bool = False, generator=None):
    """-> logits [B, T, V] f32. ``generator``: training dropout (None is
    eval)."""
    return gpt2_logits(params, gpt2_hidden(params, input_ids, cfg,
                                           remat=remat, use_flash=use_flash,
                                           generator=generator), cfg)


def gpt2_apply(params, input_ids, cfg: GPT2Config, *,
               use_flash: bool = False):
    """Eval-mode causal forward: [B, T] ids -> [B, T, V] f32 logits."""
    return gpt2_forward(params, input_ids, cfg, use_flash=use_flash)


def clm_loss(logits, labels):
    """Shifted causal-LM cross entropy with ``IGNORE_INDEX`` masking,
    mean over the valid targets."""
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    nll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                          targets.reshape(-1), ignore_index=IGNORE_INDEX,
                          reduction="sum")
    return nll / (targets != IGNORE_INDEX).sum().clamp_min(1)


def clm_loss_chunked(params, h, labels, cfg: GPT2Config, *, chunk: int):
    """The CLM loss straight from the final hidden states, in sequence
    chunks of ``chunk`` positions: each chunk's [B, chunk, V] logits are
    reduced to a summed NLL under ``torch.utils.checkpoint``, so the full
    [B, S, V] logits never exist and backward recomputes each slab. Same
    math as :func:`clm_loss` up to float reassociation."""
    h = layer_norm_apply(params["head"]["ln_f"], h,
                         eps=cfg.layer_norm_epsilon)
    wte = params["embedding"]["wte"]
    h_pred = h[:, :-1]
    targets = labels[:, 1:].long()
    mask_pad_cols = bool(cfg.padded_vocab_size
                         and wte.shape[0] == cfg.table_vocab_size)

    def body(hc, tc, wte):
        logits = (hc @ wte.T).float()
        if mask_pad_cols:
            logits = mask_padded_cols(logits, cfg)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tc.reshape(-1), ignore_index=IGNORE_INDEX,
                               reduction="sum")

    total = sum(checkpoint(body, h_pred[:, i:i + chunk],
                           targets[:, i:i + chunk], wte, use_reentrant=False)
                for i in range(0, h_pred.shape[1], chunk))
    return total / (targets != IGNORE_INDEX).sum().clamp_min(1)


def perplexity(loss):
    """exp(loss) with the overflow guard at loss 20."""
    return torch.exp(torch.clamp(torch.as_tensor(loss), max=20.0))


def gpt2_model_spec(cfg: GPT2Config, *, remat=False, use_flash: bool = False,
                    compute_dtype=None):
    """The single-device training model: ``init(generator)`` and
    ``loss_fn(params, batch, generator=None)`` over ``batch =
    (input_ids, labels)``, following the JAX ``gpt2_model_spec``'s
    single-device loss: the chunked CLM loss when ``cfg.loss_chunk > 0``,
    else the full-logits one. ``generator`` drives the dropout masks.

    Not ported (each raises ``NotImplementedError``, ROADMAP.md §1):
    bf16 ``compute_dtype``, MoE configs, ``remat="dots"``."""
    from quintnet_tpu_torch.parallel.strategy import ModelSpec

    if compute_dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype}: bf16 compute is not ported; "
            f"the port trains in f32 (ROADMAP.md §1, slice 2)")
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE GPT-2 training is not ported (ROADMAP.md §1, item 4)")
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' is not ported; use remat=True or False "
            "(ROADMAP.md §1, slice 2)")

    def loss_fn(params, batch, generator=None):
        input_ids, labels = batch
        if cfg.loss_chunk > 0:
            h = gpt2_hidden(params, input_ids, cfg, remat=remat,
                            use_flash=use_flash, generator=generator)
            return clm_loss_chunked(params, h, labels, cfg,
                                    chunk=cfg.loss_chunk)
        return clm_loss(gpt2_forward(params, input_ids, cfg, remat=remat,
                                     use_flash=use_flash,
                                     generator=generator), labels)

    return ModelSpec(init=lambda generator: gpt2_init(generator, cfg),
                     loss_fn=loss_fn, depth=cfg.n_layer,
                     needs_rng=cfg.needs_dropout)

"""Llama KV-cache generation: prefill, then one cached step a new token.

Port of ``quintnet_tpu/models/llama_generate.py`` on GPT-2's decode
loops (``models/gpt2_generate.autoregress`` and ``beam_autoregress``:
the sampling chain, EOS and beams are shared by every family); the
per-layer math is ``models/llama.llama_block_prefill`` and
``llama_block_decode``, the same helpers the training block is built
from. GQA caches are stored UNrepeated ([L, B, H_kv, T, Dh]); the kv
heads are repeated on read. Plain attention throughout, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from quintnet_tpu_torch.models.gpt2 import vocab_axis
from quintnet_tpu_torch.models.gpt2_generate import (_check_len, _ids_on,
                                                     _stack_caches,
                                                     autoregress,
                                                     beam_autoregress,
                                                     gather_vocab_logits,
                                                     row_seeds)
from quintnet_tpu_torch.models.llama import (LlamaConfig, llama_block_decode,
                                             llama_block_prefill,
                                             llama_logits, llama_rope_tables)
from quintnet_tpu_torch.nn.transformer import layer_params
from quintnet_tpu_torch.parallel.tp import vocab_parallel_embedding


def _embed(params, ids, cfg: LlamaConfig, tp_axis):
    """Token lookup; under vocab parallelism this rank's rows and one sum
    over tp."""
    return vocab_parallel_embedding({"table": params["embedding"]["tok"]},
                                    ids, axis=vocab_axis(cfg, tp_axis))


def _full_logits(params, h, cfg: LlamaConfig, tp_axis):
    """Full-vocab f32 logits; under vocab parallelism this rank's
    columns gathered over tp, padded columns masked."""
    logits = llama_logits(params, h, cfg)
    vp_axis = vocab_axis(cfg, tp_axis)
    return (logits if vp_axis is None
            else gather_vocab_logits(logits, cfg, vp_axis))


def llama_prefill(params, input_ids, cfg: LlamaConfig, *, cache_len: int,
                  tp_axis=None):
    """[B, T0] -> (last-position logits [B, V], (k, v) caches
    [L, B, H_kv(/tp), cache_len, Dh])."""
    T0 = input_ids.shape[1]
    h = _embed(params, input_ids, cfg, tp_axis)
    cos, sin = llama_rope_tables(torch.arange(T0, device=h.device), cfg)
    kvs = []
    for layer in range(cfg.n_layers):
        h, kv = llama_block_prefill(layer_params(params["blocks"], layer), h,
                                    cfg, cos, sin, tp_axis=tp_axis)
        kvs.append(kv)
    return (_full_logits(params, h[:, -1:, :], cfg, tp_axis)[:, 0, :],
            _stack_caches(kvs, cache_len))


def llama_decode_step(params, tok, pos: int, caches, cfg: LlamaConfig,
                      tp_axis=None):
    """One cached step: ``tok`` [B] at host position ``pos`` ->
    (logits [B, V], the caches, written in place)."""
    x = _embed(params, tok[:, None].long(), cfg, tp_axis)
    cos, sin = llama_rope_tables(torch.tensor([pos], device=x.device), cfg)
    ks, vs = caches
    for layer in range(cfg.n_layers):
        x, _ = llama_block_decode(layer_params(params["blocks"], layer), x,
                                  ks[layer], vs[layer], pos, cfg, cos, sin,
                                  tp_axis=tp_axis)
    return _full_logits(params, x, cfg, tp_axis)[:, 0, :], (ks, vs)


def _llama_generate_body(params, ids, seeds, cfg: LlamaConfig,
                         max_new_tokens, eos_token_id, temperature, top_k,
                         top_p, tp_axis=None):
    cache_len = ids.shape[1] + max_new_tokens
    return autoregress(
        lambda i: llama_prefill(params, i, cfg, cache_len=cache_len,
                                tp_axis=tp_axis),
        lambda tok, pos, caches: llama_decode_step(params, tok, pos, caches,
                                                   cfg, tp_axis=tp_axis),
        ids, seeds, max_new_tokens=max_new_tokens,
        eos_token_id=eos_token_id, temperature=temperature, top_k=top_k,
        top_p=top_p)


@torch.no_grad()
def llama_generate(params, input_ids, cfg: LlamaConfig, *,
                   max_new_tokens: int, eos_token_id: Optional[int] = None,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 1.0,
                   seed: Union[int, Sequence[int]] = 0) -> np.ndarray:
    """[B, T0] -> [B, T0 + max_new_tokens] int32 (numpy) on the params'
    device; greedy when ``temperature == 0``, else the sampling chain
    (``gpt2_generate``'s seeds)."""
    if max_new_tokens < 1:
        return np.asarray(input_ids)
    _check_len(input_ids, max_new_tokens, cfg.n_positions)
    ids = _ids_on(input_ids, params["embedding"]["tok"])
    out = _llama_generate_body(params, ids, row_seeds(seed, ids.shape[0]),
                               cfg, int(max_new_tokens), eos_token_id,
                               float(temperature), int(top_k), float(top_p))
    return out.to(torch.int32).cpu().numpy()


@torch.no_grad()
def llama_generate_tp(params, input_ids, cfg: LlamaConfig, *, mesh,
                      tp_axis: str = "tp", max_new_tokens: int,
                      eos_token_id: Optional[int] = None,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0,
                      seed: Union[int, Sequence[int]] = 0) -> np.ndarray:
    """tp-sharded Llama decoding on this rank of ``mesh``: ``params`` this
    rank's shards in the training layout (``llama_partition_specs``),
    head-sharded GQA caches, one sum over tp in every attention and MLP
    step, and with ``cfg.vocab_parallel`` the vocab-sharded table (its
    logits gathered, padded columns masked); every rank returns the same
    tokens."""
    if max_new_tokens < 1:
        return np.asarray(input_ids)
    _check_len(input_ids, max_new_tokens, cfg.n_positions)
    axis = mesh.axis(tp_axis)
    ids = _ids_on(input_ids, params["embedding"]["tok"])
    out = _llama_generate_body(params, ids, row_seeds(seed, ids.shape[0]),
                               cfg, int(max_new_tokens), eos_token_id,
                               float(temperature), int(top_k), float(top_p),
                               tp_axis=axis)
    return out.to(torch.int32).cpu().numpy()


@torch.no_grad()
def llama_beam_search(params, input_ids, cfg: LlamaConfig, *,
                      beams: int = 4, max_new_tokens: int,
                      eos_token_id: Optional[int] = None,
                      length_penalty: float = 1.0) -> np.ndarray:
    """Beam-search decode for Llama on the shared beam loop (GNMT length
    penalty; ``beams=1`` is greedy)."""
    if max_new_tokens < 1:
        return np.asarray(input_ids)
    _check_len(input_ids, max_new_tokens, cfg.n_positions)
    ids = _ids_on(input_ids, params["embedding"]["tok"])
    cache_len = ids.shape[1] + max_new_tokens
    out = beam_autoregress(
        lambda i: llama_prefill(params, i, cfg, cache_len=cache_len),
        lambda tok, pos, caches: llama_decode_step(params, tok, pos, caches,
                                                   cfg),
        ids, beams=int(beams), vocab=cfg.vocab_size,
        max_new_tokens=int(max_new_tokens), eos_token_id=eos_token_id,
        length_penalty=float(length_penalty))
    return out.to(torch.int32).cpu().numpy()

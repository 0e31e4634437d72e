"""KV-cache generation for GPT-2 (dense and MoE), and the sampling chain.

Port of ``quintnet_tpu/models/gpt2_generate.py``:

- **prefill** (:func:`gpt2_prefill`): one causal forward over the prompt
  that also emits every layer's (k, v) into a ``[L, B, H, T_max, Dh]``
  cache (``nn/transformer.block_prefill``);
- **decode** (:func:`gpt2_decode_step`): one cached block pass per layer
  for one new token (``nn/attention.mha_decode``'s dense branch), the
  caches written in place; a Python loop over the new tokens stands in
  for ``lax.scan`` (:func:`autoregress`);
- **EOS**: finished rows keep emitting ``eos_token_id``;
- **beam search** (:func:`beam_autoregress`, :func:`gpt2_beam_search`)
  and **tp-sharded decoding** (:func:`gpt2_generate_tp`: head-sharded
  caches, one sum over tp in every cached attention and MLP step; with
  ``cfg.vocab_parallel`` the vocab-sharded table: a masked lookup and
  one sum, and the logits' columns gathered over tp).

Both decoders run plain attention, as the JAX package's do (no Pallas
kernel there, no CUDA kernel here).

**The sampling chain.** torch cannot reproduce JAX's key stream
(``jax.random.categorical`` is Gumbel-max over a key split once per
committed token), so the port draws from its own counter-based chain:
the Gumbel noise of a request's committed position ``i`` at vocab
column ``c`` is a pure function of ``(seed, i, c)`` (:func:`chain_bits`:
a 32-bit integer hash, every row's part at once in numpy uint64 and
the [rows, vocab] part in torch int64 ops with every product below 2^49, so
the CPU and the card compute the same integers), and the token is
``argmax(filtered_logits / temperature + gumbel)`` — the distribution
``jax.random.categorical`` draws from. The chain keeps no evolving
state: ``(seed, len(generated))`` is a request's whole resume state, and
a preempted request that re-prefills ``prompt + generated`` keeps
drawing exactly where it stopped. ``temperature <= 0`` is greedy argmax
(the first index on ties). The top-k and top-p filters keep JAX's rules
(:func:`filter_logits`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_logits,
                                            mask_padded_cols, vocab_axis)
from quintnet_tpu_torch.nn.layers import gelu, layer_norm_apply
from quintnet_tpu_torch.nn.moe import _topk
from quintnet_tpu_torch.nn.transformer import (block_decode, block_prefill,
                                               layer_params)
from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.parallel.tp import vocab_parallel_embedding

# ---------------------------------------------------------------------
# the counter-based sampling chain
# ---------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``c``, by its 16-bit halves: each product stays below 2^49,
    so no int64 overflows on any device."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit avalanche bijection (two xor-shift-multiply rounds) of
    values in [0, 2^32): int64 tensors, uint64 numpy arrays (whose
    products wrap mod 2^64, above the low 32 bits kept), or Python ints."""
    mul = _mul32 if isinstance(x, torch.Tensor) else (
        lambda v, c: (v * c) & _M32)
    x = x ^ (x >> 16)
    x = mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul(x, 0x846CA68B)
    return x ^ (x >> 16)


@functools.lru_cache(maxsize=8)
def _column_hash(vocab: int, device: torch.device):
    """The chain's per-column term, the same every step: computed once a
    (vocab, device)."""
    return _mix32(torch.arange(vocab, dtype=torch.int64, device=device)
                  ^ 0x85EBCA6B)


def row_seeds(seed: Union[int, Sequence[int]], rows: int):
    """One seed a row: a sequence gives each row its own; an int gives row
    ``b`` the seed ``seed + b`` (so row ``b`` of a batch draws what a
    one-row call at ``seed + b`` draws)."""
    if isinstance(seed, (int, np.integer)):
        return [(int(seed) + b) & _M64 for b in range(rows)]
    seeds = [int(s) & _M64 for s in seed]
    if len(seeds) != rows:
        raise ValueError(f"{len(seeds)} seeds for {rows} rows")
    return seeds


def chain_bits(seeds: Sequence[int], counters, vocab: int, device):
    """The chain's integers: [B, vocab] int64 in [0, 2^32), a pure
    function of (``seeds[b]``, ``counters[b]``, column). ``seeds``: B
    python ints in [0, 2^64); ``counters``: B non-negative ints (a
    sequence or an int tensor), each row's committed position."""
    if isinstance(counters, torch.Tensor):
        counters = counters.cpu().numpy()
    # every row's term at once in uint64 numpy (the same function as on
    # a tensor), so a step launches only the [B, vocab] half on the device
    s = np.asarray(seeds, dtype=np.uint64)
    lo, hi = s & np.uint64(_M32), s >> np.uint64(32)
    c = np.asarray(counters).astype(np.uint64) & np.uint64(_M32)
    h = _mix32(_mix32(_mix32(lo ^ np.uint64(0x9E3779B9)) ^ hi) ^ c)
    dev = torch.device(device)
    h = torch.from_numpy(h.astype(np.int64)).to(dev)[:, None]
    hi = torch.from_numpy(hi.astype(np.int64)).to(dev)[:, None]
    return _mix32(_mix32(h ^ _column_hash(vocab, dev)[None, :]) ^ hi)


def chain_gumbel(seeds: Sequence[int], counters, vocab: int, device):
    """Standard Gumbel noise [B, vocab] f32 from :func:`chain_bits`: the
    top 23 bits as a uniform ``(m + 0.5) / 2^23`` in (0, 1) (exact in
    f32), then ``-log(-log(u))``."""
    bits = chain_bits(seeds, counters, vocab, device)
    u = ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


def filter_logits(logits, *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """[B, V] logits -> the scaled, filtered logits the sampler perturbs
    (``temperature > 0``): ``logits / temperature``, then top-k (columns
    below the k-th largest value set to ``finfo.min``), then nucleus
    (top-p: over a stable descending sort, a column is dropped when the
    mass before it already reached ``top_p - 16 eps``, so the first
    column to cross is kept, and the sort undone per row). JAX's
    ``sample_logits`` rules exactly, ties in the sort lower index
    first as ``lax.top_k``."""
    logits = logits.float() / temperature
    neg = torch.finfo(logits.dtype).min
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg)
    if 0.0 < top_p < 1.0:
        srt, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        probs = torch.softmax(srt, dim=-1)
        tol = 16 * torch.finfo(probs.dtype).eps
        drop = torch.cumsum(probs, dim=-1) - probs > top_p - tol
        srt = srt.masked_fill(drop, neg)
        logits = torch.empty_like(srt).scatter_(-1, idx, srt)
    return logits


def sample_logits(logits, seeds: Union[int, Sequence[int]] = 0,
                  counters=0, *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Next tokens [B] (int64) from [B, V] logits. ``temperature <= 0`` is
    greedy argmax regardless of the filters (the first index on ties, as
    ``jnp.argmax``). Otherwise ``argmax(filter_logits(...) + gumbel)``
    with the chain's noise of row b at (``seeds[b]``, ``counters[b]``):
    ``seeds`` an int (row b at ``seed + b``, :func:`row_seeds`) or B
    ints, ``counters`` an int (every row) or B ints."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    B, V = logits.shape
    if isinstance(counters, (int, np.integer)):
        counters = [int(counters)] * B
    noise = chain_gumbel(row_seeds(seeds, B), counters, V, logits.device)
    scores = filter_logits(logits, temperature=temperature, top_k=top_k,
                           top_p=top_p) + noise
    return torch.argmax(scores, dim=-1)


# ---------------------------------------------------------------------
# the dense KV-cache decoder
# ---------------------------------------------------------------------

def _local_heads(cfg: GPT2Config, tp_axis) -> int:
    return cfg.n_head if tp_axis is None else cfg.n_head // tp_axis.size


def gather_vocab_logits(local, cfg, vp_axis):
    """Full-vocab f32 logits from this rank's columns [.., V/tp]: gathered
    over ``vp_axis``, a padded vocabulary's columns masked (decoding must
    never emit an id past ``vocab_size``)."""
    full = cc.all_gather(local.float(), vp_axis, gather_dim=-1)
    return mask_padded_cols(full, cfg) if cfg.padded_vocab_size else full


def _embed_tok(emb, ids, cfg: GPT2Config, tp_axis=None):
    """Token embedding; under vocab parallelism the lookup of this rank's
    rows and one sum over tp."""
    return vocab_parallel_embedding({"table": emb["wte"]}, ids,
                                    axis=vocab_axis(cfg, tp_axis))


def _logits(params, h, cfg: GPT2Config, tp_axis=None):
    """Full-vocab f32 logits: the replicated head's, or under vocab
    parallelism this rank's columns of the tied head, gathered
    (:func:`gather_vocab_logits`)."""
    vp_axis = vocab_axis(cfg, tp_axis)
    if vp_axis is None:
        return gpt2_logits(params, h, cfg)
    h = layer_norm_apply(params["head"]["ln_f"], h,
                         eps=cfg.layer_norm_epsilon)
    return gather_vocab_logits(h @ params["embedding"]["wte"].T, cfg,
                               vp_axis)


def _stack_caches(kvs, cache_len: int):
    """Per-layer (k, v) [B, H, T0, Dh] -> two [L, B, H, cache_len, Dh]
    caches, the positions past T0 zero."""
    out = []
    for part in zip(*kvs):
        t = torch.stack(part)
        c = t.new_zeros((*t.shape[:3], cache_len, t.shape[4]))
        c[:, :, :, :t.shape[3]] = t
        out.append(c)
    return tuple(out)


def gpt2_prefill(params, input_ids, cfg: GPT2Config, *, cache_len: int,
                 tp_axis=None):
    """[B, T0] prompt -> (last-position logits [B, V], (k_cache, v_cache)
    each [L, B, H, cache_len, Dh]). Under ``tp_axis`` (a
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`) H is this rank's
    heads."""
    T0 = input_ids.shape[1]
    emb = params["embedding"]
    h = _embed_tok(emb, input_ids, cfg, tp_axis) + emb["wpe"][:T0][None]
    heads = _local_heads(cfg, tp_axis)
    kvs = []
    for layer in range(cfg.n_layer):
        h, kv = block_prefill(layer_params(params["blocks"], layer), h,
                              num_heads=heads, act=gelu,
                              moe_args=cfg.moe_args, tp_axis=tp_axis)
        kvs.append(kv)
    return (_logits(params, h[:, -1:, :], cfg, tp_axis)[:, 0, :],
            _stack_caches(kvs, cache_len))


def gpt2_decode_step(params, tok, pos: int, caches, cfg: GPT2Config,
                     tp_axis=None):
    """One cached decode step: ``tok`` [B] ids at host position ``pos``,
    caches [L, B, H, T, Dh] -> (logits [B, V], the caches, written in
    place)."""
    emb = params["embedding"]
    x = (_embed_tok(emb, tok[:, None].long(), cfg, tp_axis)
         + emb["wpe"][pos][None, None])
    ks, vs = caches
    heads = _local_heads(cfg, tp_axis)
    for layer in range(cfg.n_layer):
        x = block_decode(layer_params(params["blocks"], layer), x,
                         ks[layer], vs[layer], pos, num_heads=heads,
                         act=gelu, moe_args=cfg.moe_args,
                         tp_axis=tp_axis)[0]
    return _logits(params, x, cfg, tp_axis)[:, 0, :], (ks, vs)


def autoregress(prefill_fn, decode_fn, input_ids, seeds, *,
                max_new_tokens: int, eos_token_id: Optional[int],
                temperature: float, top_k: int = 0, top_p: float = 1.0):
    """Model-agnostic decode loop: ``prefill_fn(ids) -> (last-position
    logits [B, V], caches)``; ``decode_fn(tok [B], pos, caches) ->
    (logits, caches)``. New token ``t`` of row b is drawn at chain
    counter ``t`` of ``seeds[b]`` (:func:`sample_logits`); after EOS a
    row keeps emitting ``eos_token_id``. Returns [B, T0 +
    max_new_tokens] int64 on the ids' device."""
    B, T0 = input_ids.shape
    logits, caches = prefill_fn(input_ids)

    def pick(logits, t):
        return sample_logits(logits, seeds, t, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    tok = pick(logits, 0)
    done = (tok == eos_token_id if eos_token_id is not None
            else torch.zeros_like(tok, dtype=torch.bool))
    out = [tok]
    for t in range(1, max_new_tokens):
        logits, caches = decode_fn(tok, T0 + t - 1, caches)
        tok = pick(logits, t)
        if eos_token_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_token_id), tok)
            done = done | (tok == eos_token_id)
        out.append(tok)
    return torch.cat([input_ids.long(), torch.stack(out, dim=1)], dim=1)


def _check_len(input_ids, max_new_tokens: int, n_positions: int) -> None:
    if input_ids.shape[1] + max_new_tokens > n_positions:
        raise ValueError(
            f"prompt {input_ids.shape[1]} + max_new {max_new_tokens} "
            f"exceeds n_positions={n_positions}")


def _ids_on(input_ids, params_leaf):
    """The prompt ids (numpy or a tensor) as int64 on the params' device."""
    if not isinstance(input_ids, torch.Tensor):
        input_ids = torch.from_numpy(np.asarray(input_ids))
    return input_ids.to(params_leaf.device, torch.int64)


def _generate_body(params, ids, seeds, cfg: GPT2Config, max_new_tokens,
                   eos_token_id, temperature, top_k, top_p, tp_axis=None):
    cache_len = ids.shape[1] + max_new_tokens
    return autoregress(
        lambda i: gpt2_prefill(params, i, cfg, cache_len=cache_len,
                               tp_axis=tp_axis),
        lambda tok, pos, caches: gpt2_decode_step(params, tok, pos, caches,
                                                  cfg, tp_axis=tp_axis),
        ids, seeds, max_new_tokens=max_new_tokens,
        eos_token_id=eos_token_id, temperature=temperature, top_k=top_k,
        top_p=top_p)


@torch.no_grad()
def gpt2_generate(params, input_ids, cfg: GPT2Config, *,
                  max_new_tokens: int, eos_token_id: Optional[int] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0,
                  seed: Union[int, Sequence[int]] = 0) -> np.ndarray:
    """``input_ids`` [B, T0] -> [B, T0 + max_new_tokens] int32 (numpy),
    on the device the params live on. Greedy when ``temperature == 0``;
    otherwise sampled from the chain, row b at ``seed + b`` for an int
    seed (0 by default, as JAX's ``key(0)``) or at ``seed[b]``."""
    if max_new_tokens < 1:
        return np.asarray(input_ids)
    _check_len(input_ids, max_new_tokens, cfg.n_positions)
    ids = _ids_on(input_ids, params["embedding"]["wte"])
    out = _generate_body(params, ids, row_seeds(seed, ids.shape[0]), cfg,
                         int(max_new_tokens), eos_token_id,
                         float(temperature), int(top_k), float(top_p))
    return out.to(torch.int32).cpu().numpy()


# ---------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------

def beam_autoregress(prefill_fn, decode_fn, input_ids, *, beams: int,
                     vocab: int, max_new_tokens: int,
                     eos_token_id: Optional[int], length_penalty: float):
    """Model-agnostic beam decode (:func:`autoregress`'s contract;
    ``vocab`` = the logits' width). Beams ride a B*K row dimension,
    beam-major inside each batch row; every step keeps the K best of the
    K*V continuations (the lower flat index first among equal scores, as
    ``lax.top_k``: ``nn/moe._topk``) and re-indexes the caches to their
    parents. Finished beams may only re-emit EOS at zero cost. The best
    beam by GNMT length-normalised score is returned, padded with EOS
    after its first EOS."""
    B, T0 = input_ids.shape
    K, V = beams, vocab
    dev = input_ids.device
    neg = -1e30

    logits0, caches = prefill_fn(input_ids)
    caches = tuple(c.repeat_interleave(K, dim=1) for c in caches)
    logp0 = torch.log_softmax(logits0.float(), dim=-1)
    scores, t0 = _topk(logp0, K)                               # [B, K]
    done = (torch.zeros((B, K), dtype=torch.bool, device=dev)
            if eos_token_id is None else t0 == eos_token_id)
    toks = torch.zeros((B, K, max_new_tokens), dtype=torch.int64, device=dev)
    toks[:, :, 0] = t0
    batch_idx = torch.arange(B, device=dev)[:, None]
    if eos_token_id is not None:
        only_eos = torch.full((V,), neg, device=dev)
        only_eos[eos_token_id] = 0.0

    for i in range(1, max_new_tokens):
        logits, caches = decode_fn(toks[:, :, i - 1].reshape(B * K),
                                   T0 + i - 1, caches)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        if eos_token_id is not None:
            logp = torch.where(done[:, :, None], only_eos[None, None, :],
                               logp)
        total = scores[:, :, None] + logp
        scores, flat_i = _topk(total.reshape(B, K * V), K)
        parent = flat_i // V
        token = flat_i % V
        toks = toks[batch_idx, parent]
        toks[:, :, i] = token
        done = done[batch_idx, parent]
        if eos_token_id is not None:
            done = done | (token == eos_token_id)
        flat_parent = (parent + batch_idx * K).reshape(-1)
        caches = tuple(c[:, flat_parent] for c in caches)

    if eos_token_id is not None:
        is_eos = toks == eos_token_id
        first_eos = torch.argmax(is_eos.to(torch.int8), dim=2)
        lengths = torch.where(is_eos.any(dim=2), first_eos + 1,
                              torch.full_like(first_eos, max_new_tokens))
    else:
        lengths = torch.full((B, K), max_new_tokens, device=dev)
    norm = scores / lengths.float() ** length_penalty
    best = torch.argmax(norm, dim=1)
    best_toks = toks[torch.arange(B, device=dev), best]
    if eos_token_id is not None:
        is_eos = best_toks == eos_token_id
        cut = torch.where(is_eos.any(dim=1),
                          torch.argmax(is_eos.to(torch.int8), dim=1),
                          torch.full((B,), max_new_tokens, device=dev))
        pos = torch.arange(max_new_tokens, device=dev)[None, :]
        best_toks = torch.where(pos > cut[:, None],
                                torch.full_like(best_toks, eos_token_id),
                                best_toks)
    return torch.cat([input_ids.long(), best_toks], dim=1)


@torch.no_grad()
def gpt2_beam_search(params, input_ids, cfg: GPT2Config, *, beams: int = 4,
                     max_new_tokens: int,
                     eos_token_id: Optional[int] = None,
                     length_penalty: float = 1.0) -> np.ndarray:
    """Beam-search decode with the KV cache: [B, T0] -> [B, T0 +
    max_new_tokens] int32 (numpy), the best of ``beams`` by
    length-normalised log-probability. ``beams=1`` is greedy decoding."""
    if max_new_tokens < 1:
        return np.asarray(input_ids)
    _check_len(input_ids, max_new_tokens, cfg.n_positions)
    ids = _ids_on(input_ids, params["embedding"]["wte"])
    cache_len = ids.shape[1] + max_new_tokens
    out = beam_autoregress(
        lambda i: gpt2_prefill(params, i, cfg, cache_len=cache_len),
        lambda tok, pos, caches: gpt2_decode_step(params, tok, pos, caches,
                                                  cfg),
        ids, beams=int(beams),
        vocab=(cfg.table_vocab_size if cfg.padded_vocab_size
               else cfg.vocab_size),
        max_new_tokens=int(max_new_tokens), eos_token_id=eos_token_id,
        length_penalty=float(length_penalty))
    return out.to(torch.int32).cpu().numpy()


@torch.no_grad()
def gpt2_generate_tp(params, input_ids, cfg: GPT2Config, *, mesh,
                     tp_axis: str = "tp", max_new_tokens: int,
                     eos_token_id: Optional[int] = None,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0,
                     seed: Union[int, Sequence[int]] = 0) -> np.ndarray:
    """tp-sharded generation on this rank of a live ``mesh`` (every rank
    of the tp group calls it with the same ids and seeds). ``params`` are
    this rank's shards in the training layout (``gpt2_to_tp_layout``,
    sharded by ``gpt2_partition_specs``): head-sharded prefill and decode
    with one sum over tp in every attention and MLP step, the replicated
    head's logits the same on every rank, so every rank draws the same
    tokens. Returns the tokens (numpy) on every rank. With
    ``cfg.vocab_parallel`` the table is vocab-sharded too
    (``gpt2_partition_specs``): the embedding a masked lookup and one sum,
    the logits gathered over tp with padded columns masked."""
    if max_new_tokens < 1:
        return np.asarray(input_ids)
    _check_len(input_ids, max_new_tokens, cfg.n_positions)
    axis = mesh.axis(tp_axis)
    ids = _ids_on(input_ids, params["embedding"]["wte"])
    out = _generate_body(params, ids, row_seeds(seed, ids.shape[0]), cfg,
                         int(max_new_tokens), eos_token_id,
                         float(temperature), int(top_k), float(top_p),
                         tp_axis=axis)
    return out.to(torch.int32).cpu().numpy()

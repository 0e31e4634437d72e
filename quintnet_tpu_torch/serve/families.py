"""Model-family adapters for the serving engine (GPT-2).

Port of ``quintnet_tpu/serve/families.py`` for the default serving
path: one device, dense blocks, the vocabulary whole or padded (a padded
table's columns past ``vocab_size`` masked to the float minimum, so no
request can be served a padding id). A Python loop over layers replaces
``lax.scan``; each layer's pool views ``k_pool[l]``/``v_pool[l]`` (and
scale views ``k_scale[l]``/``v_scale[l]``) are updated in place.

Prefill contract: ``prefill_from(params, k_pool, v_pool, ids [1, P],
start, t0, table_row [M], block_size) -> (logits [1, V] at position
t0-1, k_pool, v_pool)``. ``ids`` hold the uncached tail
``tokens[start:t0]`` right-padded to the bucket width P; positions
``[0, start)`` are already resident in the blocks the table references.

Decode contract: ``decode(params, k_pool, v_pool, tok [S], pos [S],
tables [S, M], block_size) -> (logits [S, V], k_pool, v_pool)``.

Verify contract: ``verify(params, k_pool, v_pool, ids [S, P], starts
[S], tail_lens [S], tables [S, M], block_size) -> (logits [S, P, V],
k_pool, v_pool)`` — the decode step widened to P tokens a row at
``starts[s] + arange(P)``; columns at or beyond ``tail_lens[s]`` are
pad. ``logits[s, i]`` is the next-token distribution after row s's
first i+1 run tokens.

Quantized KV (``serve/kv_quant.py``): every contract also takes
``kv_scales=None, policy=None``. Under a scaled policy (int8,
fake_quant) ``kv_scales`` is the pool's ``(k_scale, v_scale)``, each
``[L, num_blocks, H_kv]``, and the return widens to ``(logits, k_pool,
v_pool, k_scale, v_scale)``.

``start``/``t0`` are host ints; the index tensors are int32 on the
pool's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from quintnet_tpu_torch.models.gpt2_generate import _embed_tok, _logits
from quintnet_tpu_torch.nn.layers import gelu
from quintnet_tpu_torch.nn.transformer import (block_decode,
                                               block_prefill_paged,
                                               block_verify_paged,
                                               layer_params)


@dataclass(frozen=True)
class Family:
    name: str
    cfg: Any
    n_layers: int
    n_kv_heads: int          # pool head dim
    head_dim: int
    max_positions: int
    prefill_from: Callable
    decode: Callable
    verify: Callable
    kv_dtype: Any = torch.float32


def _layer_pools(k_pool, v_pool, kv_scales, layer: int):
    """Layer ``layer``'s pool views, and its scale views or None."""
    sc = (None if kv_scales is None
          else (kv_scales[0][layer], kv_scales[1][layer]))
    return k_pool[layer], v_pool[layer], sc


def _pools_out(k_pool, v_pool, kv_scales):
    """The pools a contract hands back (updated in place)."""
    return (k_pool, v_pool) + (() if kv_scales is None else tuple(kv_scales))


def gpt2_family(cfg) -> Family:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE GPT-2 serving is not ported yet (ROADMAP.md §1, item 7, "
            "'Serving features': MoE serving)")
    L = cfg.n_layer

    def prefill_from(params, k_pool, v_pool, ids, start: int, t0: int,
                     table_row, block_size: int, kv_scales=None,
                     policy=None):
        P = ids.shape[1]
        emb = params["embedding"]
        positions = torch.arange(start, start + P, dtype=torch.int32,
                                 device=ids.device)
        # pad rows may sit past n_positions; clip their (ignored) wpe read
        safe_pos = positions.clamp(max=emb["wpe"].shape[0] - 1).long()
        h = _embed_tok(emb, ids, cfg) + emb["wpe"][safe_pos][None]
        for layer in range(L):
            kc, vc, sc = _layer_pools(k_pool, v_pool, kv_scales, layer)
            h = block_prefill_paged(
                layer_params(params["blocks"], layer), h, kc, vc, positions,
                t0 - start, num_heads=cfg.n_head, act=gelu,
                block_tables=table_row, block_size=block_size,
                kv_scales=sc, policy=policy)[0]
        h_last = h[:, t0 - 1 - start:t0 - start]
        return (_logits(params, h_last, cfg)[:, 0, :],
                *_pools_out(k_pool, v_pool, kv_scales))

    def decode(params, k_pool, v_pool, tok, pos, tables, block_size: int,
               kv_scales=None, policy=None):
        emb = params["embedding"]
        x = (_embed_tok(emb, tok[:, None].long(), cfg)
             + emb["wpe"][pos.long()][:, None, :])
        for layer in range(L):
            kc, vc, sc = _layer_pools(k_pool, v_pool, kv_scales, layer)
            x = block_decode(
                layer_params(params["blocks"], layer), x, kc, vc, pos,
                num_heads=cfg.n_head, act=gelu, block_tables=tables,
                block_size=block_size, kv_scales=sc, policy=policy)[0]
        return (_logits(params, x, cfg)[:, 0, :],
                *_pools_out(k_pool, v_pool, kv_scales))

    def verify(params, k_pool, v_pool, ids, starts, tail_lens, tables,
               block_size: int, kv_scales=None, policy=None):
        S, P = ids.shape
        emb = params["embedding"]
        positions = (starts[:, None]
                     + torch.arange(P, dtype=torch.int32,
                                    device=ids.device)[None, :])  # [S, P]
        safe_pos = positions.clamp(max=emb["wpe"].shape[0] - 1).long()
        h = _embed_tok(emb, ids.long(), cfg) + emb["wpe"][safe_pos]
        for layer in range(L):
            kc, vc, sc = _layer_pools(k_pool, v_pool, kv_scales, layer)
            h = block_verify_paged(
                layer_params(params["blocks"], layer), h, kc, vc, positions,
                tail_lens, num_heads=cfg.n_head, act=gelu,
                block_tables=tables, block_size=block_size, kv_scales=sc,
                policy=policy)[0]
        return (_logits(params, h, cfg),
                *_pools_out(k_pool, v_pool, kv_scales))

    return Family(
        name="gpt2", cfg=cfg, n_layers=L, n_kv_heads=cfg.n_head,
        head_dim=cfg.n_embd // cfg.n_head, max_positions=cfg.n_positions,
        prefill_from=prefill_from, decode=decode, verify=verify)

"""Model-family adapters for the serving engine (GPT-2).

Port of ``quintnet_tpu/serve/families.py`` for the default serving
path: one device, dense blocks, passthrough KV pools. A Python loop
over layers replaces ``lax.scan``; each layer's pool views
``k_pool[l]``/``v_pool[l]`` are updated in place.

Prefill contract: ``prefill_from(params, k_pool, v_pool, ids [1, P],
start, t0, table_row [M], block_size) -> (logits [1, V] at position
t0-1, k_pool, v_pool)``. ``ids`` hold the uncached tail
``tokens[start:t0]`` right-padded to the bucket width P; positions
``[0, start)`` are already resident in the blocks the table references.

Decode contract: ``decode(params, k_pool, v_pool, tok [S], pos [S],
tables [S, M], block_size) -> (logits [S, V], k_pool, v_pool)``.

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
    kv_dtype: Any = torch.float32


def gpt2_family(cfg) -> Family:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE GPT-2 serving is not ported yet (ROADMAP.md, 'Serving "
            "features': MoE serving)")
    if cfg.padded_vocab_size:
        raise NotImplementedError(
            "padded-vocab GPT-2 serving is not ported yet (ROADMAP.md, "
            "'GPT-2': mask_padded_cols with a padded vocab)")
    L = cfg.n_layer

    def prefill_from(params, k_pool, v_pool, ids, start: int, t0: int,
                     table_row, block_size: int):
        P = ids.shape[1]
        emb = params["embedding"]
        positions = torch.arange(start, start + P, dtype=torch.int32,
                                 device=ids.device)
        # pad rows may sit past n_positions; clip their (ignored) wpe read
        safe_pos = positions.clamp(max=emb["wpe"].shape[0] - 1).long()
        h = _embed_tok(emb, ids, cfg) + emb["wpe"][safe_pos][None]
        for layer in range(L):
            h, _, _ = block_prefill_paged(
                layer_params(params["blocks"], layer), h, k_pool[layer],
                v_pool[layer], positions, t0 - start, num_heads=cfg.n_head,
                act=gelu, block_tables=table_row, block_size=block_size)
        h_last = h[:, t0 - 1 - start:t0 - start]
        return _logits(params, h_last, cfg)[:, 0, :], k_pool, v_pool

    def decode(params, k_pool, v_pool, tok, pos, tables, block_size: int):
        emb = params["embedding"]
        x = (_embed_tok(emb, tok[:, None].long(), cfg)
             + emb["wpe"][pos.long()][:, None, :])
        for layer in range(L):
            x, _, _ = block_decode(
                layer_params(params["blocks"], layer), x, k_pool[layer],
                v_pool[layer], pos, num_heads=cfg.n_head, act=gelu,
                block_tables=tables, block_size=block_size)
        return _logits(params, x, cfg)[:, 0, :], k_pool, v_pool

    return Family(
        name="gpt2", cfg=cfg, n_layers=L, n_kv_heads=cfg.n_head,
        head_dim=cfg.n_embd // cfg.n_head, max_positions=cfg.n_positions,
        prefill_from=prefill_from, decode=decode)

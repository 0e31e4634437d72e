"""Model-family adapters for the serving engine: GPT-2 and Llama.

Port of ``quintnet_tpu/serve/families.py``: dense and MoE blocks, the
vocabulary whole, padded (a padded table's columns past ``vocab_size``
masked to the float minimum, so no request can be served a padding id)
or vocab-parallel, on one device or on one rank of a serving mesh. A
Python loop over layers replaces ``lax.scan``; each layer's pool views
``k_pool[l]``/``v_pool[l]`` (and scale views ``k_scale[l]``/
``v_scale[l]``) are updated in place.

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

Sequence-parallel prefill: ``prefill_from_sp(params, k_pool, v_pool,
ids [1, P/sp], start, t0, table_row, block_size, *, sp_axis)`` — the
prefill contract with ``ids`` THIS sp rank's slice of the bucket; the
attention is the ring over ``sp_axis`` (``nn/attention.
ring_paged_prefill``, plain attention, no kernel) and every rank ends
with the whole chunk in its (sp-replicated) pool and the same logits.

Every contract also takes:

- ``lora=None, lora_scale=None`` (prefill, decode and verify;
  ``serve/adapters.py``): the packed per-slot adapters, ``{"attn":
  {target: {"a": [L, S, in, r], "b": [L, S, r, out]}}, "mlp": {...}}``
  (S = 1 for a prefill: the request's row) and the [S] scales; each
  layer takes its ``[l]`` slice (``nn/layers.lora_delta``);
- ``kv_scales=None, policy=None`` (``serve/kv_quant.py``): under a
  scaled policy (int8, fake_quant) ``kv_scales`` is the pool's
  ``(k_scale, v_scale)``, each ``[L, num_blocks, H_kv]``, and the return
  widens to ``(logits, k_pool, v_pool, k_scale, v_scale)``;
- ``tp_axis=None`` (a :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`):
  ``params`` are this rank's shards (``partition_specs``), the pool holds
  this rank's kv heads, and every attention and MLP ends in one sum over
  tp, so the logits are the same on every rank;
- ``ep_axis=None`` (a MeshAxis; MoE families): the experts sharded over
  ep, one all-to-all each way per MoE layer (``nn/moe.py``). A MoE
  family widens every return by one trailing routing-stats dict, the
  counts summed over layers and the entropy averaged
  (:func:`_reduce_moe_stats`).

``start``/``t0`` are host ints; the index tensors are int32 on the
pool's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from quintnet_tpu_torch.models.gpt2_generate import (_embed_tok,
                                                     _local_heads, _logits)
from quintnet_tpu_torch.nn.attention import sp_last_hidden
from quintnet_tpu_torch.nn.layers import gelu
from quintnet_tpu_torch.nn.transformer import (block_decode,
                                               block_prefill_paged,
                                               block_prefill_paged_sp,
                                               block_verify_paged,
                                               layer_params)


@dataclass(frozen=True)
class Family:
    name: str
    cfg: Any
    n_layers: int
    n_kv_heads: int          # GLOBAL kv heads (the pool holds / tp)
    head_dim: int
    max_positions: int
    prefill_from: Callable
    decode: Callable
    verify: Callable
    # (tp_axis name or None, ep_axis name or None) -> the param spec tree
    partition_specs: Callable
    prefill_from_sp: Optional[Callable] = None
    kv_dtype: Any = torch.float32
    # the engine's default LoRA target names (models/lora.py)
    lora_targets: Tuple[str, ...] = ()
    # paths (under one block node) of the linears a weight layout policy
    # packs (serve/weight_quant.py): embeddings, the head, the norms and
    # MoE experts stay full precision
    weight_targets: Tuple[Tuple[str, ...], ...] = ()
    # (path, b factor [L, r, out], tp) -> b in the serving weights' tp
    # layout (GPT-2's fused qkv is tp-blocked); None is the identity
    lora_layout: Optional[Callable] = None


def _layer_pools(k_pool, v_pool, kv_scales, layer: int):
    """Layer ``layer``'s pool views, and its scale views or None."""
    sc = (None if kv_scales is None
          else (kv_scales[0][layer], kv_scales[1][layer]))
    return k_pool[layer], v_pool[layer], sc


def _reduce_moe_stats(stats):
    """The layers' routing stats -> one program's totals: counts summed
    over layers, entropy averaged. Every value is the same on every ep
    and tp rank (routing runs on the replicated token batch)."""
    return {"expert_tokens": torch.stack(
                [s["expert_tokens"] for s in stats]).sum(dim=0),
            "dropped": torch.stack([s["dropped"] for s in stats]).sum(),
            "assigned": torch.stack([s["assigned"] for s in stats]).sum(),
            "entropy": torch.stack([s["entropy"] for s in stats]).mean()}


def _run_layers(h, n_layers: int, step, k_pool, v_pool, kv_scales, moe):
    """``h`` through every layer's ``step(layer, h, kc, vc, sc) -> (h,
    *pools[, stats])``; returns (h, the pools the contract hands back,
    and with ``moe`` the reduced routing stats last)."""
    stats = []
    for layer in range(n_layers):
        out = step(layer, h, *_layer_pools(k_pool, v_pool, kv_scales, layer))
        h = out[0]
        if moe:
            stats.append(out[-1])
    pools = (k_pool, v_pool) + (() if kv_scales is None
                                else tuple(kv_scales))
    if moe:
        pools = pools + (_reduce_moe_stats(stats),)
    return h, pools


def _layer_lora(lora, layer: int):
    """Layer ``layer``'s slice of the packed adapters (or None)."""
    return None if lora is None else layer_params(lora, layer)


def _positions(start: int, n: int, device):
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


# --------------------------------------------------------------------
# GPT-2
# --------------------------------------------------------------------

def gpt2_family(cfg) -> Family:
    from quintnet_tpu_torch.models.gpt2 import gpt2_partition_specs
    from quintnet_tpu_torch.models.lora import DEFAULT_TARGETS
    from quintnet_tpu_torch.parallel.tp import qkv_blocked_from_standard

    L, moe = cfg.n_layer, cfg.moe_args is not None

    def embed(params, ids, positions, tp_axis):
        emb = params["embedding"]
        # pad rows may sit past n_positions; clip their (ignored) wpe read
        safe = positions.clamp(max=emb["wpe"].shape[0] - 1).long()
        return _embed_tok(emb, ids.long(), cfg, tp_axis) + emb["wpe"][safe]

    def prefill_from(params, k_pool, v_pool, ids, start: int, t0: int,
                     table_row, block_size: int, kv_scales=None,
                     policy=None, tp_axis=None, ep_axis=None, lora=None,
                     lora_scale=None):
        positions = _positions(start, ids.shape[1], ids.device)
        h = embed(params, ids, positions, tp_axis)

        def step(layer, x, kc, vc, sc):
            return block_prefill_paged(
                layer_params(params["blocks"], layer), x, kc, vc, positions,
                t0 - start, num_heads=_local_heads(cfg, tp_axis), act=gelu,
                moe_args=cfg.moe_args, ep_axis=ep_axis, tp_axis=tp_axis,
                block_tables=table_row, block_size=block_size,
                lora=_layer_lora(lora, layer), lora_scale=lora_scale,
                kv_scales=sc, policy=policy)

        h, pools = _run_layers(h, L, step, k_pool, v_pool, kv_scales, moe)
        h_last = h[:, t0 - 1 - start:t0 - start]
        return (_logits(params, h_last, cfg, tp_axis)[:, 0, :], *pools)

    def decode(params, k_pool, v_pool, tok, pos, tables, block_size: int,
               kv_scales=None, policy=None, tp_axis=None, ep_axis=None,
               lora=None, lora_scale=None):
        x = embed(params, tok[:, None], pos[:, None], tp_axis)

        def step(layer, h, kc, vc, sc):
            return block_decode(
                layer_params(params["blocks"], layer), h, kc, vc, pos,
                num_heads=_local_heads(cfg, tp_axis), act=gelu,
                moe_args=cfg.moe_args, ep_axis=ep_axis, tp_axis=tp_axis,
                block_tables=tables, block_size=block_size,
                lora=_layer_lora(lora, layer), lora_scale=lora_scale,
                kv_scales=sc, policy=policy)

        x, pools = _run_layers(x, L, step, k_pool, v_pool, kv_scales, moe)
        return (_logits(params, x, cfg, tp_axis)[:, 0, :], *pools)

    def verify(params, k_pool, v_pool, ids, starts, tail_lens, tables,
               block_size: int, kv_scales=None, policy=None, tp_axis=None,
               ep_axis=None, lora=None, lora_scale=None):
        positions = (starts[:, None]
                     + torch.arange(ids.shape[1], dtype=torch.int32,
                                    device=ids.device)[None, :])  # [S, P]
        h = embed(params, ids, positions, tp_axis)

        def step(layer, x, kc, vc, sc):
            return block_verify_paged(
                layer_params(params["blocks"], layer), x, kc, vc, positions,
                tail_lens, num_heads=_local_heads(cfg, tp_axis), act=gelu,
                moe_args=cfg.moe_args, ep_axis=ep_axis, tp_axis=tp_axis,
                block_tables=tables, block_size=block_size,
                lora=_layer_lora(lora, layer), lora_scale=lora_scale,
                kv_scales=sc, policy=policy)

        h, pools = _run_layers(h, L, step, k_pool, v_pool, kv_scales, moe)
        return (_logits(params, h, cfg, tp_axis), *pools)

    def prefill_from_sp(params, k_pool, v_pool, ids, start: int, t0: int,
                        table_row, block_size: int, *, sp_axis,
                        tp_axis=None, kv_scales=None, policy=None):
        # ids: [1, P/sp], this rank's slice at its absolute positions
        pl = ids.shape[1]
        positions = _positions(start + sp_axis.index * pl, pl, ids.device)
        h = embed(params, ids, positions, tp_axis)

        def step(layer, x, kc, vc, sc):
            return block_prefill_paged_sp(
                layer_params(params["blocks"], layer), x, kc, vc, start, t0,
                num_heads=_local_heads(cfg, tp_axis), sp_axis=sp_axis,
                act=gelu, tp_axis=tp_axis, block_tables=table_row,
                block_size=block_size, kv_scales=sc, policy=policy)

        h, pools = _run_layers(h, L, step, k_pool, v_pool, kv_scales, False)
        h_last = sp_last_hidden(h, start, t0, sp_axis=sp_axis)
        return (_logits(params, h_last, cfg, tp_axis)[:, 0, :], *pools)

    def lora_layout(path, b, tp):
        # the serving weights' fused qkv columns are tp-blocked
        # (parallel/tp.gpt2_to_tp_layout): an adapter's b, trained on the
        # standard [q|k|v] columns, is re-blocked the same way
        if path[-1] == "qkv" and tp > 1:
            return qkv_blocked_from_standard(b, cfg.n_head, tp)
        return b

    return Family(
        name="gpt2", cfg=cfg, n_layers=L, n_kv_heads=cfg.n_head,
        head_dim=cfg.n_embd // cfg.n_head, max_positions=cfg.n_positions,
        prefill_from=prefill_from, decode=decode, verify=verify,
        prefill_from_sp=prefill_from_sp,
        partition_specs=lambda tp_axis, ep_axis=None: gpt2_partition_specs(
            cfg, tp_axis=tp_axis, ep_axis=ep_axis),
        lora_targets=DEFAULT_TARGETS, lora_layout=lora_layout,
        weight_targets=(("attn", "qkv"), ("attn", "proj"), ("mlp", "fc"),
                        ("mlp", "proj")))


# --------------------------------------------------------------------
# Llama (GQA: the pool holds UNrepeated kv heads)
# --------------------------------------------------------------------

def llama_family(cfg) -> Family:
    """Llama serving: rope tables at the served positions only (never a
    ``n_positions``-row table), the pool of UNrepeated kv heads, and
    ``ops.paged_attention`` taking the GQA group itself."""
    from quintnet_tpu_torch.models.llama import (llama_block_decode,
                                                 llama_block_prefill_paged,
                                                 llama_block_prefill_paged_sp,
                                                 llama_block_verify_paged,
                                                 llama_partition_specs,
                                                 llama_rope_tables)
    from quintnet_tpu_torch.models.llama_generate import (_embed,
                                                          _full_logits)
    from quintnet_tpu_torch.models.lora import LLAMA_TARGETS

    L, moe = cfg.n_layers, cfg.moe_args is not None

    def flat(out):
        x, pools = out
        return (x, *pools)

    def prefill_from(params, k_pool, v_pool, ids, start: int, t0: int,
                     table_row, block_size: int, kv_scales=None,
                     policy=None, tp_axis=None, ep_axis=None, lora=None,
                     lora_scale=None):
        positions = _positions(start, ids.shape[1], ids.device)
        h = _embed(params, ids.long(), cfg, tp_axis)
        cos, sin = llama_rope_tables(positions, cfg)           # [P, hd]

        def step(layer, x, kc, vc, sc):
            return flat(llama_block_prefill_paged(
                layer_params(params["blocks"], layer), x, kc, vc, positions,
                t0 - start, cfg, cos, sin, tp_axis=tp_axis, ep_axis=ep_axis,
                block_tables=table_row, block_size=block_size,
                lora=_layer_lora(lora, layer), lora_scale=lora_scale,
                kv_scales=sc, policy=policy))

        h, pools = _run_layers(h, L, step, k_pool, v_pool, kv_scales, moe)
        h_last = h[:, t0 - 1 - start:t0 - start]
        return (_full_logits(params, h_last, cfg, tp_axis)[:, 0, :], *pools)

    def decode(params, k_pool, v_pool, tok, pos, tables, block_size: int,
               kv_scales=None, policy=None, tp_axis=None, ep_axis=None,
               lora=None, lora_scale=None):
        x = _embed(params, tok[:, None].long(), cfg, tp_axis)   # [S, 1, D]
        cos, sin = llama_rope_tables(pos, cfg)                  # [S, hd]
        cos, sin = cos[:, None, None, :], sin[:, None, None, :]

        def step(layer, h, kc, vc, sc):
            return flat(llama_block_decode(
                layer_params(params["blocks"], layer), h, kc, vc, pos, cfg,
                cos, sin, tp_axis=tp_axis, ep_axis=ep_axis,
                block_tables=tables, block_size=block_size,
                lora=_layer_lora(lora, layer), lora_scale=lora_scale,
                kv_scales=sc, policy=policy))

        x, pools = _run_layers(x, L, step, k_pool, v_pool, kv_scales, moe)
        return (_full_logits(params, x, cfg, tp_axis)[:, 0, :], *pools)

    def verify(params, k_pool, v_pool, ids, starts, tail_lens, tables,
               block_size: int, kv_scales=None, policy=None, tp_axis=None,
               ep_axis=None, lora=None, lora_scale=None):
        positions = (starts[:, None]
                     + torch.arange(ids.shape[1], dtype=torch.int32,
                                    device=ids.device)[None, :])  # [S, P]
        h = _embed(params, ids.long(), cfg, tp_axis)             # [S, P, D]
        cos, sin = llama_rope_tables(positions, cfg)             # [S, P, hd]
        cos, sin = cos[:, None], sin[:, None]                    # [S,1,P,hd]

        def step(layer, x, kc, vc, sc):
            return flat(llama_block_verify_paged(
                layer_params(params["blocks"], layer), x, kc, vc, positions,
                tail_lens, cfg, cos, sin, tp_axis=tp_axis, ep_axis=ep_axis,
                block_tables=tables, block_size=block_size,
                lora=_layer_lora(lora, layer), lora_scale=lora_scale,
                kv_scales=sc, policy=policy))

        h, pools = _run_layers(h, L, step, k_pool, v_pool, kv_scales, moe)
        return (_full_logits(params, h, cfg, tp_axis), *pools)

    def prefill_from_sp(params, k_pool, v_pool, ids, start: int, t0: int,
                        table_row, block_size: int, *, sp_axis,
                        tp_axis=None, kv_scales=None, policy=None):
        # ids: [1, P/sp]; rope at the rank's own absolute positions
        pl = ids.shape[1]
        positions = _positions(start + sp_axis.index * pl, pl, ids.device)
        h = _embed(params, ids.long(), cfg, tp_axis)
        cos, sin = llama_rope_tables(positions, cfg)             # [Pl, hd]

        def step(layer, x, kc, vc, sc):
            return flat(llama_block_prefill_paged_sp(
                layer_params(params["blocks"], layer), x, kc, vc, start, t0,
                cfg, cos, sin, sp_axis=sp_axis, tp_axis=tp_axis,
                block_tables=table_row, block_size=block_size,
                kv_scales=sc, policy=policy))

        h, pools = _run_layers(h, L, step, k_pool, v_pool, kv_scales, False)
        h_last = sp_last_hidden(h, start, t0, sp_axis=sp_axis)
        return (_full_logits(params, h_last, cfg, tp_axis)[:, 0, :], *pools)

    return Family(
        name="llama", cfg=cfg, n_layers=L, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, max_positions=cfg.n_positions,
        prefill_from=prefill_from, decode=decode, verify=verify,
        prefill_from_sp=prefill_from_sp,
        partition_specs=lambda tp_axis, ep_axis=None: llama_partition_specs(
            cfg, tp_axis=tp_axis, ep_axis=ep_axis),
        lora_targets=LLAMA_TARGETS,
        weight_targets=(("attn", "q"), ("attn", "k"), ("attn", "v"),
                        ("attn", "o"), ("mlp", "gate"), ("mlp", "up"),
                        ("mlp", "down")))

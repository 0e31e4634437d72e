"""Llama-family causal LM (RMSNorm, rotary, SwiGLU, GQA): training, the
dense KV-cache blocks and the paged serving blocks.

Port of ``quintnet_tpu/models/llama.py`` without its Hugging Face
interop. Parameters keep the JAX pytree layout::

    {"embedding": {"tok": [V, D]},
     "blocks": {"ln1": {"scale"}, "attn": {"q", "k", "v", "o": {"w"}},
                "ln2": {"scale"}, "mlp": {"gate", "up", "down": {"w"}}}
                                   # every leaf stacked [L, ...]
     "head": {"ln_f": {"scale"}[, "lm": {"w": [D, V]}]}}

with linear weights ``[in, out]`` and the lm head tied to ``tok`` unless
``tie_embeddings`` is False. With ``n_experts > 0`` each block's ``mlp``
is a Mixtral-style SwiGLU MoE ``moe`` (``{"router": {"w"}, "wg", "wu",
"wd"}``, experts sharded over ep: ``nn/moe.py``) whose load-balance loss
joins the CLM loss.

Attention: q and k are rotated (HF's rotate_half, llama3 rope scaling),
K/V are repeated to the query heads (``repeat_kv``, GQA) and the call
goes to ``ops.flash_attention`` with ``use_flash`` (the K1-K3 kernels on
the card, at head dim 64 for every preset here) or to the plain
``sdpa``. Under tp, q/k/v are column-sharded by (kv-)heads, o row-sharded
with one sum; gate/up column- and down row-sharded, one sum: GPT-2's
Megatron pattern, with ``n_kv_heads % tp == 0``. Separate q/k/v need no
fused-QKV reblocking, so the tp layout is the identity.

:func:`llama_block_prefill` and :func:`llama_block_decode`'s dense branch
carry the generation decoders (``models/llama_generate.py``); the cache
stays UNrepeated ([B, Hkv, T, hd]) and is repeated on read. The paged
blocks (:func:`llama_block_prefill_paged`,
:func:`llama_block_verify_paged`, :func:`llama_block_decode` with a
block table, and the sequence-parallel
:func:`llama_block_prefill_paged_sp`) carry the serving engine
(``serve/families.llama_family``): the pool holds the UNrepeated kv
heads and ``ops.paged_attention`` takes the GQA group itself, so nothing
is repeated on the pool or on the kernel's inputs.

Not ported, each raising ``NotImplementedError`` naming its ROADMAP.md
place: the HF interop (``llama_from_hf_state``, ``llama_to_hf_state``,
``LlamaConfig.from_hf_config``: §1, item 9) and ``remat="dots"`` (§2).
``vocab_parallel`` under tp shards ``tok``'s rows (and an untied head's
columns) over the tp ranks, as GPT-2's (``models/gpt2.clm_loss_vp``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from quintnet_tpu_torch.models.gpt2 import (_vp_loss, vocab_axis,
                                            check_vocab_split, clm_loss,
                                            clm_loss_sp,
                                            sequence_batch_specs,
                                            mask_padded_cols,
                                            segment_ids_from_input,
                                            sp_head_loss)
from quintnet_tpu_torch.nn.attention import (apply_rope,
                                             dense_cache_attend,
                                             paged_attend_decode,
                                             paged_attend_prefill,
                                             paged_attend_verify, repeat_kv,
                                             ring_paged_prefill,
                                             rope_cos_sin, sdpa,
                                             sp_attention)
from quintnet_tpu_torch.nn.layers import (cast_floating, keep_router_f32,
                                          linear_init, rms_norm_apply,
                                          rms_norm_init, swiglu_apply,
                                          swiglu_init)
from quintnet_tpu_torch.nn.moe import MoEArgs, moe_apply, moe_init, moe_specs
from quintnet_tpu_torch.nn.transformer import (REMAT_DOTS_ITEM,
                                               stacked_blocks_apply)
from quintnet_tpu_torch.ops.flash_attention import flash_attention
from quintnet_tpu_torch.parallel.tp import (row_parallel_linear,
                                            vocab_parallel_embedding)

HF_ITEM = "ROADMAP.md §1, item 9 ('Analysis, data and tools')"


@dataclass(frozen=True)
class LlamaConfig:
    """The JAX config's fields, names and presets. ``rope_scaling``:
    llama3's ``(factor, low_freq_factor, high_freq_factor,
    original_max_position)`` or None (unscaled). MoE as GPT-2's
    (``n_experts`` 0 is dense; expert choice is refused:
    non-causal). ``segment_eos_id``: packed-document isolation, a new
    attention segment after each such token. ``vocab_parallel``: under tp
    the table's rows sharded over the ranks (``padded_vocab_size`` pads
    it to a multiple of tp; the padded columns are masked out of every
    softmax); ``scan_unroll`` has no meaning in a
    Python loop over layers and is carried only so configs map over."""

    vocab_size: int = 32000
    n_positions: int = 2048
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 32
    n_kv_heads: int = 8
    intermediate_size: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = True
    scan_unroll: int = 1
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    expert_capacity: Optional[int] = None
    aux_loss_weight: float = 1e-2
    router_type: str = "topk"
    vocab_parallel: bool = False
    padded_vocab_size: Optional[int] = None
    segment_eos_id: Optional[int] = None
    rope_scaling: Optional[Tuple[float, float, float, int]] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def table_vocab_size(self) -> int:
        return self.padded_vocab_size or self.vocab_size

    @property
    def moe_args(self) -> Optional[MoEArgs]:
        if self.n_experts <= 0:
            return None
        if self.router_type == "expert_choice":
            raise ValueError(
                "expert_choice routing is non-causal and unsupported "
                "for the causal LM families; use router_type='topk' "
                "(see nn/moe.py MoEArgs.router)")
        return MoEArgs(n_experts=self.n_experts, top_k=self.expert_top_k,
                       capacity_factor=self.capacity_factor,
                       capacity=self.expert_capacity,
                       aux_weight=self.aux_loss_weight,
                       router=self.router_type)

    @staticmethod
    def llama32_1b() -> "LlamaConfig":
        """meta-llama/Llama-3.2-1B's config.json: vocab 128,256, dim
        2,048, 16 layers, 32/8 heads, FFN 8,192, tied, llama3 rope
        scaling (32, 1, 4, 8192)."""
        return LlamaConfig(vocab_size=128256, n_positions=131072,
                           rope_scaling=(32.0, 1.0, 4.0, 8192))

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, n_positions=8192, dim=4096,
                           n_layers=32, n_heads=32, n_kv_heads=8,
                           intermediate_size=14336, rope_theta=500000.0,
                           tie_embeddings=False)

    @staticmethod
    def llama_160m() -> "LlamaConfig":
        """GPT-2-base-comparable geometry (not a released Llama size)."""
        return LlamaConfig(vocab_size=32000, n_positions=2048, dim=768,
                           n_layers=12, n_heads=12, n_kv_heads=4,
                           intermediate_size=2048, rope_theta=10000.0,
                           tie_embeddings=True)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config (the JAX package's sizes)."""
        d = dict(vocab_size=128, n_positions=64, dim=32, n_layers=2,
                 n_heads=4, n_kv_heads=2, intermediate_size=64,
                 rope_theta=10000.0, tie_embeddings=False)
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def from_hf_config(hf) -> "LlamaConfig":
        raise NotImplementedError(
            f"LlamaConfig.from_hf_config is not ported yet ({HF_ITEM})")


def llama_from_hf_state(state, cfg: LlamaConfig):
    raise NotImplementedError(
        f"loading a Hugging Face Llama state dict is not ported yet "
        f"({HF_ITEM})")


def llama_to_hf_state(params, cfg: LlamaConfig):
    raise NotImplementedError(
        f"exporting to a Hugging Face Llama state dict is not ported yet "
        f"({HF_ITEM})")


def llama3_scaled_inv_freq(cfg: LlamaConfig, device=None):
    """Rope inverse frequencies [head_dim / 2] (f32) with llama3's
    wavelength-dependent scaling (HF ``_compute_llama3_parameters``):
    high-frequency lanes keep their period, low-frequency ones stretch
    by ``factor``, the band between interpolates. Unscaled without
    ``rope_scaling``."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, hd, 2, dtype=torch.float32, device=device) / hd))
    if cfg.rope_scaling is None:
        return inv
    factor, low_f, high_f, orig_max = cfg.rope_scaling
    low_wavelen = orig_max / low_f
    high_wavelen = orig_max / high_f
    wavelen = 2.0 * math.pi / inv
    smooth = ((orig_max / wavelen - low_f) / (high_f - low_f)).clamp(0.0,
                                                                     1.0)
    scaled = (1.0 - smooth) * inv / factor + smooth * inv
    out = torch.where(wavelen > low_wavelen, inv / factor, inv)
    return torch.where((wavelen <= low_wavelen) & (wavelen >= high_wavelen),
                       scaled, out)


def llama_rope_tables(positions, cfg: LlamaConfig):
    """(cos, sin) of this config at integer ``positions``: the one place
    the forward takes rope from."""
    return rope_cos_sin(positions, cfg.head_dim, theta=cfg.rope_theta,
                        inv_freq=llama3_scaled_inv_freq(
                            cfg, device=positions.device))


def llama_init(generator: torch.Generator, cfg: LlamaConfig):
    """Random f32 Llama params on ``generator.device``, drawn like the
    JAX package's ``llama_init`` (tok ~ N(0, 0.02), Kaiming-uniform
    linears without biases, unit RMSNorms, MoE experts as ``moe_init``)
    but from torch's RNG: parity goes through
    :mod:`quintnet_tpu_torch.bridge`."""
    dev = generator.device
    L, D, hd = cfg.n_layers, cfg.dim, cfg.head_dim

    def w(i, o, lead=(L,)):
        return {"w": linear_init(generator, i, o, lead=lead)["w"]}

    blocks: Dict[str, Any] = {
        "ln1": rms_norm_init(D, lead=(L,), device=dev),
        "attn": {"q": w(D, cfg.n_heads * hd), "k": w(D, cfg.n_kv_heads * hd),
                 "v": w(D, cfg.n_kv_heads * hd),
                 "o": w(cfg.n_heads * hd, D)},
        "ln2": rms_norm_init(D, lead=(L,), device=dev),
    }
    if cfg.n_experts > 0:
        blocks["moe"] = moe_init(generator, D, cfg.intermediate_size,
                                 cfg.n_experts, expert_type="swiglu",
                                 lead=(L,))
    else:
        blocks["mlp"] = swiglu_init(generator, D, cfg.intermediate_size,
                                    lead=(L,))
    params = {
        "embedding": {"tok": torch.randn((cfg.table_vocab_size, D),
                                         generator=generator,
                                         device=dev) * 0.02},
        "blocks": blocks,
        "head": {"ln_f": rms_norm_init(D, device=dev)},
    }
    if not cfg.tie_embeddings:
        params["head"]["lm"] = w(D, cfg.table_vocab_size, lead=())
    return params


def llama_upcycle_to_moe(params, cfg: LlamaConfig, generator=None):
    """Sparse upcycling: dense Llama params -> SwiGLU-MoE params for a
    config with ``n_experts > 0``: every expert a copy of the dense
    SwiGLU, the router near zero (N(0, 0.01) from ``generator``, a fresh
    one seeded 0 by default), as ``gpt2_upcycle_to_moe``."""
    if cfg.n_experts <= 0 or "moe" in params["blocks"]:
        return params
    E = cfg.n_experts
    blocks = dict(params["blocks"])
    mlp = blocks.pop("mlp")
    gate = mlp["gate"]["w"]
    if generator is None:
        generator = torch.Generator(device=gate.device).manual_seed(0)

    def per_expert(x):  # [L, D, H] -> [L, E, D, H]
        return x.detach()[:, None].expand(
            x.shape[0], E, *x.shape[1:]).clone()

    blocks["moe"] = {
        "router": {"w": 1e-2 * torch.randn(
            (gate.shape[0], cfg.dim, E), generator=generator,
            device=generator.device).to(gate.device)},
        "wg": per_expert(mlp["gate"]["w"]), "wu": per_expert(mlp["up"]["w"]),
        "wd": per_expert(mlp["down"]["w"])}
    return {**params, "blocks": blocks}


def llama_qkv(p_attn, a_in, cfg: LlamaConfig, cos, sin, *, tp: int = 1):
    """Normalised input [B, S, D] -> (q [B, Hq/tp, S, hd] rotated, k
    [B, Hkv/tp, S, hd] rotated, v): k and v NOT repeated (GQA)."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads} and "
            f"n_kv_heads={cfg.n_kv_heads} (Megatron head sharding)")
    b, s, _ = a_in.shape
    hd = cfg.head_dim

    def heads(name, n):
        return (a_in @ p_attn[name]["w"]).reshape(b, s, n, hd).transpose(
            1, 2)

    q = apply_rope(heads("q", cfg.n_heads // tp), cos, sin)
    k = apply_rope(heads("k", cfg.n_kv_heads // tp), cos, sin)
    return q, k, heads("v", cfg.n_kv_heads // tp)


def llama_attn_residual(p_attn, x, o, *, tp_axis=None):
    """Attention output [B, H, S, hd] -> o projection (one sum over tp)
    plus the residual."""
    b, _, s, _ = o.shape
    o = o.transpose(1, 2).reshape(b, s, -1)
    return x + row_parallel_linear(p_attn["o"], o, axis=tp_axis)


def llama_mlp_residual(p, x, cfg: LlamaConfig, *, tp_axis=None,
                       ep_axis=None, return_stats: bool = False):
    """-> (x + FFN(ln2(x)), moe aux), the aux 0 for a dense block; with
    ``return_stats`` also the MoE routing stats (None for a dense
    block)."""
    h = rms_norm_apply(p["ln2"], x, eps=cfg.rms_eps)
    if "moe" in p:
        y, aux, *stats = moe_apply(p["moe"], h, cfg.moe_args,
                                   ep_axis=ep_axis, tp_axis=tp_axis,
                                   return_stats=return_stats)
        return (x + y, aux, *stats)
    out = (x + swiglu_apply(p["mlp"], h, tp_axis=tp_axis),
           x.new_zeros((), dtype=torch.float32))
    return (*out, None) if return_stats else out


def llama_block_apply(p, x, cfg: LlamaConfig, *, cos, sin, tp_axis=None,
                      sp_axis=None, sp_mode: str = "ring",
                      use_flash: bool = False, ep_axis=None,
                      segment_ids=None):
    """One block: ``x`` for a dense config, ``(x, aux)`` for MoE. Causal
    attention on the GQA-repeated K/V: ``ops.flash_attention`` with
    ``use_flash``, else the plain ``sdpa``; with ``sp_axis`` (``x`` this
    rank's slice of the sequence, ``cos``/``sin`` at its global
    positions) by ``sp_mode``, after the repeat, so Ulysses splits the
    repeated heads."""
    tp = 1 if tp_axis is None else tp_axis.size
    a_in = rms_norm_apply(p["ln1"], x, eps=cfg.rms_eps)
    q, k, v = llama_qkv(p["attn"], a_in, cfg, cos, sin, tp=tp)
    rep = q.shape[1] // k.shape[1]
    k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    if sp_axis is not None:
        o = sp_attention(q, k, v, sp_axis=sp_axis, sp_mode=sp_mode,
                         causal=True, use_flash=use_flash,
                         segment_ids=segment_ids)
    else:
        attend = flash_attention if use_flash else sdpa
        o = attend(q, k, v, causal=True, segment_ids=segment_ids)
    x = llama_attn_residual(p["attn"], x, o, tp_axis=tp_axis)
    x, aux = llama_mlp_residual(p, x, cfg, tp_axis=tp_axis, ep_axis=ep_axis)
    return (x, aux) if cfg.n_experts > 0 else x


def llama_block_prefill(p, x, cfg: LlamaConfig, cos, sin, tp_axis=None):
    """Causal block forward that also returns this layer's UNrepeated
    (k, v) [B, Hkv(/tp), S, hd] for the decode cache (plain attention on
    the repeated K/V). Under ``tp_axis`` the heads are this rank's, with
    one sum over tp in the residual."""
    tp = 1 if tp_axis is None else tp_axis.size
    a_in = rms_norm_apply(p["ln1"], x, eps=cfg.rms_eps)
    q, k, v = llama_qkv(p["attn"], a_in, cfg, cos, sin, tp=tp)
    rep = q.shape[1] // k.shape[1]
    o = sdpa(q, repeat_kv(k, rep), repeat_kv(v, rep), causal=True)
    x = llama_attn_residual(p["attn"], x, o, tp_axis=tp_axis)
    x, _aux = llama_mlp_residual(p, x, cfg, tp_axis=tp_axis)
    return x, (k, v)


def llama_block_decode(p, x, kc, vc, pos, cfg: LlamaConfig, cos, sin,
                       tp_axis=None, ep_axis=None, block_tables=None,
                       block_size=None, kv_scales=None, policy=None):
    """One cached token: ``x`` [B, 1, D] -> (x, caches).

    Dense (``block_tables=None``, the generation decoders): caches [B,
    Hkv(/tp), T, hd] UNrepeated, ``pos`` the host write position,
    ``cos``/``sin`` the rope tables at ``pos``; the caches are written in
    place and repeated on read, the query attends to positions ``<=
    pos`` (plain attention, as the JAX dense branch) -> (x, (kc, vc)).

    Paged (``block_tables`` [B, M], the serving engine): caches are flat
    pool views [N_blocks*block_size, Hkv(/tp), hd] of UNrepeated kv
    heads, ``pos`` [B] int32 per-row positions, ``cos``/``sin`` [B, 1,
    1, hd] per-row rope tables; ``ops.paged_attention`` takes the GQA
    group. ``kv_scales``/``policy``: a scaled KV layout
    (``serve/kv_quant.py``). ``ep_axis``: a MoE block's experts sharded
    over ep. -> (x, (kc, vc[, k_scale, v_scale][, moe_stats]))."""
    tp = 1 if tp_axis is None else tp_axis.size
    a_in = rms_norm_apply(p["ln1"], x, eps=cfg.rms_eps)
    q, k, v = llama_qkv(p["attn"], a_in, cfg, cos, sin, tp=tp)
    if block_tables is not None:
        o, *pools = paged_attend_decode(
            q, k, v, kc, vc, pos, block_tables=block_tables,
            block_size=block_size, kv_scales=kv_scales, policy=policy)
        return _paged_block_out(p, x, o, pools, cfg, tp_axis, ep_axis)
    if kv_scales is not None:
        raise ValueError(
            "scaled KV layout policies exist only for the paged pool "
            "(block_tables is required)")
    kc[:, :, pos] = k[:, :, 0].to(kc.dtype)
    vc[:, :, pos] = v[:, :, 0].to(vc.dtype)
    rep = q.shape[1] // kc.shape[1]
    o = dense_cache_attend(q, repeat_kv(kc, rep), repeat_kv(vc, rep), pos)
    x = llama_attn_residual(p["attn"], x, o, tp_axis=tp_axis)
    x, _aux = llama_mlp_residual(p, x, cfg, tp_axis=tp_axis)
    return x, (kc, vc)


def _paged_block_out(p, x, o, pools, cfg, tp_axis, ep_axis):
    """The paged blocks' tail: o projection and residual, the FFN, and
    (x, pools[ + (moe stats,)])."""
    x = llama_attn_residual(p["attn"], x, o, tp_axis=tp_axis)
    x, _aux, stats = llama_mlp_residual(p, x, cfg, tp_axis=tp_axis,
                                        ep_axis=ep_axis, return_stats=True)
    return x, (tuple(pools) if stats is None else (*pools, stats))


def llama_block_prefill_paged(p, x, kc, vc, positions, tail_len,
                              cfg: LlamaConfig, cos, sin, tp_axis=None,
                              ep_axis=None, block_tables=None,
                              block_size=None, kv_scales=None, policy=None):
    """Chunked prefill over the paged pool (the serve engine's
    prefix-cached path): x [1, P, D] tail hidden states at absolute
    ``positions`` [P], caches flat pool views [N_blocks*block_size,
    Hkv(/tp), hd]; ``cos``/``sin`` [P, hd] at the SAME positions. The
    tail's UNrepeated (k, v) go through the request's table row
    ``block_tables`` [M] and each query attends causally to the whole row
    (``nn/attention.paged_attend_prefill``). -> (x, (kc, vc[, k_scale,
    v_scale][, moe_stats]))."""
    tp = 1 if tp_axis is None else tp_axis.size
    a_in = rms_norm_apply(p["ln1"], x, eps=cfg.rms_eps)
    q, k, v = llama_qkv(p["attn"], a_in, cfg, cos, sin, tp=tp)
    o, *pools = paged_attend_prefill(
        q, k, v, kc, vc, positions, tail_len, block_tables=block_tables,
        block_size=block_size, kv_scales=kv_scales, policy=policy)
    return _paged_block_out(p, x, o, pools, cfg, tp_axis, ep_axis)


def llama_block_prefill_paged_sp(p, x, kc, vc, start: int, t0: int,
                                 cfg: LlamaConfig, cos, sin, *, sp_axis,
                                 tp_axis=None, block_tables=None,
                                 block_size=None, kv_scales=None,
                                 policy=None):
    """Sequence-parallel chunked prefill block: x [1, Pl, D] is this sp
    rank's slice of the chunk, ``cos``/``sin`` [Pl, hd] at the rank's
    absolute positions (``start + rank*Pl + arange(Pl)``). Attention is
    ``nn/attention.ring_paged_prefill`` (the UNrepeated K/V on the wire,
    one all-gather for the sp-replicated pool write). -> (x, (kc, vc[,
    k_scale, v_scale]))."""
    tp = 1 if tp_axis is None else tp_axis.size
    a_in = rms_norm_apply(p["ln1"], x, eps=cfg.rms_eps)
    q, k, v = llama_qkv(p["attn"], a_in, cfg, cos, sin, tp=tp)
    o, *pools = ring_paged_prefill(
        q, k, v, start, t0, kc, vc, sp_axis=sp_axis,
        block_tables=block_tables, block_size=block_size,
        kv_scales=kv_scales, policy=policy)
    x = llama_attn_residual(p["attn"], x, o, tp_axis=tp_axis)
    x, _aux = llama_mlp_residual(p, x, cfg, tp_axis=tp_axis)
    return x, tuple(pools)


def llama_block_verify_paged(p, x, kc, vc, positions, tail_lens,
                             cfg: LlamaConfig, cos, sin, tp_axis=None,
                             ep_axis=None, block_tables=None,
                             block_size=None, kv_scales=None, policy=None):
    """Batched draft-verify block step over the paged pool: x [S, P, D]
    per-slot runs at absolute ``positions`` [S, P], ``cos``/``sin`` [S,
    1, P, hd] at the same positions, ``block_tables`` [S, M]; columns at
    or beyond ``tail_lens[s]`` are pad (``nn/attention.
    paged_attend_verify``). -> (x, (kc, vc[, k_scale, v_scale][,
    moe_stats]))."""
    tp = 1 if tp_axis is None else tp_axis.size
    a_in = rms_norm_apply(p["ln1"], x, eps=cfg.rms_eps)
    q, k, v = llama_qkv(p["attn"], a_in, cfg, cos, sin, tp=tp)
    o, *pools = paged_attend_verify(
        q, k, v, kc, vc, positions, tail_lens, block_tables=block_tables,
        block_size=block_size, kv_scales=kv_scales, policy=policy)
    return _paged_block_out(p, x, o, pools, cfg, tp_axis, ep_axis)


def _positions(b, s, device, sp_axis=None):
    """Global position ids of a [b, s] batch: with ``sp_axis`` the local
    sequence is this rank's slice, starting at ``index * s`` (rope must
    see global positions, as ``gpt2_embed``'s table does)."""
    del b
    start = 0 if sp_axis is None else sp_axis.index * s
    return torch.arange(start, start + s, device=device)


def _blocks(blocks, h, cfg: LlamaConfig, *, tp_axis, ep_axis, remat,
            use_flash, sp_axis=None, sp_mode: str = "ring",
            segment_ids=None, fsdp=None):
    """The stacked blocks over ``h``: ``h``, or ``(h, aux)`` for MoE."""
    cos, sin = llama_rope_tables(
        _positions(*h.shape[:2], h.device, sp_axis), cfg)
    body = functools.partial(llama_block_apply, cfg=cfg, cos=cos, sin=sin,
                             tp_axis=tp_axis, sp_axis=sp_axis,
                             sp_mode=sp_mode, use_flash=use_flash,
                             ep_axis=ep_axis, segment_ids=segment_ids)
    return stacked_blocks_apply(
        blocks, h, remat=remat, moe_args=cfg.moe_args, fsdp=fsdp,
        sp_axis=sp_axis, body_fn=lambda p, x, generator: body(p, x))


def llama_hidden(params, input_ids, cfg: LlamaConfig, *, tp_axis=None,
                 sp_axis=None, sp_mode: str = "ring", ep_axis=None,
                 remat=False, use_flash: bool = False, fsdp=None):
    """-> (final hidden states [B, S, D], moe aux total: 0 for dense).
    ``sp_axis``: the ids are this rank's slice of the sequence;
    ``cfg.vocab_parallel`` with ``tp_axis``: ``tok`` is this rank's rows
    of the table."""
    h = vocab_parallel_embedding({"table": params["embedding"]["tok"]},
                                 input_ids, axis=vocab_axis(cfg, tp_axis))
    out = _blocks(params["blocks"], h, cfg, tp_axis=tp_axis,
                  ep_axis=ep_axis, remat=remat, use_flash=use_flash,
                  sp_axis=sp_axis, sp_mode=sp_mode,
                  segment_ids=segment_ids_from_input(input_ids, cfg,
                                                     sp_axis=sp_axis),
                  fsdp=fsdp)
    return out if cfg.n_experts > 0 else (out, h.new_zeros(
        (), dtype=torch.float32))


def llama_logits(params, h, cfg: LlamaConfig):
    """ln_f and the lm head (tied: ``tok``^T), f32; a padded vocab's
    columns masked on a full-width table (a vocab-sharded one gives this
    rank's columns, masked by ``clm_loss_vp``)."""
    h = rms_norm_apply(params["head"]["ln_f"], h, eps=cfg.rms_eps)
    w = (params["embedding"]["tok"].T if cfg.tie_embeddings
         else params["head"]["lm"]["w"])
    logits = (h @ w).float()
    if cfg.padded_vocab_size and logits.shape[-1] == cfg.table_vocab_size:
        logits = mask_padded_cols(logits, cfg)
    return logits


def llama_apply(params, input_ids, cfg: LlamaConfig, *, tp_axis=None,
                sp_axis=None, sp_mode: str = "ring", ep_axis=None,
                remat=False, use_flash: bool = False):
    """[B, S] ids -> [B, S, V] f32 logits (the aux loss dropped)."""
    h, _ = llama_hidden(params, input_ids, cfg, tp_axis=tp_axis,
                        sp_axis=sp_axis, sp_mode=sp_mode, ep_axis=ep_axis,
                        remat=remat, use_flash=use_flash)
    return llama_logits(params, h, cfg)


# ---------------------------------------------------------------------
# sharding and the strategy's model
# ---------------------------------------------------------------------

def llama_partition_specs(cfg: Optional[LlamaConfig] = None, *,
                          tp_axis: Optional[str] = "tp",
                          pp_axis: Optional[str] = None,
                          ep_axis: Optional[str] = None,
                          fsdp_axis: Optional[str] = None):
    """The spec tree of :func:`llama_init`'s params (``parallel/tp.py``):
    q/k/v, gate and up column-sharded over ``tp_axis``, o and down
    row-sharded, the experts over ``ep_axis``, the stacked depth over
    ``pp_axis`` and, with ``fsdp_axis``, one free dim of each block leaf
    over it; the embedding, the norms and the head replicated, or with
    ``cfg.vocab_parallel`` the table's rows (an untied head's columns)
    over ``tp_axis``."""
    from quintnet_tpu_torch.parallel.tp import fsdp_shard_specs

    t = tp_axis
    col, row, rep = (pp_axis, None, t), (pp_axis, t, None), (pp_axis, None)
    blocks: Dict[str, Any] = {
        "ln1": {"scale": rep},
        "attn": {"q": {"w": col}, "k": {"w": col}, "v": {"w": col},
                 "o": {"w": row}},
        "ln2": {"scale": rep},
    }
    if cfg is not None and cfg.n_experts > 0:
        blocks["moe"] = moe_specs(ep_axis=ep_axis, tp_axis=t, stacked=True,
                                  pp_axis=pp_axis, expert_type="swiglu")
    else:
        blocks["mlp"] = {"gate": {"w": col}, "up": {"w": col},
                         "down": {"w": row}}
    if fsdp_axis is not None:
        blocks = fsdp_shard_specs(blocks, fsdp_axis)
    vp = cfg is not None and cfg.vocab_parallel and t is not None
    specs = {"embedding": {"tok": (t, None) if vp else ()}, "blocks": blocks,
             "head": {"ln_f": {"scale": ()}}}
    if cfg is None or not cfg.tie_embeddings:
        specs["head"]["lm"] = {"w": (None, t) if vp else ()}
    return specs


def _validate_tp(cfg: LlamaConfig, tp: int, params):
    """The tp layout: the identity (separate q/k/v need no reblocking),
    after the checks that tp can take this config."""
    if tp > 1:
        check_vocab_split(cfg, tp)
        if cfg.n_heads % tp or cfg.n_kv_heads % tp:
            raise ValueError(
                f"tp={tp} must divide n_heads={cfg.n_heads} and "
                f"n_kv_heads={cfg.n_kv_heads} (Megatron head sharding)")
    return params


def llama_model_spec(cfg: LlamaConfig, *, remat=False, use_flash: bool = False,
                     sp_mode: str = "ring", compute_dtype=None):
    """The training model (``parallel/strategy.ModelSpec``):
    ``loss_fn(params, (input_ids, labels), generator=None, *,
    tp_axis=None, fsdp_axis=None, ep_axis=None, sp_axis=None)``, the CLM
    loss plus a MoE config's aux loss; ``pipeline_fns(tp_axis=None,
    ep_axis=None, sp_axis=None)`` for ``parallel/pp.py`` (tied
    embeddings: the table's two partial gradients, stage 0's and the
    last stage's, add up over pp in ``reduce_grads``). ``sp_axis``: the
    batch's sequence sharded over sp (``batch_specs``), attention by
    ``sp_mode``, the loss :func:`~quintnet_tpu_torch.models.gpt2.
    clm_loss_sp` (in the pipelines a ``SplitHead``'s reduce part);
    ``cfg.vocab_parallel`` with ``tp_axis``: the vocab-sharded table and
    ``clm_loss_vp`` (a ``SplitHead`` too). Llama has no dropout (the generator is ignored).
    ``compute_dtype`` (``torch.bfloat16``; None is f32) casts the f32
    parameters once a call, the MoE router kept f32; logits and the loss
    are f32."""
    from quintnet_tpu_torch.parallel.strategy import ModelSpec
    from quintnet_tpu_torch.parallel.tp import axis_name, fsdp_info

    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' is not ported; use remat=True or False "
            f"({REMAT_DOTS_ITEM})")
    cfg.moe_args  # noqa: B018  (refuses expert_choice here, not later)

    def cast(p):
        return cast_floating(p, compute_dtype, exclude=keep_router_f32)

    def loss_fn(params, batch, generator=None, *, tp_axis=None,
                fsdp_axis=None, ep_axis=None, sp_axis=None):
        input_ids, labels = batch
        fsdp = fsdp_info(functools.partial(llama_partition_specs, cfg),
                         fsdp_axis, tp_axis=axis_name(tp_axis),
                         ep_axis=axis_name(ep_axis))
        p = cast(params)
        h, aux = llama_hidden(p, input_ids, cfg, tp_axis=tp_axis,
                              sp_axis=sp_axis, sp_mode=sp_mode,
                              ep_axis=ep_axis, remat=remat,
                              use_flash=use_flash, fsdp=fsdp)
        logits = llama_logits(p, h, cfg)
        if vocab_axis(cfg, tp_axis) is not None:
            return _vp_loss(cfg, logits, labels, tp_axis, sp_axis) + aux
        if sp_axis is not None:
            return clm_loss_sp(logits, labels, sp_axis=sp_axis) + aux
        return clm_loss(logits, labels) + aux

    def pipeline_fns(tp_axis=None, ep_axis=None, sp_axis=None):
        if cfg.segment_eos_id is not None:
            raise NotImplementedError(
                "segment_eos_id under pipeline parallelism is not wired "
                "(stage fns receive hidden states, not token ids); use "
                "dp/tp/ep meshes for packed-document isolation")
        vp_axis = vocab_axis(cfg, tp_axis)

        def embed_fn(params, input_ids, generator=None):
            return vocab_parallel_embedding(
                {"table": cast(params["embedding"])["tok"]}, input_ids,
                axis=vp_axis)

        def stage_fn(blocks_local, h, generator=None):
            return _blocks(cast(blocks_local), h, cfg, tp_axis=tp_axis,
                           ep_axis=ep_axis, remat=remat, use_flash=use_flash,
                           sp_axis=sp_axis, sp_mode=sp_mode)

        def head_logits(params, h, labels):
            p = cast({k: params[k] for k in ("embedding", "head")})
            return llama_logits(p, h, cfg)

        if sp_axis is not None or vp_axis is not None:
            from quintnet_tpu_torch.parallel.pp import SplitHead

            return embed_fn, stage_fn, SplitHead(
                head_logits, lambda logits, labels, valid: sp_head_loss(
                    logits, labels, valid, sp_axis, cfg=cfg,
                    vp_axis=vp_axis))

        def head_loss_fn(params, h, labels):
            return clm_loss(head_logits(params, h, labels), labels)

        return embed_fn, stage_fn, head_loss_fn

    return ModelSpec(
        init=lambda generator: llama_init(generator, cfg),
        loss_fn=loss_fn, depth=cfg.n_layers, needs_rng=False,
        partition_specs=lambda tp_axis=None, pp_axis=None, fsdp_axis=None,
        ep_axis=None: llama_partition_specs(
            cfg, tp_axis=tp_axis, pp_axis=pp_axis, ep_axis=ep_axis,
            fsdp_axis=fsdp_axis),
        to_tp_layout=lambda p, tp: _validate_tp(cfg, tp, p),
        pipeline_fns=pipeline_fns, batch_specs=sequence_batch_specs)

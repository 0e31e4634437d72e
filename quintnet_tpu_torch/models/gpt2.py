"""GPT-2 (124M "base" through XL): config, init, forward and CLM loss.

Port of ``quintnet_tpu/models/gpt2.py`` (dense and MoE, with the tp and
ep hooks). Parameters keep the JAX pytree layout::

    {"embedding": {"wte": [V, D], "wpe": [T, D]},
     "blocks": {"ln1", "attn": {"qkv", "proj"}, "ln2", "mlp": {"fc",
                "proj"}}      # every leaf stacked [L, ...]
     "head": {"ln_f": {"scale", "bias"}}}

with linear weights ``[in, out]`` and the lm head tied to ``wte``; with
``n_experts > 0`` each block's ``mlp`` is a MoE FFN ``moe`` (``{"router":
{"w"}, "w1", "b1", "w2", "b2"}``, the expert dim after the layer dim:
``nn/moe.py``) whose load-balance loss joins the CLM loss.
:func:`gpt2_apply` is the dense causal forward — the oracle the paged
serving path is held to on the card; :func:`gpt2_model_spec` is the
training model (forward, CLM loss, dropout from a ``torch.Generator``,
optional flash attention and remat) on one device or, with ``tp_axis``,
on this rank's tp shards (:func:`gpt2_partition_specs`: the blocks
Megatron-sharded in the tp-blocked qkv layout of
:func:`gpt2_to_tp_layout`, the experts over ep, and their depth cut over
pp, embeddings,
LayerNorms and the tied head replicated; under ZeRO-3/FSDP the blocks
are also sharded over dp and gathered layer by layer);
:func:`gpt2_pipeline_fns` is the same model cut into pipeline stages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.nn.attention import mha_init
from quintnet_tpu_torch.nn.layers import (cast_floating, dropout, gelu,
                                          keep_router_f32, layer_norm_apply,
                                          layer_norm_init, linear_init)
from quintnet_tpu_torch.nn.moe import MoEArgs, moe_init
from quintnet_tpu_torch.nn.transformer import (REMAT_DOTS_ITEM,
                                               stacked_blocks_apply)

IGNORE_INDEX = -100  # labels at -100 carry no loss (prompt and padding)


def _cast_tree(tree, dtype):
    """The mixed-precision cast, the MoE router kept at f32 (its gate
    order is bf16-sensitive)."""
    return cast_floating(tree, dtype, exclude=keep_router_f32)


@dataclass(frozen=True)
class GPT2Config:
    """Sizes follow the reference presets. Training fields: ``dropout``
    and the per-site rates (None falls back to ``dropout``),
    ``loss_chunk`` (CLM loss in sequence chunks of this many positions,
    0 = off) and ``segment_eos_id`` (packed-document isolation: a new
    attention segment starts after each such token). MoE: ``n_experts``
    (0 is dense), ``expert_top_k``, ``capacity_factor``,
    ``expert_capacity`` (a rank's capacity an expert, None: from the
    factor), ``aux_loss_weight``, ``router_z_weight`` and
    ``router_type`` (``"topk"``; ``"expert_choice"`` is non-causal and
    refused by :attr:`moe_args`). :meth:`from_dict` keeps every field
    named here and drops the JAX config's other keys (sequence
    parallelism). ``vocab_parallel`` is carried so that a tp run that
    asks for it raises (ROADMAP.md §1, item 6b)."""

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
    # MoE (0 = dense); serving refuses it (serve/families.py)
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    expert_capacity: Optional[int] = None
    aux_loss_weight: float = 1e-2
    router_z_weight: float = 0.0
    router_type: str = "topk"
    padded_vocab_size: Optional[int] = None
    vocab_parallel: bool = False

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
    def moe_args(self) -> Optional[MoEArgs]:
        """``nn/moe.MoEArgs`` of this config, or None when dense."""
        if self.n_experts <= 0:
            return None
        if self.router_type == "expert_choice":
            # expert choice selects over the whole flattened sequence:
            # position t would see later positions
            raise ValueError(
                "expert_choice routing is non-causal and unsupported "
                "for the causal LM families; use router_type='topk' "
                "(expert_choice remains available at the nn/moe.py "
                "layer for non-autoregressive models)")
        return MoEArgs(n_experts=self.n_experts, top_k=self.expert_top_k,
                       capacity_factor=self.capacity_factor,
                       capacity=self.expert_capacity,
                       aux_weight=self.aux_loss_weight,
                       z_weight=self.router_z_weight,
                       router=self.router_type)

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
    }
    if cfg.n_experts > 0:
        blocks["moe"] = moe_init(generator, D, cfg.mlp_hidden,
                                 cfg.n_experts, lead=(L,))
    else:
        blocks["mlp"] = {
            "fc": linear_init(generator, D, cfg.mlp_hidden, lead=(L,)),
            "proj": linear_init(generator, cfg.mlp_hidden, D, lead=(L,))}
    return {
        "embedding": {"wte": normal((cfg.table_vocab_size, D), 0.02),
                      "wpe": normal((cfg.n_positions, D), 0.01)},
        "blocks": blocks,
        "head": {"ln_f": layer_norm_init(D, device=dev)},
    }


def gpt2_upcycle_to_moe(params, cfg: GPT2Config, generator=None):
    """Sparse upcycling: dense GPT-2 params -> MoE params for a config
    with ``n_experts > 0``. Every expert starts as a copy of the dense
    MLP and the router near zero (N(0, 0.01) from ``generator``, a fresh
    one seeded 0 by default), so routing starts near uniform and the
    model near the dense one. A dense config or MoE params come back as
    they are."""
    if cfg.n_experts <= 0 or "moe" in params["blocks"]:
        return params
    E = cfg.n_experts
    blocks = dict(params["blocks"])
    mlp = blocks.pop("mlp")
    w = mlp["fc"]["w"]
    if generator is None:
        generator = torch.Generator(device=w.device).manual_seed(0)

    def per_expert(x):  # [L, ...] -> [L, E, ...]
        return x.detach()[:, None].expand(
            x.shape[0], E, *x.shape[1:]).clone()

    blocks["moe"] = {
        "router": {"w": 1e-2 * torch.randn(
            (w.shape[0], cfg.n_embd, E), generator=generator,
            device=generator.device).to(w.device)},
        "w1": per_expert(mlp["fc"]["w"]), "b1": per_expert(mlp["fc"]["b"]),
        "w2": per_expert(mlp["proj"]["w"]),
        "b2": per_expert(mlp["proj"]["b"])}
    return {**params, "blocks": blocks}


def gpt2_embed(params, input_ids, *, sp_axis=None, embd_pdrop: float = 0.0,
               generator=None):
    """[B, T] ids -> token + position embeddings [B, T, D]; with
    ``generator``, dropout at ``embd_pdrop`` on the sum. ``sp_axis`` (a
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`): the ids are this
    rank's slice of the sequence, whose positions start at ``index *
    T``."""
    emb = params["embedding"]
    T = input_ids.shape[-1]
    start = 0 if sp_axis is None else sp_axis.index * T
    h = emb["wte"][input_ids] + emb["wpe"][start:start + T][None]
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


def segment_ids_from_input(input_ids, cfg: GPT2Config, *, sp_axis=None):
    """[B, S] token ids -> [B, S] int32 attention segment ids, or None
    when ``cfg.segment_eos_id`` is unset: the exclusive running count of
    the separator (each EOS closes its own document). ``sp_axis``: the
    ids are this rank's slice of the sequence, and the count is offset by
    the separators of every earlier slice (one [sp, B] all-gather), so
    the ids are global and the sp attentions compare them across
    chunks."""
    if cfg.segment_eos_id is None:
        return None
    is_eos = (input_ids == cfg.segment_eos_id).to(torch.int32)
    seg = torch.cumsum(is_eos, dim=1, dtype=torch.int32) - is_eos
    if sp_axis is not None:
        counts = cc.all_gather(is_eos.sum(dim=1, dtype=torch.int32),
                               sp_axis, gather_dim=0, tiled=False)  # [sp, B]
        seg = seg + counts[:sp_axis.index].sum(dim=0,
                                               dtype=torch.int32)[:, None]
    return seg


def gpt2_blocks(params_blocks, h, cfg: GPT2Config, *, tp_axis=None,
                sp_axis=None, sp_mode: str = "ring", ep_axis=None,
                remat=False, use_flash: bool = False, generator=None,
                segment_ids=None, fsdp=None):
    """The stacked causal blocks: ``h``, or ``(h, moe_aux)`` when
    ``cfg.n_experts > 0``. ``generator`` enables training dropout. With
    ``tp_axis`` (a :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`) the
    blocks are this rank's tp shards and attention runs on ``n_head /
    tp`` local heads; ``ep_axis``: the experts are this rank's ep shard.
    ``fsdp``: ``(axis, gather dims)`` of dp-sharded blocks
    (:func:`_fsdp_info`, ``stacked_blocks_apply``). ``sp_axis``: ``h`` is
    this rank's slice of the sequence, attended by ``sp_mode``."""
    tp = 1 if tp_axis is None else tp_axis.size
    _, attn_p, resid_p = cfg.pdrops
    return stacked_blocks_apply(
        params_blocks, h, num_heads=cfg.n_head // tp, causal=True, act=gelu,
        tp_axis=tp_axis, sp_axis=sp_axis, sp_mode=sp_mode,
        use_flash=use_flash, remat=remat,
        moe_args=cfg.moe_args, ep_axis=ep_axis,
        attn_pdrop=attn_p, resid_pdrop=resid_p, generator=generator,
        segment_ids=segment_ids, fsdp=fsdp)


def gpt2_hidden(params, input_ids, cfg: GPT2Config, *, tp_axis=None,
                sp_axis=None, sp_mode: str = "ring", ep_axis=None,
                remat=False, use_flash: bool = False, generator=None,
                fsdp=None):
    """embed + blocks -> (final hidden states [B, T, D], moe_aux), the
    aux 0 for a dense config: the pre-head half of :func:`gpt2_forward`
    (the chunked loss starts from here)."""
    if generator is not None and not cfg.needs_dropout:
        generator = None
    h = gpt2_embed(params, input_ids, sp_axis=sp_axis,
                   embd_pdrop=cfg.pdrops[0], generator=generator)
    out = gpt2_blocks(params["blocks"], h, cfg, tp_axis=tp_axis,
                      sp_axis=sp_axis, sp_mode=sp_mode, ep_axis=ep_axis,
                      remat=remat, use_flash=use_flash, generator=generator,
                      segment_ids=segment_ids_from_input(input_ids, cfg,
                                                         sp_axis=sp_axis),
                      fsdp=fsdp)
    return out if cfg.n_experts > 0 else (out, h.new_zeros(
        (), dtype=torch.float32))


def gpt2_forward(params, input_ids, cfg: GPT2Config, *, tp_axis=None,
                 sp_axis=None, sp_mode: str = "ring", ep_axis=None,
                 remat=False, use_flash: bool = False, generator=None,
                 fsdp=None):
    """-> (logits [B, T, V] f32, moe_aux). ``generator``: training
    dropout (None is eval). ``tp_axis``: the params are this rank's tp
    shards; the logits come out whole (the tied head is replicated).
    ``sp_axis``: the ids are this rank's slice of the sequence and so are
    the logits (attention by ``sp_mode``). ``ep_axis``: the experts are
    this rank's ep shard. ``fsdp``: the blocks are dp-sharded and
    gathered layer by layer."""
    h, aux = gpt2_hidden(params, input_ids, cfg, tp_axis=tp_axis,
                         sp_axis=sp_axis, sp_mode=sp_mode, ep_axis=ep_axis,
                         remat=remat, use_flash=use_flash,
                         generator=generator, fsdp=fsdp)
    return gpt2_logits(params, h, cfg), aux


def gpt2_apply(params, input_ids, cfg: GPT2Config, *, sp_axis=None,
               sp_mode: str = "ring", use_flash: bool = False):
    """Eval-mode causal forward: [B, T] ids -> [B, T, V] f32 logits (with
    ``sp_axis``, this rank's slice of the sequence in and out)."""
    return gpt2_forward(params, input_ids, cfg, sp_axis=sp_axis,
                        sp_mode=sp_mode, use_flash=use_flash)[0]


def clm_loss(logits, labels):
    """Shifted causal-LM cross entropy with ``IGNORE_INDEX`` masking,
    mean over the valid targets."""
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    nll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                          targets.reshape(-1), ignore_index=IGNORE_INDEX,
                          reduction="sum")
    return nll / (targets != IGNORE_INDEX).sum().clamp_min(1)


def _sp_shift_targets(labels, sp_axis):
    """The next-token targets of this rank's slice of the sequence: its
    last position targets the FIRST label of the next rank's slice (one
    shift); the global last position (the last rank's last column)
    targets nothing."""
    first_next = cc.ppermute_shift(labels[:, :1].contiguous(), sp_axis,
                                   shift=-1, wrap=False)
    targets = torch.cat([labels[:, 1:], first_next], dim=1)
    if sp_axis.index == sp_axis.size - 1:
        targets[:, -1] = IGNORE_INDEX
    return targets


def clm_loss_sp(logits, labels, *, sp_axis):
    """The CLM loss with the sequence sharded over ``sp_axis``: the
    target shift crosses the slices (:func:`_sp_shift_targets`) and the
    mean is global (the sums of the NLL and of the valid targets over
    sp), so the value is :func:`clm_loss` on the gathered sequence."""
    targets = _sp_shift_targets(labels, sp_axis).long()
    nll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                          targets.reshape(-1), ignore_index=IGNORE_INDEX,
                          reduction="sum")
    total = cc.all_reduce(nll, sp_axis)
    count = cc.all_reduce((targets != IGNORE_INDEX).sum().float(), sp_axis)
    return total / count.clamp_min(1)


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


def gpt2_partition_specs(cfg: Optional[GPT2Config] = None, *,
                         tp_axis: Optional[str] = "tp",
                         pp_axis: Optional[str] = None,
                         ep_axis: Optional[str] = None,
                         fsdp_axis: Optional[str] = None):
    """The spec tree of :func:`gpt2_init`'s params (``parallel/tp.py``):
    blocks column/row-sharded over ``tp_axis`` and their stacked depth
    over ``pp_axis``, MoE experts over ``ep_axis`` (``nn/moe.moe_specs``),
    embeddings and the final LayerNorm replicated (the tied head reads
    ``wte`` whole, on the last stage as the embedding does on the
    first). ``fsdp_axis``: the blocks also sharded over it, one free dim
    a leaf (``parallel/tp.fsdp_shard_specs``). A vocab-parallel table
    (``cfg.vocab_parallel``) is not ported yet (ROADMAP.md §1, item
    6)."""
    from quintnet_tpu_torch.nn.moe import moe_specs
    from quintnet_tpu_torch.parallel.tp import block_specs, fsdp_shard_specs

    _check_mesh_options(cfg, tp_axis)
    bspecs = block_specs(tp_axis=tp_axis, stacked=True, pp_axis=pp_axis)
    if cfg is not None and cfg.n_experts > 0:
        del bspecs["mlp"]
        bspecs["moe"] = moe_specs(ep_axis=ep_axis, tp_axis=tp_axis,
                                  stacked=True, pp_axis=pp_axis)
    if fsdp_axis is not None:
        bspecs = fsdp_shard_specs(bspecs, fsdp_axis)
    return {
        "embedding": {"wte": (), "wpe": ()},
        "blocks": bspecs,
        "head": {"ln_f": {"scale": (), "bias": ()}},
    }


def _fsdp_info(cfg: GPT2Config, tp_axis, fsdp_axis, ep_axis=None):
    """``(fsdp_axis, gather dims)`` of the blocks, or None: the gather
    dims from the same specs that lay the shards out."""
    import functools

    from quintnet_tpu_torch.parallel.tp import axis_name, fsdp_info

    return fsdp_info(functools.partial(gpt2_partition_specs, cfg),
                     fsdp_axis, tp_axis=axis_name(tp_axis),
                     ep_axis=axis_name(ep_axis))


def _check_mesh_options(cfg, tp_axis) -> None:
    if cfg is not None and cfg.vocab_parallel and tp_axis is not None:
        raise NotImplementedError(
            "vocab_parallel GPT-2 under tp (the vocab-sharded table and "
            "clm_loss_vp) is not ported yet (ROADMAP.md §1, item 6b)")


def gpt2_to_tp_layout(params, cfg: GPT2Config, tp: int):
    """Standard [q|k|v] fused-QKV columns -> the tp-blocked layout
    (``parallel/tp.py``); a new tree sharing every other leaf. Identity
    at tp = 1."""
    from quintnet_tpu_torch.parallel.tp import tree_qkv_layout

    return tree_qkv_layout(params, cfg.n_head, tp)


def gpt2_from_tp_layout(params, cfg: GPT2Config, tp: int):
    """Inverse of :func:`gpt2_to_tp_layout`: back to the standard [q|k|v]
    columns (for export, and to compare a tp run's gathered params or
    gradients with a single-device run)."""
    from quintnet_tpu_torch.parallel.tp import tree_qkv_layout

    return tree_qkv_layout(params, cfg.n_head, tp, to_blocked=False)


def gpt2_pipeline_fns(cfg: GPT2Config, *, tp_axis=None, sp_axis=None,
                      sp_mode: str = "ring", ep_axis=None, remat=False,
                      use_flash: bool = False, compute_dtype=None):
    """``(embed_fn, stage_fn, head_loss_fn)`` for ``parallel/pp.py``:
    GPT-2 cut into the embedding (stage 0), this rank's stacked blocks
    (every stage; ``tp_axis`` a
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis` runs them on its tp
    shards, ``ep_axis`` its experts on its ep shard) and the tied head's
    CLM loss (the last stage; the chunked loss when ``cfg.loss_chunk >
    0``). A MoE config's ``stage_fn`` returns ``(h, aux)``: the
    schedules add every stage's aux to the loss. ``sp_axis``: every
    function sees this rank's slice of the sequence, and the head is a
    ``parallel/pp.SplitHead`` whose collective-free part computes the
    logits and whose reduce part, run on every stage, the loss over sp
    (:func:`clm_loss_sp`). ``compute_dtype`` casts
    the parameters each function reads at use (the router kept f32), as
    :func:`gpt2_model_spec` does. The ``generator`` keyword of the
    embedding and the stage drives dropout; the schedules hand each
    (micro-batch, stage) its own."""
    if cfg.segment_eos_id is not None:
        raise NotImplementedError(
            "segment_eos_id under pipeline parallelism is not wired "
            "(stage fns receive hidden states, not token ids, so the "
            "segment vector cannot be derived mid-pipeline); use "
            "dp/tp/ep meshes for packed-document isolation")
    _check_mesh_options(cfg, tp_axis)

    def part(params, *keys):
        return _cast_tree({k: params[k] for k in keys}, compute_dtype)

    def embed_fn(params, input_ids, generator=None):
        return gpt2_embed(part(params, "embedding"), input_ids,
                          sp_axis=sp_axis, embd_pdrop=cfg.pdrops[0],
                          generator=generator if cfg.needs_dropout else None)

    def stage_fn(blocks_local, h, generator=None):
        return gpt2_blocks(_cast_tree(blocks_local, compute_dtype), h, cfg,
                           tp_axis=tp_axis, sp_axis=sp_axis, sp_mode=sp_mode,
                           ep_axis=ep_axis, remat=remat, use_flash=use_flash,
                           generator=generator if cfg.needs_dropout else None)

    if sp_axis is not None:
        from quintnet_tpu_torch.parallel.pp import SplitHead

        def head_local_fn(params, h, labels):
            return gpt2_logits(part(params, "embedding", "head"), h, cfg)

        return embed_fn, stage_fn, SplitHead(
            head_local_fn, lambda logits, labels, valid: sp_head_loss(
                logits, labels, valid, sp_axis))

    def head_loss_fn(params, h, labels):
        p = part(params, "embedding", "head")
        if cfg.loss_chunk > 0:
            return clm_loss_chunked(p, h, labels, cfg, chunk=cfg.loss_chunk)
        return clm_loss(gpt2_logits(p, h, cfg), labels)

    return embed_fn, stage_fn, head_loss_fn


def sp_head_loss(logits, labels, valid: bool, sp_axis):
    """A pipeline head's reduce part under sp: :func:`clm_loss_sp` (its
    collectives entered on every stage and tick), 0 where ``valid`` is
    False."""
    loss = clm_loss_sp(logits, labels, sp_axis=sp_axis)
    return loss if valid else torch.zeros_like(loss)


def sequence_batch_specs(batch_axes, sp_axis=None):
    """The (input_ids, labels) specs (``Strategy.shard_batch``): rows over
    the batch axes, the sequence over ``sp_axis`` (a name)."""
    spec = (tuple(batch_axes) or None, sp_axis)
    return (spec, spec)


def gpt2_model_spec(cfg: GPT2Config, *, remat=False, use_flash: bool = False,
                    sp_mode: str = "ring", compute_dtype=None):
    """The training model: ``init(generator)`` and ``loss_fn(params,
    batch, generator=None, *, tp_axis=None, fsdp_axis=None,
    ep_axis=None)`` over ``batch = (input_ids, labels)``, following the
    JAX ``gpt2_model_spec``'s loss: the chunked CLM loss when
    ``cfg.loss_chunk > 0``, else the full-logits one, plus the MoE aux
    loss of a MoE config. ``generator`` drives the dropout masks;
    ``tp_axis`` runs the blocks on this rank's tp shards
    (``partition_specs``, ``to_tp_layout``); ``ep_axis`` the experts on
    this rank's ep shard; ``fsdp_axis`` (ZeRO-3) on blocks also sharded
    over it, each layer gathered just before use; ``sp_axis`` (handed on
    a mesh with sp > 1) on this rank's slice of the sequence
    (``batch_specs``), attention by ``sp_mode`` (``"ring"``, ``"zigzag"``
    or ``"ulysses"``) and :func:`clm_loss_sp` (the chunked loss is not
    used under sp, as in JAX).

    On a pp mesh the strategy runs :func:`gpt2_pipeline_fns` instead
    of ``loss_fn``.

    ``compute_dtype`` (``torch.bfloat16``; None is f32): the parameters
    stay f32 and are cast once per ``loss_fn`` call (the MoE router kept
    f32), and that one tree feeds the embedding, the blocks and the tied
    head, as the JAX ``_cast_tree`` does (``wte``'s two cotangents then
    add up in the compute dtype before the cast brings them back to
    f32). Logits and the loss are f32.

    Not ported (each raises ``NotImplementedError`` naming its ROADMAP.md
    place): ``remat="dots"``, ``vocab_parallel`` under tp."""
    from quintnet_tpu_torch.parallel.strategy import ModelSpec

    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' is not ported; use remat=True or False "
            f"({REMAT_DOTS_ITEM})")
    cfg.moe_args  # noqa: B018  (refuses expert_choice here, not later)

    def loss_fn(params, batch, generator=None, *, tp_axis=None,
                fsdp_axis=None, ep_axis=None, sp_axis=None):
        input_ids, labels = batch
        if tp_axis is not None:
            _check_mesh_options(cfg, tp_axis)
        p = _cast_tree(params, compute_dtype)
        kw = dict(tp_axis=tp_axis, sp_axis=sp_axis, sp_mode=sp_mode,
                  ep_axis=ep_axis, remat=remat, use_flash=use_flash,
                  generator=generator,
                  fsdp=_fsdp_info(cfg, tp_axis, fsdp_axis, ep_axis))
        if cfg.loss_chunk > 0 and sp_axis is None:
            h, aux = gpt2_hidden(p, input_ids, cfg, **kw)
            return clm_loss_chunked(p, h, labels, cfg,
                                    chunk=cfg.loss_chunk) + aux
        logits, aux = gpt2_forward(p, input_ids, cfg, **kw)
        if sp_axis is not None:
            return clm_loss_sp(logits, labels, sp_axis=sp_axis) + aux
        return clm_loss(logits, labels) + aux

    return ModelSpec(
        init=lambda generator: gpt2_init(generator, cfg),
        loss_fn=loss_fn, depth=cfg.n_layer, needs_rng=cfg.needs_dropout,
        partition_specs=lambda tp_axis=None, pp_axis=None, fsdp_axis=None,
        ep_axis=None: gpt2_partition_specs(
            cfg, tp_axis=tp_axis, pp_axis=pp_axis, ep_axis=ep_axis,
            fsdp_axis=fsdp_axis),
        to_tp_layout=lambda p, tp: gpt2_to_tp_layout(p, cfg, tp),
        pipeline_fns=lambda tp_axis=None, ep_axis=None, sp_axis=None:
        gpt2_pipeline_fns(cfg, tp_axis=tp_axis, sp_axis=sp_axis,
                          sp_mode=sp_mode, ep_axis=ep_axis, remat=remat,
                          use_flash=use_flash, compute_dtype=compute_dtype),
        batch_specs=sequence_batch_specs)

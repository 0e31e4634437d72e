"""Vision Transformer for image classification (MNIST-scale).

Port of ``quintnet_tpu/models/vit.py`` (dense and MoE, with the tp and
ep hooks).
Parameters keep the JAX pytree layout::

    {"embedding": {"patch": {"w", "b"}, "cls": [1, 1, D],
                   "pos": [1, N + 1, D]},
     "blocks": {"ln1", "attn": {"qkv", "proj"}, "ln2", "mlp": {"fc",
                "proj"}}      # every leaf stacked [depth, ...]
     "head": {"ln": {"scale", "bias"}, "fc": {"w", "b"}}}

so :mod:`quintnet_tpu_torch.bridge` carries JAX weights over leaf for
leaf. The patch embedding is patchify plus one linear; the blocks are
pre-LN with a ReLU MLP and plain dense, non-causal attention, as the
reference runs them (no flash attention: at S = 17 and head dim 16 the
JAX package uses none either); the head reads the CLS position. With
``n_experts > 0`` each block's MLP is a MoE FFN (``nn/moe.py``; ViT is
not causal, so both routers, top-k and expert choice, are allowed) and
its load-balance loss joins the cross entropy.

With ``tp_axis`` the blocks run on this rank's tp shards
(:func:`vit_partition_specs`, :func:`vit_to_tp_layout`); the embedding
and the head are replicated (under ZeRO-3/FSDP the blocks are also
sharded over dp and gathered layer by layer);
:func:`vit_pipeline_fns` cuts the model
into pipeline stages (``parallel/pp.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from quintnet_tpu_torch.nn.attention import mha_init
from quintnet_tpu_torch.nn.moe import MoEArgs, moe_init
from quintnet_tpu_torch.nn.layers import (cast_floating, dropout,
                                          layer_norm_apply, layer_norm_init,
                                          linear_apply, linear_init,
                                          patchify)
from quintnet_tpu_torch.nn.transformer import stacked_blocks_apply
from quintnet_tpu_torch.train.metrics import accuracy

__all__ = ["ViTConfig", "accuracy", "cross_entropy_loss", "vit_apply",
           "vit_embed", "vit_forward", "vit_head", "vit_init",
           "vit_model_spec", "vit_partition_specs", "vit_pipeline_fns",
           "vit_to_tp_layout"]


@dataclass(frozen=True)
class ViTConfig:
    """The reference ViT's sizes (``examples/config.yaml``). ``dropout``
    is one rate for the embedding, attention and residual sites (the
    reference ViT has none: 0.0). MoE (``n_experts > 0``):
    ``expert_top_k``, ``capacity_factor``, ``expert_capacity``,
    ``aux_loss_weight`` and ``router_type`` (``"topk"`` or
    ``"expert_choice"``), as :class:`~quintnet_tpu_torch.models.gpt2.
    GPT2Config` has them."""

    image_size: int = 28
    patch_size: int = 7
    in_channels: int = 1
    hidden_dim: int = 64
    depth: int = 8
    num_heads: int = 4
    mlp_ratio: float = 4.0
    num_classes: int = 10
    dropout: float = 0.0
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    expert_capacity: Optional[int] = None
    aux_loss_weight: float = 1e-2
    router_type: str = "topk"

    @property
    def moe_args(self) -> Optional[MoEArgs]:
        """``nn/moe.MoEArgs`` of this config, or None when dense."""
        if self.n_experts <= 0:
            return None
        return MoEArgs(n_experts=self.n_experts, top_k=self.expert_top_k,
                       capacity_factor=self.capacity_factor,
                       capacity=self.expert_capacity,
                       aux_weight=self.aux_loss_weight,
                       router=self.router_type)

    @property
    def needs_dropout(self) -> bool:
        return self.dropout > 0.0

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_dim * self.mlp_ratio)

    @staticmethod
    def from_model_config(m) -> "ViTConfig":
        """From a ``core.config.ModelConfig`` (the fields of the same
        names)."""
        names = {f.name for f in dataclasses.fields(ViTConfig)}
        d = {k: v for k, v in dataclasses.asdict(m).items() if k in names}
        return ViTConfig(**d)


def vit_init(generator: torch.Generator, cfg: ViTConfig):
    """Random f32 ViT params on ``generator.device``, drawn like the JAX
    package's ``vit_init`` (Kaiming-uniform linears, cls and pos ~ N(0,
    0.02), unit LayerNorms) but from torch's RNG — the two never give the
    same numbers, so parity goes through :mod:`quintnet_tpu_torch.bridge`."""
    dev = generator.device
    L, D = cfg.depth, cfg.hidden_dim
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_channels

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    return {
        "embedding": {
            "patch": linear_init(generator, patch_dim, D),
            "cls": normal((1, 1, D), 0.02),
            "pos": normal((1, cfg.seq_len, D), 0.02),
        },
        "blocks": {
            "ln1": layer_norm_init(D, lead=(L,), device=dev),
            "attn": mha_init(generator, D, lead=(L,)),
            "ln2": layer_norm_init(D, lead=(L,), device=dev),
            **({"moe": moe_init(generator, D, cfg.mlp_hidden, cfg.n_experts,
                                lead=(L,))} if cfg.n_experts > 0 else
               {"mlp": {"fc": linear_init(generator, D, cfg.mlp_hidden,
                                          lead=(L,)),
                        "proj": linear_init(generator, cfg.mlp_hidden, D,
                                            lead=(L,))}}),
        },
        "head": {
            "ln": layer_norm_init(D, device=dev),
            "fc": linear_init(generator, D, cfg.num_classes),
        },
    }


def vit_embed(p_emb, images, patch_size: int, *, pdrop: float = 0.0,
              generator=None):
    """images [B, H, W, C] -> tokens [B, N + 1, D]: patch linear, the CLS
    token in front, position embeddings added; with ``generator``,
    dropout at ``pdrop`` on the sum."""
    x = linear_apply(p_emb["patch"], patchify(images, patch_size))
    cls = p_emb["cls"].expand(x.shape[0], 1, x.shape[-1]).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + p_emb["pos"].to(x.dtype)
    if generator is not None and pdrop > 0.0:
        x = dropout(generator, x, pdrop, deterministic=False)
    return x


def vit_head(p_head, x):
    """The CLS position -> logits (LayerNorm, then the classifier)."""
    return linear_apply(p_head["fc"], layer_norm_apply(p_head["ln"], x[:, 0]))


def vit_forward(params, images, cfg: ViTConfig, *, tp_axis=None,
                ep_axis=None, remat=False, compute_dtype=None,
                generator=None, fsdp=None):
    """[B, H, W, C] (or [B, C, H, W], detected by the channel count) ->
    ``(logits [B, num_classes] f32, moe_aux)``; ``moe_aux`` is 0 for a
    dense config, else the blocks' summed load-balance loss (experts on
    this rank's ep shard with ``ep_axis``). ``generator``: training dropout at
    ``cfg.dropout`` on the embedding, attention and residual sites, drawn
    in that order; None is eval. ``remat=True`` recomputes each block in
    backward (``torch.utils.checkpoint``). ``compute_dtype``
    (``torch.bfloat16``; None is f32) casts the images and the
    parameters at use; the logits come back in f32. ``tp_axis`` (a
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`): the blocks are this
    rank's tp shards, attention on ``num_heads / tp`` local heads.
    ``fsdp``: ``(axis, gather dims)`` of dp-sharded blocks
    (``stacked_blocks_apply``)."""
    images = _nhwc(images, cfg)
    if compute_dtype is not None:
        images = images.to(compute_dtype)
        params = cast_floating(params, compute_dtype)
    if generator is not None and not cfg.needs_dropout:
        generator = None
    x = vit_embed(params["embedding"], images, cfg.patch_size,
                  pdrop=cfg.dropout, generator=generator)
    tp = 1 if tp_axis is None else tp_axis.size
    out = stacked_blocks_apply(
        params["blocks"], x, num_heads=cfg.num_heads // tp, causal=False,
        act=torch.relu, tp_axis=tp_axis, remat=remat, moe_args=cfg.moe_args,
        ep_axis=ep_axis, attn_pdrop=cfg.dropout, resid_pdrop=cfg.dropout,
        generator=generator, fsdp=fsdp)
    x, aux = out if cfg.n_experts > 0 else (out, torch.zeros(
        (), device=x.device))
    return vit_head(params["head"], x).float(), aux


def vit_apply(params, images, cfg: ViTConfig, *, tp_axis=None, remat=False,
              compute_dtype=None, generator=None):
    """Logits only — the eval and inference view."""
    logits, _ = vit_forward(params, images, cfg, tp_axis=tp_axis,
                            remat=remat,
                            compute_dtype=compute_dtype, generator=generator)
    return logits


def cross_entropy_loss(logits, labels):
    """Mean cross entropy over the batch (log-softmax in f32, the label's
    entry)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def vit_partition_specs(cfg: Optional[ViTConfig] = None, *,
                        tp_axis: Optional[str] = "tp",
                        pp_axis: Optional[str] = None,
                        ep_axis: Optional[str] = None,
                        fsdp_axis: Optional[str] = None):
    """The spec tree of :func:`vit_init`'s params (``parallel/tp.py``):
    the blocks column/row-sharded over ``tp_axis``, MoE experts over
    ``ep_axis``, their stacked depth over ``pp_axis`` and, with
    ``fsdp_axis``, one free dim a leaf over it
    (``parallel/tp.fsdp_shard_specs``); the embedding and the head
    replicated."""
    from quintnet_tpu_torch.nn.moe import moe_specs
    from quintnet_tpu_torch.parallel.tp import block_specs, fsdp_shard_specs

    bspecs = block_specs(tp_axis=tp_axis, stacked=True, pp_axis=pp_axis)
    if cfg is not None and cfg.n_experts > 0:
        del bspecs["mlp"]
        bspecs["moe"] = moe_specs(ep_axis=ep_axis, tp_axis=tp_axis,
                                  stacked=True, pp_axis=pp_axis)
    if fsdp_axis is not None:
        bspecs = fsdp_shard_specs(bspecs, fsdp_axis)
    return {
        "embedding": {"patch": {"w": (), "b": ()}, "cls": (), "pos": ()},
        "blocks": bspecs,
        "head": {"ln": {"scale": (), "bias": ()},
                 "fc": {"w": (), "b": ()}},
    }


def vit_to_tp_layout(params, cfg: ViTConfig, tp: int):
    """Standard fused-QKV columns -> the tp-blocked layout
    (``parallel/tp.py``); identity at tp = 1."""
    from quintnet_tpu_torch.parallel.tp import tree_qkv_layout

    return tree_qkv_layout(params, cfg.num_heads, tp)


def _nhwc(images, cfg: ViTConfig):
    """[B, C, H, W] (detected by the channel count) -> [B, H, W, C]."""
    if images.ndim == 4 and images.shape[1] == cfg.in_channels \
            and images.shape[-1] != cfg.in_channels:
        return images.permute(0, 2, 3, 1)
    return images


def vit_pipeline_fns(cfg: ViTConfig, *, tp_axis=None, ep_axis=None,
                     remat=False, compute_dtype=None):
    """``(embed_fn, stage_fn, head_loss_fn)`` for ``parallel/pp.py``:
    the patch embedding (stage 0), this rank's stacked blocks (every
    stage, on its tp shards with ``tp_axis``, its experts' ep shard with
    ``ep_axis``; ``(h, aux)`` for a MoE config) and the classifier's
    cross entropy (the last stage), computing in ``compute_dtype`` as
    :func:`vit_forward` does."""

    def cast(tree):
        return cast_floating(tree, compute_dtype)

    def embed_fn(params, images, generator=None):
        images = _nhwc(images, cfg)
        if compute_dtype is not None:
            images = images.to(compute_dtype)
        return vit_embed(cast(params["embedding"]), images, cfg.patch_size,
                         pdrop=cfg.dropout,
                         generator=generator if cfg.needs_dropout else None)

    def stage_fn(blocks_local, h, generator=None):
        tp = 1 if tp_axis is None else tp_axis.size
        return stacked_blocks_apply(
            cast(blocks_local), h, num_heads=cfg.num_heads // tp,
            causal=False, act=torch.relu, tp_axis=tp_axis, remat=remat,
            moe_args=cfg.moe_args, ep_axis=ep_axis,
            attn_pdrop=cfg.dropout, resid_pdrop=cfg.dropout,
            generator=generator if cfg.needs_dropout else None)

    def head_loss_fn(params, h, y):
        return cross_entropy_loss(vit_head(cast(params["head"]), h).float(),
                                  y)

    return embed_fn, stage_fn, head_loss_fn


def vit_model_spec(cfg: ViTConfig, *, remat=False, compute_dtype=None):
    """The training model: ``loss_fn(params, (images, labels),
    generator=None, *, tp_axis=None, fsdp_axis=None, ep_axis=None)``
    (cross entropy, plus the aux loss of a MoE config),
    ``eval_metrics_fn`` (loss and accuracy, no dropout), both computing
    in ``compute_dtype`` (see :func:`vit_forward`), on one device or on
    this rank's tp (and, with ``fsdp_axis``, dp-sharded) blocks; on a pp
    mesh :func:`vit_pipeline_fns` (and loss and accuracy through the
    forward pipeline)."""
    import functools

    from quintnet_tpu_torch.parallel.strategy import ModelSpec
    from quintnet_tpu_torch.parallel.tp import axis_name, fsdp_info

    def fsdp(tp_axis, fsdp_axis, ep_axis):
        return fsdp_info(functools.partial(vit_partition_specs, cfg),
                         fsdp_axis, tp_axis=axis_name(tp_axis),
                         ep_axis=axis_name(ep_axis))

    def loss_fn(params, batch, generator=None, *, tp_axis=None,
                fsdp_axis=None, ep_axis=None):
        x, y = batch
        logits, aux = vit_forward(params, x, cfg, tp_axis=tp_axis,
                                  ep_axis=ep_axis, remat=remat,
                                  compute_dtype=compute_dtype,
                                  generator=generator,
                                  fsdp=fsdp(tp_axis, fsdp_axis, ep_axis))
        return cross_entropy_loss(logits, y) + aux

    def eval_metrics_fn(params, batch, *, tp_axis=None, fsdp_axis=None,
                        ep_axis=None):
        x, y = batch
        logits, _ = vit_forward(params, x, cfg, tp_axis=tp_axis,
                                ep_axis=ep_axis, remat=remat,
                                compute_dtype=compute_dtype,
                                fsdp=fsdp(tp_axis, fsdp_axis, ep_axis))
        return {"loss": cross_entropy_loss(logits, y),
                "accuracy": accuracy(logits, y)}

    def pipeline_eval_fns(tp_axis=None, ep_axis=None):
        embed_fn, stage_fn, _ = vit_pipeline_fns(
            cfg, tp_axis=tp_axis, ep_axis=ep_axis, remat=remat,
            compute_dtype=compute_dtype)

        def head_metrics_fn(params, h, y):
            logits = vit_head(cast_floating(params["head"], compute_dtype),
                              h).float()
            return {"loss": cross_entropy_loss(logits, y),
                    "accuracy": accuracy(logits, y)}

        return embed_fn, stage_fn, head_metrics_fn

    return ModelSpec(
        init=lambda generator: vit_init(generator, cfg), loss_fn=loss_fn,
        depth=cfg.depth, needs_rng=cfg.needs_dropout,
        eval_metrics_fn=eval_metrics_fn,
        partition_specs=lambda tp_axis=None, pp_axis=None, fsdp_axis=None,
        ep_axis=None: vit_partition_specs(
            cfg, tp_axis=tp_axis, pp_axis=pp_axis, ep_axis=ep_axis,
            fsdp_axis=fsdp_axis),
        to_tp_layout=lambda p, tp: vit_to_tp_layout(p, cfg, tp),
        pipeline_fns=lambda tp_axis=None, ep_axis=None: vit_pipeline_fns(
            cfg, tp_axis=tp_axis, ep_axis=ep_axis, remat=remat,
            compute_dtype=compute_dtype),
        pipeline_eval_fns=pipeline_eval_fns)

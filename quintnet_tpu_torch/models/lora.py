"""LoRA: low-rank adaptation for parameter-efficient finetuning.

Port of ``quintnet_tpu/models/lora.py``. Adapters are another parameter
tree, merged into the base weights inside the step (``w + (alpha / r)
a @ b`` per targeted matrix), so every model, strategy and kernel runs
unchanged on the merged weights: on the card the merged GPT-2 forward
and the adapters' gradients go through the K1-K3 flash kernels with
``use_flash``.

Sharding composes by construction: for a target weight spec ``(depth,
s_in, s_out)`` the adapters shard ``a: (depth, s_in, None)`` and ``b:
(depth, None, s_out)``, so the shard-local product ``a @ b`` has the
weight's own sharding for column- (out-sharded) and row-parallel
(in-sharded) layers alike and the merge needs no collective
(:func:`lora_partition_specs`).

Optimizer state exists only for the adapters: :func:`make_lora_train_step`
differentiates the adapters alone, the base is a frozen input (its own
sharding, no gradient, no Adam moments).

Typical use::

    lcfg = LoRAConfig(rank=8, alpha=16.0)
    lora = lora_init(generator, params["blocks"], lcfg)
    fwd = lora_wrap(lambda p, ids: gpt2_apply(p, ids, cfg), params, lcfg)
    loss = lambda lora, b: clm_loss(fwd(lora, b[0]), b[1])
    # ... Adam over `lora` only; export with lora_merge_tree(...)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map

DEFAULT_TARGETS = ("qkv", "proj", "fc")          # GPT-2 / ViT blocks
LLAMA_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
LLAMA_ATTN_TARGETS = ("q", "v")                  # the classic LoRA subset


@dataclass(frozen=True)
class LoRAConfig:
    """``rank``, ``alpha`` (the merge scales ``a @ b`` by ``alpha /
    rank``) and the names of the linears to adapt (dict nodes holding a
    2-D or wider ``"w"``)."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"LoRA rank must be >= 1; got {self.rank}")
        bad = [t for t in self.targets if "," in t]
        if bad:
            # save_lora writes the targets comma-joined into the header:
            # a comma inside a name would split it on reload
            raise ValueError(
                f"LoRA target names must not contain ',': {bad}")
        if not self.targets:
            raise ValueError("LoRA targets must be non-empty")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _target_paths(blocks, targets: Sequence[str]):
    """Paths (tuples of keys) of every targeted linear in a block tree."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if (k in targets and isinstance(v, dict) and "w" in v
                        and getattr(v["w"], "ndim", 0) >= 2):
                    out.append(path + (k,))
                else:
                    walk(v, path + (k,))

    walk(blocks, ())
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def lora_init(generator: torch.Generator, blocks, cfg: LoRAConfig) -> Dict:
    """Adapter tree for a (stacked) block tree: for each targeted ``w``
    [..., in, out], ``a ~ U(-1/sqrt(in), 1/sqrt(in))`` [..., in, r] drawn
    from ``generator`` (in target order) and ``b = 0`` [..., r, out], in
    ``w``'s dtype and on its device: zero ``b`` keeps the step-0 outputs
    the base model's exactly. The draws are torch's, not JAX's: parity
    goes through :mod:`quintnet_tpu_torch.bridge`."""
    paths = _target_paths(blocks, cfg.targets)
    if not paths:
        raise ValueError(f"no LoRA targets {cfg.targets} found")
    tree: Dict = {}
    for path in paths:
        w = _get(blocks, path)["w"]
        *lead, fan_in, fan_out = w.shape
        bound = 1.0 / (fan_in ** 0.5)
        u = torch.rand((*lead, fan_in, cfg.rank), generator=generator,
                       device=generator.device, dtype=torch.float32)
        node = {"a": ((2 * u - 1) * bound).to(w.device, w.dtype),
                "b": torch.zeros((*lead, cfg.rank, fan_out), dtype=w.dtype,
                                 device=w.device)}
        sub = tree
        for kk in path[:-1]:
            sub = sub.setdefault(kk, {})
        sub[path[-1]] = node
    return tree


def lora_merge_blocks(blocks, lora, cfg: LoRAConfig):
    """``blocks`` with ``w + scale * a @ b`` at every adapted path; every
    other leaf passes through untouched (the same tree layout)."""

    def walk(node, lnode):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            lv = lnode.get(k) if isinstance(lnode, dict) else None
            if isinstance(lv, dict) and "a" in lv:
                delta = torch.einsum("...ir,...ro->...io", lv["a"], lv["b"])
                out[k] = {**v, "w": v["w"] + cfg.scale * delta.to(
                    v["w"].dtype)}
            else:
                out[k] = walk(v, lv)
        return out

    return walk(blocks, lora)


def lora_merge_tree(params, lora, cfg: LoRAConfig):
    """Full model params with the adapters folded into
    ``params["blocks"]`` (export, merged inference)."""
    return {**params, "blocks": lora_merge_blocks(params["blocks"], lora, cfg)}


def lora_wrap(apply_fn, base_params, cfg: LoRAConfig):
    """``fn(lora, *args)`` = ``apply_fn(merge(base, lora), *args)``:
    differentiating ``fn`` with respect to ``lora`` trains only the
    adapters, the base a captured constant."""

    def fn(lora, *args, **kw):
        return apply_fn(lora_merge_tree(base_params, lora, cfg), *args,
                        **kw)

    return fn


def lora_partition_specs(block_specs, cfg: LoRAConfig, *, blocks=None):
    """Spec tree of an adapter tree from the weight specs (the port's
    tuples, one entry a dim): ``a`` inherits the in-dim sharding, ``b``
    the out-dim one, the rank dim unsharded. A spec shorter than its
    weight is right-padded with None first: to each weight's rank with
    ``blocks`` (the param tree), else to at least 2."""

    def walk(node, bnode):
        if not isinstance(node, dict):
            return None
        out = {}
        for k, v in node.items():
            bv = bnode.get(k) if isinstance(bnode, dict) else None
            if (k in cfg.targets and isinstance(v, dict) and "w" in v
                    and not isinstance(v["w"], dict)):
                wspec = tuple(v["w"])
                rank = (bv["w"].ndim if isinstance(bv, dict)
                        and hasattr(bv.get("w"), "ndim")
                        else max(len(wspec), 2))
                wspec = wspec + (None,) * (rank - len(wspec))
                out[k] = {"a": (*wspec[:-2], wspec[-2], None),
                          "b": (*wspec[:-2], None, wspec[-1])}
            else:
                sub = walk(v, bv)
                if sub:
                    out[k] = sub
        return out

    return walk(block_specs, blocks) or {}


def lora_param_count(lora) -> int:
    return sum(int(leaf.numel()) for _, leaf in tree_leaves(lora))


def lora_upcast(lora, dtype=torch.float32):
    """Cast every adapter (e.g. after loading bf16 ones: the adapters
    train in f32 while the frozen base may stay bf16)."""
    return tree_map(lambda leaf: leaf.to(dtype), lora)


def make_lora_train_step(mesh, merged_loss_fn, optimizer, *,
                         lora_specs=None, grad_accum_steps: int = 1):
    """Adapter-only training on this rank of a ``mesh`` (its ``dp`` axis
    the data axis, its ``tp`` axis the model axis), or on one device with
    ``mesh=None``.

    ``merged_loss_fn(base, lora, batch) -> scalar`` sees this rank's
    shards (merge locally with :func:`lora_merge_blocks`; the spec
    derivation makes that exact) and may run collectives. Only the
    adapters carry gradients and optimizer state; the base is a frozen
    input, never differentiated nor updated. The gradients follow the
    strategy's rule (``parallel/train_step.reduce_grads`` over
    ``lora_specs``: summed over the model axes an adapter is replicated
    on, the model axes' redundancy divided out, averaged over the data
    axes) and the loss is averaged over the data axes.

    Returns ``step(base, lora, opt_state, batch) -> (lora, opt_state,
    loss)``: ``batch`` is the GLOBAL batch, of which this rank takes its
    dim-0 block over the data axes (the JAX step's ``P(data_axes)``),
    averaged over ``grad_accum_steps`` micro-batches; ``lora`` and
    ``opt_state`` are updated in place (``train/trainer.Optimizer``) and
    handed back. The caller shards the base."""
    from quintnet_tpu_torch.core import collectives as cc
    from quintnet_tpu_torch.parallel.dp import accumulate_grads
    from quintnet_tpu_torch.parallel.tp import shard_leaf
    from quintnet_tpu_torch.parallel.train_step import reduce_grads

    names = () if mesh is None else mesh.axis_names
    data_axes = ("dp",) if "dp" in names else ()
    maxes = ("tp",) if "tp" in names else ()
    b_spec = (data_axes,) if data_axes else ()

    def step(base, lora, opt_state, batch):
        for _, leaf in tree_leaves(lora):
            leaf.requires_grad_(True)
        if mesh is not None:
            batch = tuple(shard_leaf(x, b_spec, mesh) for x in batch)
        loss, grads = accumulate_grads(
            lambda lo, mb, _gen: merged_loss_fn(base, lo, mb), lora, batch,
            grad_accum_steps)
        if mesh is not None:
            reduce_grads(grads, lora_specs, mesh, data_axes=data_axes,
                         model_axes=maxes)
            if data_axes:
                loss = cc.all_reduce_(loss.clone(), mesh.axis(data_axes),
                                      mean=True)
        optimizer.update(grads, opt_state, lora)
        return lora, opt_state, loss

    return step


def _flatten(lora) -> Dict[str, torch.Tensor]:
    return {".".join(path): leaf for path, leaf in tree_leaves(lora)}


def save_lora(lora, cfg: LoRAConfig, path: str):
    """Adapters -> one safetensors file: dotted-path keys and the LoRA
    hyperparameters in the header metadata (``lora_rank``,
    ``lora_alpha``, ``lora_targets`` comma-joined), the JAX package's
    format: either package loads the other's file."""
    from quintnet_tpu_torch.utils.safetensors_io import save_file

    meta = {"lora_rank": str(cfg.rank), "lora_alpha": str(cfg.alpha),
            "lora_targets": ",".join(cfg.targets)}
    save_file(_flatten(lora), path, metadata=meta)


def load_lora(path: str, device="cuda") -> Tuple[Dict, LoRAConfig]:
    """(adapter tree on ``device``, LoRAConfig) back from
    :func:`save_lora` (or the JAX package's); dtypes as stored."""
    from quintnet_tpu_torch.core.device import resolve_device
    from quintnet_tpu_torch.utils.safetensors_io import SafeTensorFile

    dev = resolve_device(device)
    with SafeTensorFile(path) as r:
        meta = r.metadata or {}
        tree: Dict = {}
        for name in r.keys():
            sub = tree
            parts = name.split(".")
            for k in parts[:-1]:
                sub = sub.setdefault(k, {})
            # a copy: the mmap closes when the file does
            sub[parts[-1]] = r.tensor(name).to(dev)
    cfg = LoRAConfig(
        rank=int(meta.get("lora_rank", 8)),
        alpha=float(meta.get("lora_alpha", 16.0)),
        targets=tuple(meta.get("lora_targets",
                               ",".join(DEFAULT_TARGETS)).split(",")))
    return tree, cfg


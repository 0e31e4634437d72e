"""GPT-2, ViT and Llama parameters and LoRA adapters between the JAX
pytree and the port.

The packages use the same nested-dict layouts (``models/gpt2.py``,
``models/vit.py``, ``models/llama.py``), so the bridge is a leaf-for-leaf
copy: numpy arrays in, tensors out, and back, after a check of the
layout against the model's leaf list. A MoE tree carries ``blocks.moe``
in place of ``blocks.mlp`` (the router and the experts, each expert leaf
[L, E, ...] with the global expert dim after the layer dim, E the
router's last dim). The JAX side hands over ``jax.tree.map(np.asarray,
params)``; nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from quintnet_tpu_torch.core.device import resolve_device

# (path, rank) of every leaf a dense GPT-2 tree must carry; block leaves
# carry the stacked layer dim in front
GPT2_LEAVES = (
    (("embedding", "wte"), 2), (("embedding", "wpe"), 2),
    (("blocks", "ln1", "scale"), 2), (("blocks", "ln1", "bias"), 2),
    (("blocks", "attn", "qkv", "w"), 3), (("blocks", "attn", "qkv", "b"), 2),
    (("blocks", "attn", "proj", "w"), 3),
    (("blocks", "attn", "proj", "b"), 2),
    (("blocks", "ln2", "scale"), 2), (("blocks", "ln2", "bias"), 2),
    (("blocks", "mlp", "fc", "w"), 3), (("blocks", "mlp", "fc", "b"), 2),
    (("blocks", "mlp", "proj", "w"), 3), (("blocks", "mlp", "proj", "b"), 2),
    (("head", "ln_f", "scale"), 1), (("head", "ln_f", "bias"), 1),
)

# the same for a dense ViT: the patch linear, CLS token and position
# table, GPT-2's block leaves, and the classification head
VIT_LEAVES = (
    (("embedding", "patch", "w"), 2), (("embedding", "patch", "b"), 1),
    (("embedding", "cls"), 3), (("embedding", "pos"), 3),
    *(leaf for leaf in GPT2_LEAVES if leaf[0][0] == "blocks"),
    (("head", "ln", "scale"), 1), (("head", "ln", "bias"), 1),
    (("head", "fc", "w"), 2), (("head", "fc", "b"), 1),
)

# a dense Llama with an untied head (a tied one has no head.lm.w)
LLAMA_LEAVES = (
    (("embedding", "tok"), 2),
    (("blocks", "ln1", "scale"), 2),
    *((("blocks", "attn", n, "w"), 3) for n in ("q", "k", "v", "o")),
    (("blocks", "ln2", "scale"), 2),
    *((("blocks", "mlp", n, "w"), 3) for n in ("gate", "up", "down")),
    (("head", "ln_f", "scale"), 1), (("head", "lm", "w"), 2),
)

# MoE FFNs in place of blocks.mlp: GPT-2/ViT experts (w1 b1 w2 b2) and
# Llama's SwiGLU experts (wg wu wd)
MLP_EXPERT_LEAVES = ((("blocks", "moe", "router", "w"), 3),
                     (("blocks", "moe", "w1"), 4),
                     (("blocks", "moe", "b1"), 3),
                     (("blocks", "moe", "w2"), 4),
                     (("blocks", "moe", "b2"), 3))
SWIGLU_EXPERT_LEAVES = ((("blocks", "moe", "router", "w"), 3),
                        *((("blocks", "moe", n), 4)
                          for n in ("wg", "wu", "wd")))


def _variant(leaves, tree, experts):
    """``leaves`` as ``tree`` has them: the MoE leaves in place of the
    MLP's when ``blocks.moe`` is present, and without the untied head
    when a Llama tree ties it."""
    blocks = tree.get("blocks", {}) if isinstance(tree, dict) else {}
    out = [leaf for leaf in leaves
           if not ("moe" in blocks and leaf[0][:2] == ("blocks", "mlp"))]
    if "moe" in blocks:
        out += experts
    if leaves is LLAMA_LEAVES and "lm" not in tree.get("head", {}):
        out = [leaf for leaf in out if leaf[0] != ("head", "lm", "w")]
    return tuple(out)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _check_layout(tree, leaves=GPT2_LEAVES, model="GPT-2",
                  experts=MLP_EXPERT_LEAVES) -> None:
    leaves = _variant(leaves, tree, experts)
    got = dict(_leaves(tree))
    want = {p for p, _ in leaves}
    kind = "MoE" if ("blocks", "moe", "router", "w") in want else "dense"
    if set(got) != want:
        raise ValueError(
            f"not a {kind} {model} param tree: missing "
            f"{sorted('.'.join(p) for p in want - set(got))}, unexpected "
            f"{sorted('.'.join(p) for p in set(got) - want)}")
    depths = set()
    for path, rank in leaves:
        shape = tuple(got[path].shape)
        if len(shape) != rank:
            raise ValueError(f"{'.'.join(path)} has shape {shape}, "
                             f"expected rank {rank}")
        if path[0] == "blocks":
            depths.add(shape[0])
    if len(depths) != 1:
        raise ValueError(f"block leaves disagree on the layer count: "
                         f"{sorted(depths)}")
    if ("blocks", "moe", "router", "w") in got:
        n = {p[-1]: tuple(got[p].shape) for p, _ in experts}
        E = n["w"][-1]
        odd = sorted(k for k, shape in n.items()
                     if k != "w" and shape[1] != E)
        if odd:
            raise ValueError(f"expert leaves {odd} do not lead with the "
                             f"router's {E} experts after the layer dim")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def gpt2_params_from_numpy(tree, device="cuda"):
    """JAX GPT-2 params as nested dicts of numpy arrays -> the same tree
    of tensors on ``device`` (dtypes kept, data copied)."""
    _check_layout(tree)
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev))


def gpt2_params_to_numpy(params):
    """The inverse: a port GPT-2 param tree -> nested dicts of numpy
    arrays (host copies), ready for ``jax.tree.map(jnp.asarray, ...)``."""
    _check_layout(params)
    return _map(params, lambda t: t.detach().cpu().numpy().copy())


def vit_params_from_numpy(tree, device="cuda"):
    """JAX ViT params as nested dicts of numpy arrays -> the same tree of
    tensors on ``device``."""
    _check_layout(tree, VIT_LEAVES, "ViT")
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev))


def vit_params_to_numpy(params):
    """A port ViT param tree -> nested dicts of numpy arrays (host
    copies)."""
    _check_layout(params, VIT_LEAVES, "ViT")
    return _map(params, lambda t: t.detach().cpu().numpy().copy())


def llama_params_from_numpy(tree, device="cuda"):
    """JAX Llama params (dense or MoE, tied or not) as nested dicts of
    numpy arrays -> the same tree of tensors on ``device``."""
    _check_layout(tree, LLAMA_LEAVES, "Llama", SWIGLU_EXPERT_LEAVES)
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(
        dev))


def llama_params_to_numpy(params):
    """A port Llama param tree -> nested dicts of numpy arrays (host
    copies)."""
    _check_layout(params, LLAMA_LEAVES, "Llama", SWIGLU_EXPERT_LEAVES)
    return _map(params, lambda t: t.detach().cpu().numpy().copy())


def lora_params_from_numpy(tree, device="cuda"):
    """A JAX LoRA adapter tree (``models/lora.lora_init``'s layout: an
    ``{"a", "b"}`` pair at each adapted linear's path) as nested dicts of
    numpy arrays -> the same tree of tensors on ``device``."""
    _check_lora(tree)
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(
        dev))


def lora_params_to_numpy(lora):
    """A port LoRA adapter tree -> nested dicts of numpy arrays (host
    copies)."""
    _check_lora(lora)
    return _map(lora, lambda t: t.detach().cpu().numpy().copy())


def _check_lora(tree):
    """Every leaf of an adapter tree is an ``a`` [..., in, r] or ``b``
    [..., r, out] of a pair whose rank dims agree."""
    def walk(node, path):
        if not isinstance(node, dict):
            raise ValueError(f"LoRA tree leaf at {'.'.join(path)} is not "
                             f"an {{a, b}} pair")
        if set(node) == {"a", "b"}:
            a, b = node["a"], node["b"]
            if a.ndim < 2 or a.shape[-1] != b.shape[-2]:
                raise ValueError(f"LoRA pair {'.'.join(path)}: a "
                                 f"{tuple(a.shape)} and b {tuple(b.shape)} "
                                 f"disagree on the rank")
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(tree, ())

"""GPT-2 and ViT parameters between the JAX pytree and the port.

Both packages use the same nested-dict layouts (``models/gpt2.py``,
``models/vit.py``), so the bridge is a leaf-for-leaf copy: numpy arrays
in, tensors out, and back, after a check of the layout against the
model's leaf list. The JAX side hands over ``jax.tree.map(np.asarray,
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


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _check_layout(tree, leaves=GPT2_LEAVES, model="GPT-2") -> None:
    got = dict(_leaves(tree))
    want = {p for p, _ in leaves}
    if set(got) != want:
        raise ValueError(
            f"not a dense {model} param tree: missing "
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

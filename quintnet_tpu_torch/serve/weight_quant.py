"""Weight layout policies: what dtype the serving matmul weights are
stored in, and how they get there.

Port of ``quintnet_tpu/serve/weight_quant.py``. At serving batch sizes a
decode step reads every block weight once for a few tokens, so the
weights' bytes bound it; the policy narrows them on the same
:class:`~quintnet_tpu_torch.serve.kv_quant.LayoutPolicy` contract the KV
pool uses:

- ``f32`` — the identity: :func:`quantize_params` returns the tree
  unchanged (the same tensors);
- ``bf16`` — passthrough narrowing, upcast to the activations' dtype at
  the matmul; half the bytes, no scales;
- ``int8`` — per-output-channel absmax (``scale[l, o] = max_i
  |w[l, i, o]| / 127``, f32, a ``w_scale`` leaf beside the packed
  ``w``). The scale commutes out of the contraction, ``x @ dq(w) = (x @
  q) * scale``, so ``nn/layers.quantized_matmul`` dequantizes with one
  multiply on the output;
- ``fp8`` — ``torch.float8_e4m3fn`` storage (qmax 448) with the same
  per-channel scales; the narrowing cast keeps the fraction (e4m3's
  mantissa does the rounding);
- ``fake_quant`` — the proof policy: f32 storage, all-ones scales, the
  whole scaled path with quantization exactly the identity. Its engine
  is bit-identical to the f32 engine.

The engine packs once at build, after its adapters read the
full-precision tree (the LoRA delta stays full precision on top), and
before it cuts a tp rank's shards: a row-parallel weight's per-channel
scale is the absmax over its WHOLE in dim. Under tp each ``w_scale``
shards like its weight's out dim (:func:`augment_weight_specs`).

The targets are the family's ``weight_targets`` (``serve/families.py``;
GPT-2: qkv, proj, fc and the MLP's proj; Llama: q, k, v, o, gate, up,
down). Embeddings, the head, the norms and MoE experts stay full
precision.

In eager PyTorch the upcast of a packed weight is a full-width copy on
every call (XLA fuses it into the dot): an int8 decode step reads a
quarter of the f32 weight bytes but also writes and reads the widened
copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from quintnet_tpu_torch.serve.kv_quant import LayoutPolicy


@dataclass(frozen=True)
class WeightLayoutPolicy(LayoutPolicy):
    """The weights face of :class:`LayoutPolicy`: per-output-channel
    absmax groups (the reduced axis is the in-features dim) in place of
    per-block KV groups; the quant math is the shared contract's."""


_WEIGHT_POLICIES = {
    "f32": WeightLayoutPolicy("f32", torch.float32, scaled=False),
    "bf16": WeightLayoutPolicy("bf16", torch.bfloat16, scaled=False),
    "int8": WeightLayoutPolicy("int8", torch.int8, scaled=True, qmax=127.0),
    "fp8": WeightLayoutPolicy("fp8", torch.float8_e4m3fn, scaled=True,
                              qmax=448.0),
    "fake_quant": WeightLayoutPolicy("fake_quant", torch.float32,
                                     scaled=True, qmax=0.0),
}


def weight_policy_names() -> Tuple[str, ...]:
    """The weight-policy ladder (``analysis/specs.weight_layout_policies``)."""
    return tuple(_WEIGHT_POLICIES)


def make_weight_policy(weights_dtype) -> WeightLayoutPolicy:
    """``ServeEngine(weights_dtype=...)`` -> its policy: a policy passes
    through, a name looks up the ladder, a raw f32/bf16 dtype maps to its
    passthrough policy, None is f32."""
    if weights_dtype is None:
        return _WEIGHT_POLICIES["f32"]
    if isinstance(weights_dtype, WeightLayoutPolicy):
        return weights_dtype
    if isinstance(weights_dtype, str):
        if weights_dtype not in _WEIGHT_POLICIES:
            raise ValueError(
                f"unknown weights_dtype {weights_dtype!r}; expected one "
                f"of {weight_policy_names()}")
        return _WEIGHT_POLICIES[weights_dtype]
    for name in ("f32", "bf16"):
        if weights_dtype == _WEIGHT_POLICIES[name].store_dtype:
            return _WEIGHT_POLICIES[name]
    raise ValueError(
        f"no weight policy for dtype {weights_dtype}; use one of "
        f"{weight_policy_names()}")


# ---------------------------------------------------------------------
# tree surgery (once, at engine build)
# ---------------------------------------------------------------------

def _node_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _with_node(tree, path, node):
    """``tree`` with the node at ``path`` replaced: dicts along ``path``
    are shallow-copied, every other leaf keeps its identity."""
    if not path:
        return node
    out = dict(tree)
    out[path[0]] = _with_node(tree[path[0]], path[1:], node)
    return out


def present_targets(params, targets) -> Tuple[Tuple[str, ...], ...]:
    """The family's ``weight_targets`` that exist in THIS tree (a MoE
    block has ``moe`` in place of ``mlp``: its dense targets drop out)."""
    out = []
    for path in targets:
        node = params["blocks"]
        for k in path:
            if not isinstance(node, dict) or k not in node:
                node = None
                break
            node = node[k]
        if isinstance(node, dict) and "w" in node:
            out.append(path)
    return tuple(out)


def _quantize_node(node, policy: WeightLayoutPolicy):
    """One linear node ``{w: [L, in, out](, b)}`` -> its packed form:
    ``w`` in the store dtype, plus a per-output-channel ``w_scale``
    [L, out] f32 leaf when scaled. The bias stays full precision."""
    w = node["w"]
    out = dict(node)
    if policy.scaled:
        scale = policy.compute_scale(w, axes=(-2,))          # [L, out]
        out["w"] = policy.quant(w, scale.unsqueeze(-2))
        out["w_scale"] = scale
    else:
        out["w"] = w.to(policy.store_dtype)
    return out


def quantize_params(params, targets, policy: WeightLayoutPolicy):
    """Every ``targets`` path under ``params["blocks"]`` packed by
    ``policy``. The f32 policy returns ``params`` itself; the others
    replace only the targeted nodes."""
    if policy.name == "f32":
        return params
    blocks = params["blocks"]
    for path in targets:
        blocks = _with_node(blocks, path,
                            _quantize_node(_node_at(blocks, path), policy))
    return {**params, "blocks": blocks}


def weight_bytes(params, targets) -> int:
    """Bytes of the targeted weight nodes (packed ``w`` plus ``w_scale``
    where present): the number the int8 gate ratios against f32's."""
    total = 0
    blocks = params["blocks"]
    for path in targets:
        node = _node_at(blocks, path)
        total += node["w"].numel() * node["w"].element_size()
        if "w_scale" in node:
            total += node["w_scale"].numel() * node["w_scale"].element_size()
    return int(total)


def augment_weight_specs(specs, targets):
    """:func:`quantize_params`'s surgery on a spec tree (the port's
    tuples, one entry a dim): each targeted node gains a ``w_scale`` spec
    sharded like its weight's OUT dim, ``(lead, out)`` from ``(lead, in,
    out)``. Column-parallel scales are cut with their columns,
    row-parallel ones stay whole. Call only under a scaled policy (the
    spec tree must match the param tree leaf for leaf)."""
    blocks = specs["blocks"]
    for path in targets:
        node = _node_at(blocks, path)
        w = tuple(node["w"])
        w = w + (None,) * (3 - len(w))
        blocks = _with_node(blocks, path, {**node, "w_scale": (w[0], w[2])})
    return {**specs, "blocks": blocks}

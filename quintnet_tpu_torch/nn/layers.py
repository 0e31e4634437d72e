"""Core layers as apply functions over plain parameter dicts.

Port of ``quintnet_tpu/nn/layers.py`` (linear, LayerNorm, RMSNorm,
GELU, the MLP, Llama's SwiGLU, dropout, ViT's patchify, the
mixed-precision cast, which keeps the MoE router in f32, and the
serving seams: ``quantized_matmul`` for packed weights and
``lora_delta`` for per-slot adapters).
Conventions carried over: parameters are dicts of tensors in the JAX
layout — linear weights ``[in, out]`` so the forward is ``x @ w``,
LayerNorm ``{"scale", "bias"}`` — normalisation runs in f32 whatever
the input dtype, and bf16 compute casts the f32 master parameters at
use (:func:`cast_floating`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.core.pytree import tree_map


def cast_floating(tree, dtype, *, exclude=None):
    """Floating-point tensor leaves of ``tree`` cast to ``dtype`` (None
    is a no-op); integer tensors (token ids inside a batch) and python
    numbers pass through. The cast-at-use policy of mixed precision:
    storage stays in f32 master copies, and the cast's backward brings
    each gradient back to the leaf's own dtype. A leaf already in
    ``dtype`` is returned as it is. ``exclude(path) -> bool`` (``path``
    the tuple of dict keys down to the leaf) keeps matching leaves at
    their stored dtype (:func:`keep_router_f32`)."""
    if dtype is None:
        return tree

    def cast(x):
        return (x.to(dtype) if torch.is_tensor(x) and x.is_floating_point()
                else x)

    if exclude is None:
        return tree_map(cast, tree)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        return t if exclude(path) else cast(t)

    return walk(tree, ())


def keep_router_f32(path) -> bool:
    """:func:`cast_floating`'s ``exclude`` pinning the MoE router weights
    at f32: the order of the gates changes under bf16 rounding
    (``nn/moe.py``)."""
    return "router" in path


def linear_init(generator: torch.Generator, in_features: int,
                out_features: int, *, lead=()):
    """Kaiming-uniform fan-in init (torch.nn.Linear's default, as the
    JAX package draws it), f32 on ``generator.device``: ``w``
    [*lead, in, out], ``b`` [*lead, out], both U(-1/sqrt(in),
    1/sqrt(in)). ``lead`` stacks layers."""
    bound = 1.0 / math.sqrt(in_features)

    def u(shape):
        return (torch.rand(shape, generator=generator,
                           device=generator.device) * 2 - 1) * bound

    return {"w": u((*lead, in_features, out_features)),
            "b": u((*lead, out_features))}


def quantized_matmul(x, node):
    """``x @ dequant(node)``: the seam every serving matmul goes through
    (``serve/weight_quant.py``). ``node`` is a linear param node ``{"w":
    [.., in, out]}`` whose ``w`` MAY be packed (int8 / float8, or bf16
    under f32 activations) and which MAY carry a per-output-channel
    ``"w_scale"`` [.., out] f32 leaf. A weight in another dtype than
    ``x`` is upcast to it first (torch's ``@`` does not promote the way
    ``jnp.dot`` does; in eager mode the upcast is a full-width copy each
    call). The scale commutes out of the contraction, so dequantization
    is one multiply on the output: ``(x @ w_q) * scale``. Without a scale
    and with ``w`` in ``x``'s dtype this is ``x @ w``; under the
    fake_quant policy (f32 storage, all-ones scales) it is bit-identical
    (``y * 1.0``). Bias and LoRA deltas are the caller's, both full
    precision on top."""
    w = node["w"]
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    y = x @ w
    if "w_scale" in node:
        y = y * node["w_scale"]
    return y


def linear_apply(p, x):
    """``x @ w (+ b)`` through :func:`quantized_matmul`."""
    y = quantized_matmul(x, p)
    if "b" in p:
        y = y + p["b"]
    return y


def lora_delta(x, node, scale):
    """Per-slot low-rank delta of multi-tenant LoRA serving
    (``serve/adapters.py``): each row of the batch applies its own
    adapter. ``x`` [S, T, in] per-slot activations; ``node`` the packed
    adapters ``{"a": [S, in, r], "b": [S, r, out]}`` (zero rows for
    base-model slots: a zero adapter's delta is exactly zero); ``scale``
    [S] per-slot ``alpha / rank``. Returns ``scale_s * (x_s @ a_s) @
    b_s`` [S, T, out] in ``x``'s dtype. Under tp a column-parallel
    target's ``b`` arrives out-sharded (the local columns' delta) and a
    row-parallel target's ``a`` in-sharded (a partial sum that the
    layer's own sum over tp completes): no new collective."""
    h = torch.bmm(x, node["a"])
    return (torch.bmm(h, node["b"]) * scale[:, None, None]).to(x.dtype)


def layer_norm_init(dim: int, *, device, lead=()):
    """Unit scale, zero bias, f32 on ``device`` (no default: callers
    pass the device their other parameters are drawn on)."""
    return {"scale": torch.ones((*lead, dim), device=device),
            "bias": torch.zeros((*lead, dim), device=device)}


def layer_norm_apply(p, x, *, eps: float = 1e-5):
    """Normalise in f32 (biased variance, as ``jnp.var``), cast back to
    the input dtype."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dtype)


def rms_norm_init(dim: int, *, device, lead=()):
    """RMSNorm (Llama): a unit scale, no bias, f32 on ``device``."""
    return {"scale": torch.ones((*lead, dim), device=device)}


def rms_norm_apply(p, x, *, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale``, accumulated in f32 and
    cast back to the input dtype once (HF Llama's semantics up to the
    order of the scale and the cast)."""
    dtype = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"]).to(dtype)


def swiglu_init(generator: torch.Generator, dim: int, hidden: int, *,
                lead=()):
    """Llama's MLP: gate and up [D, H], down [H, D], no biases,
    Kaiming-uniform fan-in as :func:`linear_init`."""
    def w(i, o):
        return {"w": linear_init(generator, i, o, lead=lead)["w"]}

    return {"gate": w(dim, hidden), "up": w(dim, hidden),
            "down": w(hidden, dim)}


def swiglu_apply(p, x, *, tp_axis=None, lora=None, lora_scale=None):
    """``silu(x @ gate) * (x @ up) @ down``. With ``tp_axis`` (a
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`) gate and up are
    column-sharded [D, H/tp] and down row-sharded [H/tp, D]: one sum over
    tp after down. ``lora``/``lora_scale``: this layer's packed per-slot
    adapters (:func:`lora_delta`); each present target (gate, up, down)
    adds its delta on that matmul, before the activation and the sum."""
    g = quantized_matmul(x, p["gate"])
    u = quantized_matmul(x, p["up"])
    if lora is not None and "gate" in lora:
        g = g + lora_delta(x, lora["gate"], lora_scale)
    if lora is not None and "up" in lora:
        u = u + lora_delta(x, lora["up"], lora_scale)
    h = F.silu(g) * u
    y = quantized_matmul(h, p["down"])
    if lora is not None and "down" in lora:
        y = y + lora_delta(h, lora["down"], lora_scale)
    return y if tp_axis is None else cc.all_reduce(y, tp_axis)


def dropout(generator, x, rate: float, *, deterministic: bool):
    """Inverted dropout: keep each entry with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``. The mask is drawn from
    ``generator`` (on ``x``'s device); JAX key streams cannot be
    reproduced in torch, so only the distribution matches the JAX
    package's ``dropout``. A no-op when ``deterministic`` or at rate 0."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def gelu(x):
    """tanh approximation — what GPT-2 uses."""
    return F.gelu(x, approximate="tanh")


def patchify(images, patch_size: int):
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C], the reference's reshape
    and transpose: with the patch linear after it, the same map as a
    Conv2d of kernel = stride = p."""
    b, h, w, c = images.shape
    p = patch_size
    if h % p or w % p:
        raise ValueError(f"image {h}x{w} does not split into {p}x{p} "
                         f"patches")
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def mlp_apply(p, x, *, act=gelu, tp_axis=None, pdrop: float = 0.0,
              generator=None, lora=None, lora_scale=None):
    """fc -> act -> proj (GPT-2's MLP with GELU, ViT's with
    ``act=torch.relu``); with ``generator``, dropout at
    ``pdrop`` on the output (the reference's post-projection dropout).
    With ``tp_axis`` (a :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`)
    fc is column-sharded [D, hidden/tp] and proj row-sharded [hidden/tp,
    D]: one sum over tp after proj, then its bias, the dropout after it,
    so its mask agrees on every tp rank. ``lora``/``lora_scale``: packed
    per-slot adapters (:func:`lora_delta`), fc's delta before the
    activation, proj's before the sum."""
    h = linear_apply(p["fc"], x)
    if lora is not None and "fc" in lora:
        h = h + lora_delta(x, lora["fc"], lora_scale)
    h = act(h)
    y = quantized_matmul(h, p["proj"])
    if lora is not None and "proj" in lora:
        y = y + lora_delta(h, lora["proj"], lora_scale)
    if tp_axis is not None:
        y = cc.all_reduce(y, tp_axis)
    if "b" in p["proj"]:
        y = y + p["proj"]["b"]
    if generator is not None and pdrop > 0.0:
        y = dropout(generator, y, pdrop, deterministic=False)
    return y

"""Core layers as apply functions over plain parameter dicts.

Port of ``quintnet_tpu/nn/layers.py`` (the f32 subset: linear,
LayerNorm, GELU, the MLP and dropout).
Conventions carried over: parameters are dicts of tensors in the JAX
layout — linear weights ``[in, out]`` so the forward is ``x @ w``,
LayerNorm ``{"scale", "bias"}`` — and normalisation runs in f32
whatever the input dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def linear_apply(p, x):
    """``x @ w (+ b)`` — the full-precision path of the JAX package's
    ``quantized_matmul`` (packed weights are not ported)."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


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


def mlp_apply(p, x, *, act=gelu, pdrop: float = 0.0, generator=None):
    """fc -> act -> proj (GPT-2's MLP); with ``generator``, dropout at
    ``pdrop`` on the output (the reference's post-projection dropout)."""
    h = act(linear_apply(p["fc"], x))
    y = linear_apply(p["proj"], h)
    if generator is not None and pdrop > 0.0:
        y = dropout(generator, y, pdrop, deterministic=False)
    return y

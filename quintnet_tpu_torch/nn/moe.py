"""Mixture-of-Experts layer with expert parallelism over the ``ep`` axis.

Port of ``quintnet_tpu/nn/moe.py``. Routing is dense math with static
shapes: a top-k gate over a [S, E] router product in f32, a capacity C
a rank and expert, and the assignments past capacity written to a dump
row (E * C) that nobody reads. Dispatch and combine are scatter-adds
(``index_add``) into a [E * C, D] buffer and back. With ``ep_axis`` (a
:class:`~quintnet_tpu_torch.core.mesh.MeshAxis`) each rank owns E / ep
experts, and one ``all_to_all`` over ep each way sends every expert's
rows to its owner and the outputs back. With ``tp_axis`` each expert's
FFN is also column/row-sharded over tp (one sum after the second
product).

Gradients: ep is a *data* axis (tokens are sharded over it) while the
expert weights are sharded over it; the all_to_all's backward hands
each expert the gradient summed over every source rank, so
``parallel/train_step.reduce_grads`` divides an ep-sharded leaf by ep
instead of averaging it.

The load-balance loss is the Switch Transformer's (E * sum_e f_e * P_e
over the k assignments) on the rank's own tokens, plus an optional
router z-loss. The batched expert products are ``torch.einsum``: plain
matrix products, which the JAX package computes outside any Pallas
kernel too.

Top-k keeps JAX's order on ties (``lax.top_k``: the lower index first):
:func:`_topk` is a stable descending sort, so which assignment a tie
gives, and therefore which assignments the capacity cut drops, is the
JAX package's on every device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.nn.layers import gelu, linear_init


class MoEArgs(NamedTuple):
    """Static MoE hyperparameters. ``router``: ``"topk"`` (tokens choose
    experts: Switch, Mixtral; needs the aux loss and may drop at
    capacity) or ``"expert_choice"`` (each expert takes its top-C
    tokens: balanced by construction, no aux loss, no drops; NON-causal,
    so the causal LM configs refuse it)."""

    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    capacity: Optional[int] = None  # explicit per-rank per-expert override
    aux_weight: float = 1e-2
    z_weight: float = 0.0
    normalize_gates: bool = True
    router: str = "topk"


def moe_init(generator: torch.Generator, dim: int, hidden: int,
             n_experts: int, *, expert_type: str = "mlp", lead=()):
    """Router and expert FFNs with the GLOBAL expert dim E in front of
    each expert leaf (after ``lead``, which stacks layers), f32 on
    ``generator.device``, every leaf U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    as :func:`~quintnet_tpu_torch.nn.layers.linear_init` draws it.
    ``expert_type``: ``"mlp"`` (w1, b1, w2, b2: GPT-2 and ViT) or
    ``"swiglu"`` (wg, wu, wd, no biases: Llama, Mixtral)."""
    dev = generator.device
    s1, s2 = 1.0 / math.sqrt(dim), 1.0 / math.sqrt(hidden)

    def u(shape, s):
        return (torch.rand((*lead, *shape), generator=generator,
                           device=dev) * 2 - 1) * s

    router = {"w": linear_init(generator, dim, n_experts, lead=lead)["w"]}
    E = n_experts
    if expert_type == "swiglu":
        return {"router": router, "wg": u((E, dim, hidden), s1),
                "wu": u((E, dim, hidden), s1),
                "wd": u((E, hidden, dim), s2)}
    if expert_type != "mlp":
        raise ValueError(f"unknown expert_type {expert_type!r}")
    return {"router": router, "w1": u((E, dim, hidden), s1),
            "b1": u((E, hidden), s1), "w2": u((E, hidden, dim), s2),
            "b2": u((E, dim), s2)}


def moe_specs(*, ep_axis: Optional[str] = "ep",
              tp_axis: Optional[str] = None, stacked: bool = False,
              pp_axis: Optional[str] = None, expert_type: str = "mlp"):
    """Specs (``parallel/tp.py``): experts sharded over ``ep``, each
    expert's FFN column/row-sharded over ``tp``, the router
    replicated."""

    def lead(*tail):
        return (pp_axis, *tail) if stacked else tuple(tail)

    if expert_type == "swiglu":
        return {"router": {"w": lead(None, None)},
                "wg": lead(ep_axis, None, tp_axis),
                "wu": lead(ep_axis, None, tp_axis),
                "wd": lead(ep_axis, tp_axis, None)}
    return {"router": {"w": lead(None, None)},
            "w1": lead(ep_axis, None, tp_axis),
            "b1": lead(ep_axis, tp_axis),
            "w2": lead(ep_axis, tp_axis, None),
            "b2": lead(ep_axis, None)}


def _capacity(s_local: int, args: MoEArgs) -> int:
    """Per-rank, per-expert capacity from the rank's own token count."""
    if args.capacity is not None:
        return int(args.capacity)
    c = math.ceil(s_local * args.top_k / args.n_experts
                  * args.capacity_factor)
    return max(int(c), 1)


def _topk(x, k: int):
    """``(values, indices)`` of the ``k`` largest along the last dim,
    largest first, the lower index first among equal values (JAX's
    ``lax.top_k``): a stable descending sort, cut to ``k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(probs, k: int):
    """The top-k gate of every token: ``(gate values, expert ids)``, each
    [S, k]. One function, so a caller can watch the routing decisions
    without touching the layer."""
    return _topk(probs, k)


def moe_apply(p, x, args: MoEArgs, *, ep_axis=None, tp_axis=None, act=gelu,
              return_stats: bool = False):
    """x [B, T, D] -> (y, aux_loss[, stats]): tokens routed to their top-k
    experts, at most C a rank and expert (the rest dropped: the block's
    residual path keeps them), the expert outputs gate-weighted and summed
    back. ``stats`` (``return_stats``): the routing counts of
    :func:`_routing_stats`."""
    B, T, D = x.shape
    S, E, k = B * T, args.n_experts, args.top_k
    if not 1 <= k <= E:
        raise ValueError(f"top_k={k} must be in [1, n_experts={E}]")
    ep = 1 if ep_axis is None else ep_axis.size
    if E % ep:
        raise ValueError(f"n_experts={E} must divide by ep={ep}")
    C = _capacity(S, args)
    xt = x.reshape(S, D)

    logits = xt.float() @ p["router"]["w"].float()          # [S, E]
    probs = torch.softmax(logits, dim=-1)
    if args.router == "expert_choice":
        return _moe_expert_choice(p, xt, probs, logits, (B, T, D), C, args,
                                  ep_axis=ep_axis, tp_axis=tp_axis, act=act,
                                  return_stats=return_stats)
    if args.router != "topk":
        raise ValueError(f"unknown router {args.router!r}")

    gate_v, gate_i = _route(probs, k)
    if args.normalize_gates:
        gate_v = gate_v / gate_v.sum(dim=-1, keepdim=True)
    # k-major priority flatten: every token's first choice outranks any
    # token's second
    idx_f = gate_i.t().reshape(-1)                           # [k*S]
    val_f = gate_v.t().reshape(-1)
    s_of = torch.arange(S, device=x.device).repeat(k)
    oh = torch.nn.functional.one_hot(idx_f, E)               # [k*S, E]
    pos_in_e = ((oh.cumsum(dim=0) - 1) * oh).sum(dim=-1)
    keep = pos_in_e < C
    slot = torch.where(keep, idx_f * C + pos_in_e,
                       torch.full_like(idx_f, E * C))        # dump row

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    xe = buf.index_add(0, slot, xt[s_of])[: E * C].reshape(E, C, D)
    if ep_axis is not None:
        # my experts' rows from every source rank: [E, C, D] ->
        # [E/ep, ep*C, D]
        xe = cc.all_to_all(xe, ep_axis, split_dim=0, concat_dim=1)
    y = _expert_ffn(p, xe, act=act, tp_axis=tp_axis)
    if ep_axis is not None:
        y = cc.all_to_all(y, ep_axis, split_dim=1, concat_dim=0)

    ybuf = torch.cat([y.reshape(E * C, D), y.new_zeros((1, D))], dim=0)
    yc = ybuf[slot] * val_f.to(y.dtype)[:, None]
    yt = y.new_zeros((S, D)).index_add(0, s_of, yc)

    f_e = oh.sum(dim=0).float() / (S * k)
    p_e = probs.mean(dim=0)
    aux = args.aux_weight * E * (f_e * p_e).sum()
    if args.z_weight:
        aux = aux + args.z_weight * torch.logsumexp(
            logits, dim=-1).square().mean()
    out = yt.reshape(B, T, D)
    if return_stats:
        return out, aux, _routing_stats(oh, keep, probs, S * k)
    return out, aux


def _routing_stats(oh, keep, probs, assigned: int):
    """Routing counts of one call (f32): ``expert_tokens`` [E], the
    demand per expert before the capacity cut; ``dropped``, the
    assignments past capacity; ``assigned``, S * k; ``entropy``, the mean
    router entropy a token in nats."""
    return {"expert_tokens": oh.sum(dim=0).float(),
            "dropped": (~keep).sum().float(),
            "assigned": torch.tensor(float(assigned), device=oh.device),
            "entropy": -(probs * torch.log(probs + 1e-9)).sum(dim=-1).mean()}


def _expert_ffn(p, xe, *, act, tp_axis):
    """Every expert's FFN on its [C', D] rows at once ([E', C', D]); mlp
    or swiglu experts, one sum over tp after the second product."""
    dt = xe.dtype
    if "wg" in p:
        h = (torch.nn.functional.silu(
            torch.einsum("ecd,edh->ech", xe, p["wg"].to(dt)))
            * torch.einsum("ecd,edh->ech", xe, p["wu"].to(dt)))
        y = torch.einsum("ech,ehd->ecd", h, p["wd"].to(dt))
        return y if tp_axis is None else cc.all_reduce(y, tp_axis)
    h = torch.einsum("ecd,edh->ech", xe, p["w1"].to(dt))
    h = act(h + p["b1"].to(dt)[:, None, :])
    y = torch.einsum("ech,ehd->ecd", h, p["w2"].to(dt))
    if tp_axis is not None:
        y = cc.all_reduce(y, tp_axis)
    return y + p["b2"].to(dt)[:, None, :]


def _moe_expert_choice(p, xt, probs, logits, btd, C, args: MoEArgs, *,
                       ep_axis, tp_axis, act=gelu, return_stats=False):
    """Expert choice: expert e takes the C tokens of highest affinity
    ``probs[:, e]`` and weights each by it. Every expert's buffer is full
    (no drops, no imbalance), so the only aux term is the z-loss."""
    B, T, D = btd
    S = xt.shape[0]
    gate, idx = _topk(probs.t(), min(C, S))                 # [E, C']
    if C > S:  # capacity above the token count: repeats at gate 0
        idx = torch.nn.functional.pad(idx, (0, C - S))
        gate = torch.nn.functional.pad(gate, (0, C - S))
    xe = xt[idx.reshape(-1)].reshape(idx.shape[0], C, D)
    if ep_axis is not None:
        xe = cc.all_to_all(xe, ep_axis, split_dim=0, concat_dim=1)
    y = _expert_ffn(p, xe, act=act, tp_axis=tp_axis)
    if ep_axis is not None:
        y = cc.all_to_all(y, ep_axis, split_dim=1, concat_dim=0)
    yw = y * gate.to(y.dtype)[:, :, None]
    yt = y.new_zeros((S, D)).index_add(0, idx.reshape(-1), yw.reshape(-1, D))
    aux = torch.zeros((), device=xt.device)
    if args.z_weight:
        aux = args.z_weight * torch.logsumexp(logits, dim=-1).square().mean()
    out = yt.reshape(B, T, D)
    if return_stats:
        E = probs.shape[-1]
        return out, aux, {
            "expert_tokens": torch.full((E,), float(C), device=xt.device),
            "dropped": torch.zeros((), device=xt.device),
            "assigned": torch.tensor(float(E * C), device=xt.device),
            "entropy": -(probs * torch.log(probs + 1e-9)).sum(
                dim=-1).mean()}
    return out, aux

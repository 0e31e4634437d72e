"""Pipeline parallelism: the AFAB and 1F1B schedules over the ``pp`` axis.

Port of ``quintnet_tpu/parallel/pp.py``. The stacked blocks' depth dim is
sharded over ``pp`` (``parallel/tp.py`` specs), so each rank's shard is
its stage; depth must divide by pp (:func:`validate_pp`). Labels ride
with the batch to every rank and the last stage uses them. A model plugs
in three functions (``models/gpt2.py``, ``models/vit.py``):

- ``embed_fn(params, x_mb, generator=None) -> h``     (stage 0 only)
- ``stage_fn(blocks_local, h, generator=None) -> h``  (every stage)
- ``head_loss_fn(params, h, y_mb) -> loss``            (last stage only)

``generator`` is passed only with dropout: each (micro-batch, stage)
gets generators seeded from the step generator's seed, so a recomputed
micro-batch draws the forward's masks again (:func:`_mb_generators`).
A MoE model's ``stage_fn`` returns ``(h, aux)``, its blocks' load-balance
loss: every active stage adds its aux / M to the loss, and 1F1B seeds
its gradient on every stage (:func:`_stage_out`).

Schedules, with JAX's tick algebra (P stages, M micro-batches; stage s
forwards micro-batch ``t - s`` at tick t):

- **AFAB** (:func:`make_afab_loss_fn`) is a loss function: M + P - 1
  ticks of (shift, embed or receive, stage, head), differentiated by
  autograd through the shift (``core/collectives``: its backward is the
  opposite shift), which gives the reverse pipeline. The shifts'
  backward are collectives, so every rank must run every one of them, in
  the same order. A rank skips the compute of its inactive ticks but
  passes the received activation on, so each rank's graph is one chain
  through all T shifts; the chain starts from zeros tied to a parameter
  and ends tied into the loss (:class:`_Tie`), so that
  ``torch.autograd.grad`` reaches every shift on every rank.
- **1F1B** (:func:`make_1f1b_grad_fn`) is a gradient function: T = M +
  2(P - 1) ticks, each a forward sub-step (micro-batch ``t - s``) and a
  backward sub-step (micro-batch ``t - 2(P - 1) + s``), at most ``CAP =
  2P - 1`` micro-batches in flight a rank. Every rank calls both shifts
  of every tick, active or not. ``1f1b`` saves each micro-batch's
  stage input and reruns its forward under autograd at the backward
  sub-step (2x forward work); ``1f1b_stored`` (``store_activations``)
  keeps each in-flight micro-batch's autograd graph instead, the
  reference's own 1F1B semantics.

Every schedule's gradient is each rank's partial: the embedding's on
stage 0, the head's on the last stage, zeros elsewhere; ``parallel/
train_step.reduce_grads`` sums them over pp (``partial_axes``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map


class PipelineSpec(NamedTuple):
    n_micro: int                  # micro-batches a step (reference grad_acc)
    pp_axis: object = "pp"        # a name (with ``mesh=``) or a MeshAxis


def validate_pp(depth: int, pp_size: int):
    if depth % pp_size != 0:
        raise ValueError(
            f"depth {depth} must be divisible by pp={pp_size} (the reference "
            "gives remainders to early stages; here pad depth or adjust pp)")


def _split_micro(x, n_micro: int):
    """[B, ...] -> M views of [B / M, ...]."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch of {b} rows does not split into {n_micro} "
                         f"micro-batches")
    k = b // n_micro
    return [x[m * k:(m + 1) * k] for m in range(n_micro)]


def _mb_generators(generator, m: int, s: int):
    """(embed, stage) dropout generators of micro-batch ``m`` on stage
    ``s``, or (None, None) without dropout. Seeded from the step
    generator's seed with ``m + 1`` and ``s + 1`` folded in (the fold
    leaves coordinate 0 unchanged, so unshifted indices would give
    (m, s) = (1, 0) and (0, 1) one seed); the same (m, s) always gives
    the same generators, which is what lets the 1F1B recompute draw the
    forward's masks."""
    if generator is None:
        return None, None
    from quintnet_tpu_torch.parallel.train_step import _fold

    k = _fold(_fold(generator.initial_seed(), 1 + m), 1 + s)
    dev = generator.device
    return (torch.Generator(device=dev).manual_seed(_fold(k, 1)),
            torch.Generator(device=dev).manual_seed(_fold(k, 2)))


def _call_embed(embed_fn, params, x, g):
    return embed_fn(params, x) if g is None else embed_fn(params, x,
                                                          generator=g)


def _call_stage(stage_fn, blocks, h, g):
    return stage_fn(blocks, h) if g is None else stage_fn(blocks, h,
                                                          generator=g)


def _stage_out(out):
    """A stage's result as ``(h, aux or None)``: a dense stack returns the
    activation alone, a MoE stack ``(h, aux)`` (aux as f32)."""
    if isinstance(out, tuple):
        h, aux = out
        return h, aux.float()
    return out, None


def _eval_shape(fn, *args):
    """``fn``'s output as meta tensors (shapes and dtypes, no data, no
    work on the device): JAX's ``eval_shape``. ``fn`` must run no
    collective."""
    meta = [tree_map(lambda t: t.to("meta") if torch.is_tensor(t) else t, a)
            for a in args]
    with torch.no_grad():
        return fn(*meta)


def _zeros(meta, device):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device), meta)


class SplitHead(NamedTuple):
    """A head loss in two phases (the JAX package's contract, kept here
    although torch has no ``lax.cond`` to forbid collectives in a gated
    branch). ``local_fn(params, h, y) -> tree``: the expensive,
    collective-free part (the lm-head matmul), run only on the last
    stage's active ticks. ``reduce_fn(local, y, valid) -> scalar`` (or
    ``{name: scalar}`` for metrics): cheap and free to run collectives
    over the stage's tp ranks; run on EVERY stage at every tick, with a
    zeroed ``local`` when gated off, and must return 0 when ``valid`` is
    False."""

    local_fn: Callable
    reduce_fn: Callable


def _apply_head(head, params, h, y, want: bool):
    """The head loss gated to ``want``: a plain head runs only when
    wanted (else a zero scalar), a :class:`SplitHead` gates its
    ``local_fn`` and always runs its ``reduce_fn``."""
    if isinstance(head, SplitHead):
        local = (head.local_fn(params, h, y) if want else
                 _zeros(_eval_shape(head.local_fn, params, h, y), h.device))
        return tree_map(lambda v: v.float(), head.reduce_fn(local, y, want))
    if want:
        return tree_map(lambda v: v.float(), head(params, h, y))
    return torch.zeros((), device=h.device)


class _Tie(torch.autograd.Function):
    """``a`` as it is, with ``b`` made an input of it in the graph: ``b``
    gets no gradient, but everything ``b`` depends on is reached by a
    backward that reaches ``a``."""

    @staticmethod
    def forward(ctx, a, b):
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _first_param(params):
    return next(v for _, v in tree_leaves(params) if v.requires_grad)


def make_afab_loss_fn(embed_fn: Callable, stage_fn: Callable,
                      head_loss_fn: Callable, spec: PipelineSpec, *,
                      mesh=None):
    """``loss(params, (x, y), generator=None) -> scalar``: the forward
    pipeline; differentiating it (``make_parallel_train_step`` does)
    runs the reverse pipeline. Use with ``partial_axes=("pp",)``.

    The value is the pp-summed loss, the same on every rank, but only
    this rank's partial is differentiated (``local + (total -
    local).detach()``): a differentiable sum over pp would hand every
    cotangent back pp times."""
    M = spec.n_micro

    def pipeline_loss(params, batch, generator=None):
        ax = cc.resolve_axis(spec.pp_axis, mesh)
        x, y = batch
        xs, ys = _split_micro(x, M), _split_micro(y, M)
        s, P = ax.index, ax.size
        first, last = s == 0, s == P - 1
        anchor = _first_param(params)
        dev = anchor.device
        tmpl = _eval_shape(embed_fn, params, xs[0])
        # the chain starts at zeros that depend on a parameter, so every
        # rank's every shift lies on a path to the parameters
        h_send = _Tie.apply(_zeros(tmpl, dev), anchor)
        local = torch.zeros((), device=dev)
        split = isinstance(head_loss_fn, SplitHead)
        for t in range(M + P - 1):
            h_recv = cc.ppermute_shift(h_send, ax, shift=1, wrap=False)
            m = t - s
            active = 0 <= m < M
            if active:
                g_e, g_s = _mb_generators(generator, m, s)
                h_in = (_Tie.apply(_call_embed(embed_fn, params, xs[m], g_e),
                                   h_recv) if first else h_recv)
                h_out, aux = _stage_out(
                    _call_stage(stage_fn, params["blocks"], h_in, g_s))
                if aux is not None:   # every active stage's blocks
                    local = local + aux / M
            else:
                h_out = h_recv          # nothing to compute: pass it on
            valid = last and active
            if valid or split:
                local = local + _apply_head(
                    head_loss_fn, params, h_out, ys[min(max(m, 0), M - 1)],
                    valid) / M
            h_send = h_out
        local = _Tie.apply(local, h_send)
        total = cc.all_reduce_(local.detach().clone(), ax)
        return local + (total - local).detach()

    return pipeline_loss


def make_afab_eval_fn(embed_fn: Callable, stage_fn: Callable,
                      head_metrics_fn: Callable, spec: PipelineSpec, *,
                      mesh=None):
    """Forward-only pipeline evaluation: ``eval_fn(params, (x, y)) ->
    {name: scalar}``, each the mean over the micro-batches of
    ``head_metrics_fn(params, h, y)`` (per-micro-batch means, computed on
    the last stage), the same on every pp rank (one sum over pp). No
    gradients, no dropout."""
    M = spec.n_micro

    @torch.no_grad()
    def eval_fn(params, batch):
        ax = cc.resolve_axis(spec.pp_axis, mesh)
        x, y = batch
        xs, ys = _split_micro(x, M), _split_micro(y, M)
        s, P = ax.index, ax.size
        first, last = s == 0, s == P - 1
        dev = next(v for _, v in tree_leaves(params)).device
        tmpl = _eval_shape(embed_fn, params, xs[0])
        split = isinstance(head_metrics_fn, SplitHead)
        totals = {}
        if not split:        # the names, for the stages that run no head
            totals = {k: torch.zeros((), device=dev) for k in _eval_shape(
                head_metrics_fn, params, tmpl, ys[0])}
        h_send = _zeros(tmpl, dev)
        for t in range(M + P - 1):
            h_recv = cc.ppermute_shift(h_send, ax, shift=1, wrap=False)
            m = t - s
            active = 0 <= m < M
            if active:
                h_in = _call_embed(embed_fn, params, xs[m], None) if first \
                    else h_recv
                h_out, _ = _stage_out(
                    _call_stage(stage_fn, params["blocks"], h_in, None))
            else:
                h_out = h_recv
            valid = last and active
            if valid or split:
                mets = _apply_head(head_metrics_fn, params, h_out,
                                   ys[min(max(m, 0), M - 1)], valid)
                for k, v in mets.items():
                    totals[k] = totals.get(k, 0.0) + v / M
            h_send = h_out
        names = sorted(totals)
        total = cc.all_reduce_(torch.stack([totals[k] for k in names]), ax)
        return dict(zip(names, total.unbind(0)))

    return eval_fn


def make_1f1b_grad_fn(embed_fn: Callable, stage_fn: Callable,
                      head_loss_fn: Callable, spec: PipelineSpec, *,
                      store_activations: bool = False, mesh=None):
    """``grad_fn(params, (x, y), generator=None) -> (loss, {path:
    grad})`` running the 1F1B schedule; plug it into
    ``make_parallel_train_step(grad_fn=...)`` with
    ``partial_axes=("pp",)``. The loss is summed over pp (the same on
    every rank); the gradients are this rank's partials, summed over the
    micro-batches (each micro-batch's loss carries its ``1 / M``). A
    MoE stage's aux loss (``1 / M`` too) is seeded with 1 on every stage
    at its backward sub-step and summed into the loss over pp.

    ``store_activations=False`` (``1f1b``): the backward sub-step reruns
    the micro-batch's forward from its saved stage input under autograd.
    ``store_activations=True`` (``1f1b_stored``): the forward sub-step
    runs under autograd and keeps the graph until the backward sub-step.
    The same gradients either way; the choice trades forward work
    against memory."""
    M = spec.n_micro

    def grad_fn(params, batch, generator=None):
        ax = cc.resolve_axis(spec.pp_axis, mesh)
        x, y = batch
        xs, ys = _split_micro(x, M), _split_micro(y, M)
        s, P = ax.index, ax.size
        first, last = s == 0, s == P - 1
        T, CAP = M + 2 * (P - 1), 2 * P - 1
        paths, leaves = zip(*tree_leaves(params))
        dev = leaves[0].device
        zeros = _zeros(_eval_shape(embed_fn, params, xs[0]), dev)
        g_acc = [torch.zeros_like(p) for p in leaves]
        slots = [None] * CAP
        loss_acc = torch.zeros((), device=dev)

        def mb_fn(h_recv, m):
            """One micro-batch on this stage: (stage output, loss / M,
            aux / M or None). The head runs on the last stage only (a
            SplitHead's reduce part everywhere); a MoE stage's aux on
            every stage."""
            g_e, g_s = _mb_generators(generator, m, s)
            h_in = _call_embed(embed_fn, params, xs[m], g_e) if first \
                else h_recv
            h_out, aux = _stage_out(
                _call_stage(stage_fn, params["blocks"], h_in, g_s))
            return (h_out, _apply_head(head_loss_fn, params, h_out, ys[m],
                                       last) / M,
                    None if aux is None else aux / M)

        h_send = g_send = zeros
        for t in range(T):
            # forward sub-step: micro-batch t - s
            h_recv = cc.ppermute_shift(h_send, ax, shift=1, wrap=False)
            m_f = t - s
            if 0 <= m_f < M:
                slot = m_f % CAP
                assert slots[slot] is None, (t, s, m_f)
                if store_activations:
                    h_in = h_recv.detach().requires_grad_(not first)
                    with torch.enable_grad():
                        h_out, loss_f, aux_f = mb_fn(h_in, m_f)
                    slots[slot] = (h_in, h_out, loss_f, aux_f)
                else:
                    with torch.no_grad():
                        h_out, loss_f, aux_f = mb_fn(h_recv, m_f)
                    slots[slot] = h_recv
                if last:
                    loss_acc += loss_f.detach()
                if aux_f is not None:
                    loss_acc += aux_f.detach()
                h_send = h_out.detach()
            else:
                h_send = zeros
            # backward sub-step: micro-batch t - 2(P - 1) + s, so that
            # stage s's g_send at tick t is stage s - 1's g_recv at t + 1
            g_recv = cc.ppermute_shift(g_send, ax, shift=-1, wrap=False)
            m_b = t - 2 * (P - 1) + s
            g_send = zeros
            if 0 <= m_b < M:
                slot = m_b % CAP
                if store_activations:
                    h_in, h_out, loss_b, aux_b = slots[slot]
                else:
                    h_in = slots[slot].requires_grad_(not first)
                    with torch.enable_grad():
                        h_out, loss_b, aux_b = mb_fn(h_in, m_b)
                slots[slot] = None
                outs, seeds = (([loss_b], [torch.ones_like(loss_b)]) if last
                               else ([h_out], [g_recv]))
                if aux_b is not None:     # every stage's own aux
                    outs, seeds = outs + [aux_b], seeds + [
                        torch.ones_like(aux_b)]
                inputs = leaves if first else leaves + (h_in,)
                gs = torch.autograd.grad(outs, inputs, seeds,
                                         allow_unused=True)
                for acc, g in zip(g_acc, gs):
                    if g is not None:
                        acc.add_(g)
                if not first and gs[-1] is not None:
                    g_send = gs[-1]
        loss = cc.all_reduce_(loss_acc, ax)
        return loss, dict(zip(paths, g_acc))

    return grad_fn

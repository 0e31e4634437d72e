"""Rank bodies of the port's sequence-parallel tests (``tests/
test_torch_sp.py``), run by ``_torch_dist.run_world``.

Each function runs in one process of a gloo world on the CPU, takes
numpy inputs made by the test in the parent (where the JAX goldens are
computed) and returns numpy results. Nothing here imports jax: the
children import this module by name.
"""

from __future__ import annotations

import numpy as np
import torch

from _torch_dist_cases import _np, strategy_steps
from quintnet_tpu_torch.core import collectives as cc

ATTENTIONS = ("ring", "zigzag", "ulysses")


def _sp_mesh(world, sp):
    """A mesh of this world whose sp axis has ``sp`` members (the rest of
    the world replicas on an axis ``x``) and that axis."""
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes

    mesh = mesh_from_sizes(x=world // sp, sp=sp)
    return mesh.axis("sp")


def _attend(name, q, k, v, ax, **kw):
    from quintnet_tpu_torch.ops.ring_attention import (ring_attention,
                                                       zigzag_ring_attention)
    from quintnet_tpu_torch.ops.ulysses_attention import ulysses_attention

    fn = {"ring": ring_attention, "zigzag": zigzag_ring_attention,
          "ulysses": ulysses_attention}[name]
    return fn(q, k, v, axis=ax, **kw)


def attention_cases(world, sp, arrays):
    """Every sp attention, causal and not, with and without segment ids,
    on this rank's slice of ``arrays`` (q, k, v, w [B, H, S, D] and seg
    [B, S]): ``{(name, causal, seg): (out, dq, dk, dv)}`` for the loss
    ``sum(out * w)``, each this rank's slice of the sequence."""
    ax = _sp_mesh(world, sp)
    n = arrays["q"].shape[2] // sp
    cut = slice(ax.index * n, (ax.index + 1) * n)
    out = {}
    for name in ATTENTIONS:
        for causal in (False, True):
            for seg in (False, True):
                q, k, v = (torch.tensor(arrays[a][:, :, cut])
                           .requires_grad_(True) for a in "qkv")
                ids = torch.tensor(arrays["seg"][:, cut]) if seg else None
                o = _attend(name, q, k, v, ax, causal=causal,
                            segment_ids=ids)
                (o * torch.tensor(arrays["w"][:, :, cut])).sum().backward()
                out[(name, causal, seg)] = tuple(
                    _np(t) for t in (o, q.grad, k.grad, v.grad))
    return out


def ulysses_indivisible(world):
    """Ulysses on 2 local heads over sp = 4: the ValueError's text."""
    ax = _sp_mesh(world, 4)
    q = torch.zeros(1, 2, 4, 4)
    try:
        _attend("ulysses", q, q, q, ax)
    except ValueError as e:
        return str(e)
    return None


def ppermute_case(world, perm, x, w, fixed):
    """``cc.ppermute`` of row ``rank`` of ``x`` under ``perm`` over the
    whole world, its gradient for the loss ``sum(y * w[rank])``, and the
    all-to-all form (gloo's on CUDA tensors) of the same permutation;
    then the same under ``fixed`` (fixed points only), with the number of
    collectives that it and its backward entered."""
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes

    ax = mesh_from_sizes(x=world).axis("x")

    def run(p):
        xr = torch.tensor(x[ax.index]).requires_grad_(True)
        y = cc.ppermute(xr, ax, p)
        if y.requires_grad:             # not where only zeros arrive
            (y * torch.tensor(w[ax.index])).sum().backward()
        return _np(y), (_np(xr.grad) if xr.grad is not None
                        else np.zeros_like(x[ax.index]))

    y, g = run(perm)
    dst, src = cc._endpoints(ax, perm)
    calls, real = [], cc.communicate
    cc.communicate = lambda *a, **k: calls.append(a[0]) or real(*a, **k)
    try:
        fy, fg = run(fixed)
    finally:
        cc.communicate = real
    return {"y": y, "grad": g, "fixed_y": fy, "fixed_grad": fg,
            "fixed_calls": len(calls),
            "all_to_all": _np(cc._permute_all_to_all(
                torch.tensor(x[ax.index]), ax, dst, src))}


def mha_cases(world, sp, np_params, x, seg, heads):
    """``nn/attention.mha_apply`` (causal, with segment ids) on this
    rank's slice of the sequence in each sp mode: {mode: y slice}."""
    from quintnet_tpu_torch.nn.attention import mha_apply

    ax = _sp_mesh(world, sp)
    n = x.shape[1] // sp
    cut = slice(ax.index * n, (ax.index + 1) * n)
    p = {k: {kk: torch.tensor(vv) for kk, vv in v.items()}
         for k, v in np_params.items()}
    return {mode: _np(mha_apply(p, torch.tensor(x[:, cut]), num_heads=heads,
                                causal=True, sp_axis=ax, sp_mode=mode,
                                segment_ids=torch.tensor(seg[:, cut])))
            for mode in ATTENTIONS}


def gpt2_forward_cases(world, sp, kw, np_params, ids):
    """``gpt2_apply`` on this rank's slice of the sequence in each sp
    mode: {mode: logits slice}."""
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_apply

    ax = _sp_mesh(world, sp)
    n = ids.shape[1] // sp
    cut = slice(ax.index * n, (ax.index + 1) * n)
    p = gpt2_params_from_numpy(np_params, "cpu")
    cfg = GPT2Config.tiny(**kw)
    with torch.no_grad():
        return {mode: _np(gpt2_apply(p, torch.tensor(ids[:, cut]).long(),
                                     cfg, sp_axis=ax, sp_mode=mode))
                for mode in ATTENTIONS}


def dropout_case(world, sp, arrays, pdrop, seed):
    """Attention-probability dropout on the ring and Ulysses paths, each
    rank's generator seeded as a training step seeds it
    (``device_dropout_generator``): at ``pdrop`` 0 the output equals the
    run without a generator bit for bit; at ``pdrop`` the masks drawn
    (recorded at ``nn/layers.dropout``'s two users: the share kept of
    the nonzero probabilities, and the first mask)."""
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes
    from quintnet_tpu_torch.nn import attention
    from quintnet_tpu_torch.ops import ring_attention
    from quintnet_tpu_torch.parallel.train_step import \
        device_dropout_generator

    mesh = mesh_from_sizes(x=world // sp, sp=sp)
    ax = mesh.axis("sp")
    n = arrays["q"].shape[2] // sp
    cut = slice(ax.index * n, (ax.index + 1) * n)
    q, k, v = (torch.tensor(arrays[a][:, :, cut]) for a in "qkv")
    masks = []
    real = ring_attention.dropout

    def recording(generator, x, rate, *, deterministic):
        y = real(generator, x, rate, deterministic=deterministic)
        masks.append((_np(y != 0), _np(x != 0)))
        return y

    out = {}
    ring_attention.dropout = attention.dropout = recording
    try:
        for mode in ("ring", "ulysses"):
            plain = _attend(mode, q, k, v, ax, causal=True)
            g = device_dropout_generator(seed, mesh, "cpu")
            zero = _attend(mode, q, k, v, ax, causal=True, pdrop=0.0,
                           generator=g)
            del masks[:]
            g = device_dropout_generator(seed, mesh, "cpu")
            _attend(mode, q, k, v, ax, causal=True, pdrop=pdrop, generator=g)
            kept = np.concatenate([m[nz] for m, nz in masks])
            out[mode] = {"zero_equal": bool(torch.equal(plain, zero)),
                         "keep": float(kept.mean()), "n": int(kept.size),
                         "masks": len(masks),
                         "first": masks[0][0] | ~masks[0][1]}
    finally:
        ring_attention.dropout = attention.dropout = real
    return out


def trainer_case(world, sizes, sp_mode, kw, ids):
    """``Trainer.fit`` (one epoch of one batch, AdamW lr 1e-3) and its
    evaluation of tiny GPT-2 on the mesh ``sizes`` in ``sp_mode``."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    config = Config.from_dict({
        "mesh_dim": list(sizes.values()), "mesh_name": list(sizes),
        "training": {"batch_size": len(ids), "optimizer": "adamw",
                     "learning_rate": 1e-3, "epochs": 1, "log_every": 0,
                     "sp_mode": sp_mode}})
    tr = Trainer(config, gpt2_model_spec(GPT2Config.tiny(**kw),
                                         sp_mode=sp_mode),
                 task_type="clm", device="cpu", log_fn=lambda m: None)
    t = torch.tensor(ids)
    params, _ = tr.init_state()
    before = tr.evaluate(params, [(t, t)])
    hist = tr.fit(lambda ep: [(t, t)], epochs=1,
                  val_batches_fn=lambda ep: [(t, t)])
    try:
        tr.strategy.shard_batch((t, t))
        no_model = None
    except ValueError as e:
        no_model = str(e)
    return {"strategy": tr.strategy.name, "eval_before": before["loss"],
            "train_loss": hist.train_loss, "val_loss": hist.val_loss,
            "no_model": no_model}


def sp_world_case(rank, world, jobs):
    """Every job of ``jobs`` (tag -> (kind, args, kwargs)) in this world,
    one after the other. Kinds: ``"attention"``, ``"indivisible"``,
    ``"ppermute"``, ``"mha"``, ``"forward"``, ``"dropout"``,
    ``"trainer"`` (the functions above) and ``"steps"``
    (``_torch_dist_cases.strategy_steps``)."""
    import torch.distributed as dist

    run = {"attention": attention_cases, "indivisible": ulysses_indivisible,
           "ppermute": ppermute_case, "mha": mha_cases,
           "forward": gpt2_forward_cases, "dropout": dropout_case,
           "trainer": trainer_case}
    out = {}
    for tag, (kind, args, kwargs) in jobs.items():
        if kind == "steps":
            out[tag] = strategy_steps(*args, **kwargs)
        else:
            out[tag] = run[kind](world, *args, **kwargs)
    dist.barrier()
    return out

"""Rank bodies of the port's distributed tests (run by ``_torch_dist``).

Each function runs in one process of a gloo world on the CPU, takes
numpy inputs made by the test in the parent (where the JAX goldens are
computed) and returns numpy results, which the parent compares rank by
rank. Nothing here imports jax: the children import this module by
name.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map


def _t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


def _np(t):
    return t.detach().cpu().numpy()


def _flat(tree):
    return {".".join(k): _np(v) for k, v in tree_leaves(tree)}


# ---------------------------------------------------------------------
# collectives: the goldens of tests/test_collectives.py, this rank's row
# ---------------------------------------------------------------------

def collectives_case(rank, world):
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes

    mesh = mesh_from_sizes(x=world)
    ax = mesh.axis("x")
    out = {}
    row = lambda a: _t(np.asarray(a)[rank:rank + 1])  # noqa: E731

    x = np.arange(8.0, dtype=np.float32).reshape(4, 2)
    out["all_reduce_sum"] = _np(cc.all_reduce(row(x), ax))

    c = np.arange(8.0, dtype=np.float32).reshape(4, 2)
    v = _t(np.ones((1, 2), np.float32), grad=True)
    (cc.all_reduce(v, "x", mesh) * row(c)).sum().backward()
    out["all_reduce_grad"] = _np(v.grad)

    out["all_gather_concat"] = _np(cc.all_gather(row(x), ax, gather_dim=-1))

    w = np.arange(32, dtype=np.float32).reshape(4, 8)
    v = _t(np.ones((1, 2), np.float32), grad=True)
    (cc.all_gather(v, ax, gather_dim=-1) * row(w)).sum().backward()
    out["all_gather_grad"] = _np(v.grad)

    out["reduce_scatter"] = _np(cc.reduce_scatter(
        _t(np.ones((1, 8), np.float32)), ax, scatter_dim=-1))

    xs = np.arange(4.0, dtype=np.float32).reshape(4, 1) + 1.0
    out["send_forward"] = _np(cc.send_forward(row(xs), ax))

    v = _t(np.arange(4.0, dtype=np.float32).reshape(4, 1)[rank:rank + 1],
           grad=True)
    wt = np.asarray([[0.0], [10.0], [20.0], [30.0]], np.float32)
    (cc.send_forward(v, ax) * row(wt)).sum().backward()
    out["send_forward_grad"] = _np(v.grad)

    out["broadcast_from"] = _np(cc.broadcast_from(
        row(np.arange(4.0, dtype=np.float32).reshape(4, 1)), ax, src=2))

    tree = {"a": row(np.arange(4.0, dtype=np.float32).reshape(4, 1)),
            "b": _t(np.ones((1, 3), np.float32))}
    red = cc.tree_all_reduce_mean(tree, ax)
    out["tree_mean_a"], out["tree_mean_b"] = _np(red["a"]), _np(red["b"])

    # the dp contract: the mean of per-shard gradients equals the
    # gradient over the whole batch
    wm = _t(np.asarray([[0.5, -1.0], [2.0, 0.25]], np.float32), grad=True)
    xb = np.arange(16.0, dtype=np.float32).reshape(8, 2) / 10.0
    local = _t(xb[2 * rank:2 * rank + 2])
    (g,) = torch.autograd.grad(((local @ wm) ** 2).sum(-1).mean(), wm)
    out["dp_mean_grad"] = _np(cc.all_reduce_mean(g, ax))

    # beyond the goldens: the other collectives and their transposes
    y = _t(np.arange(16.0, dtype=np.float32).reshape(4, 4)[rank:rank + 1]
           * (rank + 1))
    out["all_to_all"] = _np(cc.all_to_all(y.reshape(4, 1), ax, split_dim=0,
                                          concat_dim=1))
    v = _t(np.full((4, 1), rank + 1.0, np.float32), grad=True)
    wa = _t(np.arange(4.0, dtype=np.float32)[None, :] + 10 * rank)
    (cc.all_to_all(v, ax, split_dim=0, concat_dim=1) * wa).sum().backward()
    out["all_to_all_grad"] = _np(v.grad)
    out["all_gather_stacked"] = _np(cc.all_gather(
        _t(np.float32([rank, -rank])), ax, tiled=False))
    v = _t(np.ones((1, 8), np.float32), grad=True)
    (cc.reduce_scatter(v, ax, scatter_dim=-1) * (rank + 1)).sum().backward()
    out["reduce_scatter_grad"] = _np(v.grad)
    v = _t(np.float32([rank + 1.0]), grad=True)
    (cc.all_reduce_mean(v, ax) * (rank + 1)).sum().backward()
    out["all_reduce_mean_grad"] = _np(v.grad)
    v = _t(np.float32([rank + 1.0]), grad=True)
    (cc.ppermute_shift(v, ax, shift=1, wrap=True) * (rank + 1)).sum() \
        .backward()
    out["shift_wrap_grad"] = _np(v.grad)
    out["send_backward"] = _np(cc.send_backward(row(xs), ax))
    out["axis"] = np.asarray([cc.axis_index(ax), cc.axis_size("x", mesh)])
    return out


# ---------------------------------------------------------------------
# mesh: group membership per axis
# ---------------------------------------------------------------------

def mesh_case(rank, world, meshes):
    """:func:`_one_mesh` for each mesh of ``meshes`` (name -> size dicts
    over ``world`` ranks), built one after the other."""
    return [_one_mesh(rank, world, sizes) for sizes in meshes]


def _one_mesh(rank, world, sizes):
    """For the mesh ``sizes``: this rank's coordinates, and for every
    single axis and pair of adjacent axes the ranks its group sums over
    (an all_reduce of one-hot rank vectors), its line and its index."""
    from quintnet_tpu_torch.core.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec.create(**sizes))
    names = mesh.axis_names
    out = {"coords": dict(mesh.coords)}
    for k in (1, 2):
        for i in range(len(names) - k + 1):
            axes = names[i:i + k]
            onehot = torch.zeros(world)
            onehot[rank] = 1.0
            summed = cc.all_reduce(onehot, axes, mesh)
            out[axes] = sorted(int(r) for r in torch.nonzero(summed)[:, 0])
            out[(axes, "line")] = mesh.axis(axes).ranks
            out[(axes, "index")] = mesh.axis(axes).index
    return out


# ---------------------------------------------------------------------
# dp: the ViT step over 4 and 2 ranks (tests/test_dp.py)
# ---------------------------------------------------------------------

VIT_TINY = dict(image_size=14, patch_size=7, in_channels=1, hidden_dim=16,
                depth=2, num_heads=2, num_classes=10)


def _vit_params(np_params):
    from quintnet_tpu_torch.bridge import vit_params_from_numpy

    return tree_map(lambda t: t.requires_grad_(True),
                    vit_params_from_numpy(np_params, "cpu"))


def dp_case(rank, world, np_params, x, y):
    """``make_dp_train_step`` (SGD 0.1) on the 16-row batch: dp = world
    with no accumulation, then dp = 2 with accumulation 2 on ranks 0-1's
    world; plus the replica-identity check (all-reduced grads)."""
    from quintnet_tpu_torch.core.mesh import MeshSpec, build_mesh
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.vit import (ViTConfig, cross_entropy_loss,
                                               vit_apply)
    from quintnet_tpu_torch.parallel.dp import make_dp_train_step
    from quintnet_tpu_torch.train.trainer import make_optimizer

    cfg = ViTConfig(**VIT_TINY)
    opt = make_optimizer(Config.from_dict({"training": {
        "optimizer": "sgd", "learning_rate": 0.1}}))

    def loss_fn(p, batch, generator=None):
        return cross_entropy_loss(vit_apply(p, batch[0], cfg), batch[1])

    out = {}
    mesh = build_mesh(MeshSpec.create(dp=world))
    n = len(x) // world
    local = (torch.tensor(x[rank * n:(rank + 1) * n]),
             torch.tensor(y[rank * n:(rank + 1) * n]))
    p = _vit_params(np_params)
    p, _, loss = make_dp_train_step(mesh, loss_fn, opt)(
        p, opt.init(p), local)
    out["dp4_loss"], out["dp4_params"] = float(loss), _flat(p)

    # dp = 2 with accumulation 2: a (dp=2, x=world/2) mesh, batch over dp
    mesh2 = build_mesh(MeshSpec.create(dp=2, x=world // 2))
    i = mesh2.coords["dp"]
    half = len(x) // 2
    local = (torch.tensor(x[i * half:(i + 1) * half]),
             torch.tensor(y[i * half:(i + 1) * half]))
    p = _vit_params(np_params)
    p, _, loss = make_dp_train_step(mesh2, loss_fn, opt,
                                    grad_accum_steps=2)(p, opt.init(p), local)
    out["dp2_acc2_loss"], out["dp2_acc2_params"] = float(loss), _flat(p)

    p = _vit_params(np_params)
    n = len(x) // world
    grads = torch.autograd.grad(
        loss_fn(p, (torch.tensor(x[rank * n:(rank + 1) * n]),
                    torch.tensor(y[rank * n:(rank + 1) * n]))),
        [v for _, v in tree_leaves(p)])
    out["replica_grads"] = [_np(cc.all_reduce_mean(g, "dp", mesh))
                            for g in grads]
    return out


# ---------------------------------------------------------------------
# tp: layers, the ViT forward and step, reduce_grads (tests/test_tp.py)
# ---------------------------------------------------------------------

def tp_case(rank, world, arrays, np_params, x, y):
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.mesh import MeshSpec, build_mesh
    from quintnet_tpu_torch.models.vit import (ViTConfig, cross_entropy_loss,
                                               vit_apply, vit_partition_specs,
                                               vit_to_tp_layout)
    from quintnet_tpu_torch.parallel import tp as tpl
    from quintnet_tpu_torch.parallel.train_step import (
        make_parallel_train_step, reduce_grads)
    from quintnet_tpu_torch.train.trainer import make_optimizer

    mesh = build_mesh(MeshSpec.create(tp=world))
    ax = mesh.axis("tp")
    a = {k: torch.tensor(v) for k, v in arrays.items()}
    shard = lambda t, spec: tpl.shard_leaf(t, spec, mesh)  # noqa: E731
    out = {}
    out["column_gather"] = _np(tpl.column_parallel_linear(
        {"w": shard(a["cw"], (None, "tp")), "b": shard(a["cb"], ("tp",))},
        a["cx"], axis=ax, gather_output=True))
    out["row_self_sliced"] = _np(tpl.row_parallel_linear(
        {"w": shard(a["rw"], ("tp", None)), "b": a["rb"]}, a["rx"], axis=ax,
        input_is_parallel=False))
    h = torch.relu(tpl.column_parallel_linear(
        {"w": shard(a["w1"], (None, "tp"))}, a["fx"], axis=ax))
    out["column_then_row"] = _np(tpl.row_parallel_linear(
        {"w": shard(a["w2"], ("tp", None))}, h, axis=ax))
    out["vocab_embedding"] = _np(tpl.vocab_parallel_embedding(
        {"table": shard(a["table"], ("tp", None))}, a["ids"].long(),
        axis=ax))
    out["vocab_logits"] = _np(tpl.vocab_parallel_logits(
        {"w": shard(a["lw"], (None, "tp"))}, a["cx"], axis=ax))

    cfg = ViTConfig(**dict(VIT_TINY, num_heads=4))
    specs = vit_partition_specs(cfg)
    full = _vit_params(np_params)
    local = tree_map(lambda t, s: shard(t.detach(), s).requires_grad_(True),
                     vit_to_tp_layout(full, cfg, world), specs)
    out["vit_forward"] = _np(vit_apply(local, torch.tensor(x[:4]), cfg,
                                       tp_axis=ax))

    opt = make_optimizer(Config.from_dict({"training": {
        "optimizer": "sgd", "learning_rate": 0.05}}))

    def tp_loss(p, batch, generator=None):
        return cross_entropy_loss(vit_apply(p, batch[0], cfg, tp_axis=ax),
                                  batch[1])

    step = make_parallel_train_step(mesh, tp_loss, opt, specs,
                                    batch_axes=(), model_axes=("tp",))
    local, _, loss = step(local, opt.init(local),
                          (torch.tensor(x), torch.tensor(y)))
    out["vit_step_loss"] = float(loss)
    out["vit_step_params"] = _flat(local)

    g = {("rep",): torch.ones(2, 2), ("shard",): torch.ones(2, 2)}
    reduce_grads(g, {"rep": (), "shard": ("tp", None)}, mesh, data_axes=(),
                 model_axes=("tp",))
    out["reduce_rep"], out["reduce_shard"] = (_np(g[("rep",)]),
                                              _np(g[("shard",)]))
    return out


# ---------------------------------------------------------------------
# GPT-2: tp and dp x tp AdamW steps through the strategy
# ---------------------------------------------------------------------

def _gpt2_strategy_step(rank, world, mesh_dim, mesh_name, np_params, ids,
                        labels, accum, cfg_kw, training=None):
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.parallel.tp import gather_leaf
    from quintnet_tpu_torch.train.trainer import make_optimizer

    config = Config.from_dict({
        "mesh_dim": mesh_dim, "mesh_name": mesh_name,
        "training": {"optimizer": "adamw", "learning_rate": 1e-2,
                     "weight_decay": 0.01, "grad_clip_norm": 0.5,
                     "gradient_accumulation_steps": accum,
                     **(training or {})}})
    gcfg = GPT2Config.tiny(**cfg_kw)
    model = gpt2_model_spec(gcfg, use_flash=True)
    strat = get_strategy(None, config)
    opt = make_optimizer(config)
    full = gpt2_params_from_numpy(np_params, "cpu")
    params = tree_map(lambda t: t.requires_grad_(True),
                      strat.shard_params(model, full))
    state = strat.init_opt_state(model, opt, params)
    step = strat.make_train_step(model, opt)
    batch = strat.shard_batch((torch.tensor(ids).long(),
                               torch.tensor(labels).long()))
    params, state, loss = step(params, state, batch)
    specs = dict(tree_leaves(strat.param_specs(model)))

    def gathered(tree):
        return {".".join(k): _np(gather_leaf(v.detach(), specs[k],
                                             strat.mesh))
                for k, v in tree_leaves(tree)}

    mu = dict(tree_leaves(state["mu"]))
    return {"strategy": strat.name, "loss": float(loss),
            "params": gathered(params), "mu": gathered(state["mu"]),
            "coords": strat.mesh.coords, "fsdp_axis": strat.fsdp_axis,
            "specs": {".".join(k): v for k, v in specs.items()},
            "local_numel": {".".join(k): (v.numel(), mu[k].numel())
                            for k, v in tree_leaves(params)
                            if k[0] == "blocks"}}


def gpt2_mesh_case(rank, world, np_params, ids, labels, runs):
    """Every (mesh_dim, mesh_name, accum[, training keys]) run of
    ``runs`` in this world, one after the other."""
    return [_gpt2_strategy_step(rank, world, md, mn, np_params, ids, labels,
                                acc, {"n_layer": 2}, *training)
            for md, mn, acc, *training in runs]


# ---------------------------------------------------------------------
# dropout: tp ranks agree with one device, dp ranks differ
# ---------------------------------------------------------------------

def dropout_case(rank, world, np_params, ids, labels, seed):
    """Losses of one dropout step per mesh (the world's size each): tp =
    world and dp = world, with the model's dropout on; plus the per-rank
    folded seeds."""
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.parallel.train_step import device_dropout_seed
    from quintnet_tpu_torch.train.trainer import make_optimizer

    gcfg = GPT2Config.tiny(n_layer=2, embd_pdrop=0.1, attn_pdrop=0.0,
                           resid_pdrop=0.1)
    out = {}
    for axis in ("tp", "dp"):
        config = Config.from_dict({
            "mesh_dim": [world], "mesh_name": [axis],
            "training": {"optimizer": "sgd", "learning_rate": 0.1}})
        strat = get_strategy(None, config)
        model = gpt2_model_spec(gcfg)
        opt = make_optimizer(config)
        params = tree_map(lambda t: t.requires_grad_(True),
                          strat.shard_params(model, gpt2_params_from_numpy(
                              np_params, "cpu")))
        batch = strat.shard_batch((torch.tensor(ids).long(),
                                   torch.tensor(labels).long()))
        gen = strat.dropout_generator(seed, "cpu")
        _, _, loss = strat.make_train_step(model, opt)(
            params, opt.init(params), batch, gen)
        out[axis] = float(loss)
        out[axis + "_seed"] = device_dropout_seed(seed, strat.mesh)
    return out


# ---------------------------------------------------------------------
# Trainer.fit on dp = 2 against one device
# ---------------------------------------------------------------------

def trainer_case(rank, world, np_params, batches, val, training=None):
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.parallel.tp import gather_leaf
    from quintnet_tpu_torch.train.trainer import Trainer

    config = Config.from_dict({
        "mesh_dim": [world], "mesh_name": ["dp"],
        "training": {"optimizer": "sgd", "learning_rate": 0.1,
                     "grad_clip_norm": 1.0, "log_every": 1, "seed": 0,
                     **(training or {})}})
    logs = []
    tr = Trainer(config, gpt2_model_spec(GPT2Config.tiny(n_layer=2)),
                 task_type="clm", device="cpu", log_fn=logs.append)
    params = tree_map(lambda t: t.requires_grad_(True),
                      tr.strategy.shard_params(tr.model, gpt2_params_from_numpy(
                          np_params, "cpu")))
    hist = tr.fit(lambda ep: [batches[ep]], epochs=len(batches),
                  params=params, opt_state=tr.strategy.init_opt_state(
                      tr.model, tr.optimizer, params),
                  val_batches_fn=lambda ep: [val])
    p, s = tr.final_state
    specs = dict(tree_leaves(tr.strategy.param_specs(tr.model)))
    return {"train_loss": hist.train_loss, "val_loss": hist.val_loss,
            "params": {".".join(k): _np(gather_leaf(v.detach(), specs[k],
                                                    tr.strategy.mesh))
                       for k, v in tree_leaves(p)},
            "logs": len(logs), "strategy": tr.strategy.name,
            "fsdp_axis": tr.strategy.fsdp_axis}


# ---------------------------------------------------------------------
# the worlds: one per test module, every case of the module inside it
# ---------------------------------------------------------------------

def tp_world_case(rank, world, tp_args, gpt2_args, drop_args, trainer_args):
    """tests/test_torch_tp.py's world of 2 ranks: the tp layers and the
    ViT (:func:`tp_case`), the GPT-2 tp = 2 step, the dropout
    properties, and ``Trainer.fit`` on dp = 2."""
    return {"tp": tp_case(rank, world, *tp_args),
            "gpt2": gpt2_mesh_case(rank, world, *gpt2_args),
            "dropout": dropout_case(rank, world, *drop_args),
            "trainer": trainer_case(rank, world, *trainer_args)}


def dp_world_case(rank, world, dp_args, gpt2_args):
    """tests/test_torch_dp.py's world of 4 ranks: the ViT dp steps
    (:func:`dp_case`) and the GPT-2 dp x tp = 2 x 2 step."""
    return {"dp": dp_case(rank, world, *dp_args),
            "gpt2": gpt2_mesh_case(rank, world, *gpt2_args)}


# ---------------------------------------------------------------------
# pipelines: AFAB, 1F1B and 1F1B-stored against one device
# ---------------------------------------------------------------------

PP_SCHEDULES = ("afab", "1f1b", "1f1b_stored")


def pp_model(name, kw):
    """The tiny model of a pipeline case: ``("gpt2", GPT2Config.tiny
    kwargs)`` or ``("vit", ViTConfig kwargs)``."""
    if name == "gpt2":
        from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec

        return gpt2_model_spec(GPT2Config.tiny(**kw), use_flash=True)
    from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec

    return vit_model_spec(ViTConfig(**kw))


def pp_params(name, np_params):
    from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                           vit_params_from_numpy)

    fn = gpt2_params_from_numpy if name == "gpt2" else vit_params_from_numpy
    return fn(np_params, "cpu")


def pipeline_grads(mesh, model, full, batch, schedule, n_micro,
                   generator=None):
    """(pp-summed loss, every gradient leaf gathered whole) of one step of
    ``schedule`` over ``mesh``'s pp axis, the gradients reduced over pp
    as the train step reduces them."""
    from quintnet_tpu_torch.parallel.pp import (PipelineSpec,
                                                make_1f1b_grad_fn,
                                                make_afab_loss_fn)
    from quintnet_tpu_torch.parallel.tp import gather_leaf, shard_leaf
    from quintnet_tpu_torch.parallel.train_step import (accumulate_grads,
                                                        reduce_grads)

    specs = model.partition_specs(pp_axis="pp")
    local = tree_map(lambda t, s: shard_leaf(t.detach(), s, mesh)
                     .requires_grad_(True), full, specs)
    fns = model.pipeline_fns()
    pspec = PipelineSpec(n_micro, mesh.axis("pp"))
    if schedule == "afab":
        loss, grads = accumulate_grads(make_afab_loss_fn(*fns, pspec), local,
                                       batch, 1, generator)
    else:
        loss, grads = make_1f1b_grad_fn(
            *fns, pspec, store_activations=schedule == "1f1b_stored")(
                local, batch, generator)
    reduce_grads(grads, specs, mesh, data_axes=(), model_axes=(),
                 partial_axes=("pp",))
    by_path = dict(tree_leaves(specs))
    return float(loss), {".".join(k): _np(gather_leaf(g, by_path[k], mesh))
                         for k, g in grads.items()}


def _shift_forms(mesh):
    """The shift's two implementations (point-to-point and the
    all-to-all that gloo runs on CUDA tensors) on this rank's pp axis,
    for each direction with and without wrap: {(shift, wrap): (p2p,
    all_to_all)}."""
    ax = mesh.axis("pp")
    x = torch.arange(6.0).reshape(2, 3) + 10 * ax.index
    ends = {(sh, wrap): cc._neighbours(ax, sh, wrap)
            for sh in (1, -1) for wrap in (False, True)}
    return {k: (_np(cc._permute_p2p(x, ax, *e)),
                _np(cc._permute_all_to_all(x, ax, *e)))
            for k, e in ends.items()}


def pp_world_case(rank, world, runs, drop_run, n_micro):
    """tests/test_torch_pp.py's world: every (model, pp, schedule) of
    ``runs`` (each a (name, model kwargs, numpy params, x, y, pp)) on an
    (x, pp) mesh of this world (x holds replicas), the dropout run (a
    GPT-2 run with a step seed) under every schedule, and the shift's
    two implementations on pp = world."""
    from quintnet_tpu_torch.core.mesh import MeshSpec, build_mesh

    out = {}
    meshes = {}
    for name, kw, np_params, x, y, pp in runs:
        if pp not in meshes:
            meshes[pp] = build_mesh(MeshSpec.create(x=world // pp, pp=pp))
        model = pp_model(name, kw)
        full = pp_params(name, np_params)
        batch = (torch.tensor(x), torch.tensor(y))
        for sched in PP_SCHEDULES:
            out[(name, pp, sched)] = pipeline_grads(
                meshes[pp], model, full, batch, sched, n_micro)
    name, kw, np_params, x, y, pp, seed = drop_run
    model = pp_model(name, kw)
    full = pp_params(name, np_params)
    for sched in PP_SCHEDULES:
        out[("dropout", sched)] = pipeline_grads(
            meshes[pp], model, full, (torch.tensor(x), torch.tensor(y)),
            sched, n_micro, torch.Generator().manual_seed(seed))
    out["shift"] = _shift_forms(meshes[world])
    return out


# ---------------------------------------------------------------------
# ZeRO-1/2 against replicated AdamW, and the 3D 1F1B ZeRO step
# ---------------------------------------------------------------------

ZERO_TRAINING = {"learning_rate": 1e-3, "weight_decay": 0.01,
                 "grad_clip_norm": 1.0}


def _zero_vit_runs(mesh, np_params, x, y, runs):
    """Each (tag, optimizer, accumulation, mu dtype) of ``runs``: three
    steps of ``make_parallel_train_step`` on ``mesh`` (batch over dp,
    tp = the mesh's), recording each step's loss, the parameters after
    steps 1 and 3 gathered whole (tp-blocked layout), this rank's Adam
    state after step 1 (flat in ``parallel/zero``'s order: a ZeRO chunk,
    or the replicated moments flattened) and the chunk length."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.vit import (ViTConfig, cross_entropy_loss,
                                               vit_apply, vit_partition_specs,
                                               vit_to_tp_layout)
    from quintnet_tpu_torch.parallel import zero
    from quintnet_tpu_torch.parallel.tp import gather_leaf, shard_leaf
    from quintnet_tpu_torch.parallel.train_step import \
        make_parallel_train_step
    from quintnet_tpu_torch.train.trainer import make_optimizer

    cfg = ViTConfig(**ZERO_VIT)
    tp = mesh.shape.get("tp", 1)
    tp_axis = mesh.axis("tp") if tp > 1 else None
    specs = vit_partition_specs(cfg, tp_axis="tp" if tp > 1 else None)
    by_path = dict(tree_leaves(specs))
    dp = mesh.axis("dp")
    n = len(x) // dp.size
    batch = (torch.tensor(x[dp.index * n:(dp.index + 1) * n]),
             torch.tensor(y[dp.index * n:(dp.index + 1) * n]))

    def loss_fn(p, b, generator=None):
        return cross_entropy_loss(vit_apply(p, b[0], cfg, tp_axis=tp_axis),
                                  b[1])

    out = {}
    for tag, optimizer, accum, mu_dtype in runs:
        opt = make_optimizer(Config.from_dict({"training": dict(
            ZERO_TRAINING, optimizer="adamw",
            adam_mu_dtype=mu_dtype or "float32")}))
        zaxis = "dp" if optimizer.startswith("zero") else None
        full = _vit_params(np_params)
        params = tree_map(lambda t, s: shard_leaf(t.detach(), s, mesh)
                          .requires_grad_(True),
                          vit_to_tp_layout(full, cfg, tp), specs)
        state = (zero.init_chunk_state(opt, params, mesh) if zaxis
                 else opt.init(params))
        step = make_parallel_train_step(
            mesh, loss_fn, opt, specs, batch_axes=("dp",),
            model_axes=("tp",) if tp > 1 else (), partial_axes=(),
            grad_accum_steps=accum,
            grad_clip_norm=ZERO_TRAINING["grad_clip_norm"],
            zero1_axis=zaxis, zero_stage=2 if optimizer.startswith("zero2")
            else 1)
        run = {"losses": []}
        for i in range(3):
            params, state, loss = step(params, state, batch)
            run["losses"].append(float(loss))
            if i in (0, 2):
                run[f"params{i + 1}"] = {
                    ".".join(k): _np(gather_leaf(v.detach(), by_path[k],
                                                 mesh)).copy()
                    for k, v in tree_leaves(params)}
            if i == 0:
                order = zero.flat_order(params)
                for m in ("mu", "nu"):
                    st = state[m]
                    run[m] = (st.detach().float().numpy().copy() if zaxis else
                              zero.flatten(dict(tree_leaves(st)), order)
                              .float().numpy())
                    run[m + "_dtype"] = str((st if zaxis else next(
                        v for _, v in tree_leaves(st))).dtype)
                run["n_local"] = sum(v.numel() for _, v in tree_leaves(params))
        out[tag] = run
    return out


def _chunk_norm_case(mesh, np_params, x, y):
    """The global norm of a dp x tp ViT's reduced gradients two ways:
    ``clip_sharded_grads``'s (``sharded_global_norm``) and ZeRO-2's,
    from this rank's dp chunk with ``zero.grad_weights``."""
    from quintnet_tpu_torch.models.vit import (ViTConfig, cross_entropy_loss,
                                               vit_apply, vit_partition_specs,
                                               vit_to_tp_layout)
    from quintnet_tpu_torch.parallel import zero
    from quintnet_tpu_torch.parallel.tp import shard_leaf
    from quintnet_tpu_torch.parallel.train_step import (accumulate_grads,
                                                        reduce_grads,
                                                        sharded_global_norm)

    cfg = ViTConfig(**ZERO_VIT)
    specs = vit_partition_specs(cfg)
    tp_axis = mesh.axis("tp")
    params = tree_map(lambda t, s: shard_leaf(t.detach(), s, mesh)
                      .requires_grad_(True),
                      vit_to_tp_layout(_vit_params(np_params), cfg, 2), specs)
    dp = mesh.axis("dp")
    n = len(x) // dp.size
    _, grads = accumulate_grads(
        lambda p, b, g=None: cross_entropy_loss(
            vit_apply(p, b[0], cfg, tp_axis=tp_axis), b[1]), params,
        (torch.tensor(x[dp.index * n:(dp.index + 1) * n]),
         torch.tensor(y[dp.index * n:(dp.index + 1) * n])), 1)
    reduce_grads(grads, specs, mesh, data_axes=("dp",), model_axes=("tp",))
    want = float(sharded_global_norm(grads, specs, mesh,
                                     model_axes=("tp", "dp")))
    order = zero.flat_order(params)
    chunk = zero.chunk_size(sum(v.numel() for v in grads.values()), dp.size)
    g = zero.local_chunk(zero.flatten(grads, order), dp.size, dp.index,
                         chunk)
    w = zero.local_chunk(zero.grad_weights(params, specs, mesh,
                                           skip_axis="dp"),
                         dp.size, dp.index, chunk)
    ss = cc.all_reduce_((w * g.square()).sum(), mesh.axis(mesh.axis_names))
    return want, float(torch.sqrt(ss))


ZERO_VIT = dict(image_size=14, patch_size=7, in_channels=1, hidden_dim=16,
                depth=4, num_heads=2, num_classes=10)
ZERO_VIT_RUNS = (("adamw", "adamw", 1, None),
                 ("zero1_adamw", "zero1_adamw", 1, None),
                 ("zero2_adamw", "zero2_adamw", 1, None))


def _gpt2_3d_step(gpt2_np, ids, optimizer):
    """One step of the tiny GPT-2 (4 layers, 4 heads) on the 2 x 2 x 2 dp x
    tp x pp mesh through ``get_strategy`` (1F1B over 2 micro-batches,
    ``optimizer``, clip 1.0): the loss, the parameters gathered whole
    (tp-blocked layout), this rank's Adam ``mu`` chunk and its
    coordinates."""
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.parallel import zero
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.parallel.tp import gather_leaf
    from quintnet_tpu_torch.train.trainer import make_optimizer

    config = Config.from_dict({
        "mesh_dim": [2, 2, 2], "mesh_name": ["dp", "tp", "pp"],
        "training": dict(GPT2_3D_TRAINING, optimizer=optimizer)})
    model = pp_model("gpt2", GPT2_3D)
    strat = get_strategy(None, config)
    opt = make_optimizer(config)
    params = tree_map(lambda t: t.requires_grad_(True), strat.shard_params(
        model, gpt2_params_from_numpy(gpt2_np, "cpu")))
    state = strat.init_opt_state(model, opt, params)
    step = strat.make_train_step(model, opt)
    batch = strat.shard_batch((torch.tensor(ids), torch.tensor(ids)))
    params, state, loss = step(params, state, batch)
    specs = dict(tree_leaves(strat.param_specs(model)))
    return {"strategy": strat.name, "zero": (strat.zero1_axis,
                                             strat.zero_stage),
            "loss": float(loss), "coords": strat.mesh.coords,
            "params": {".".join(k): _np(gather_leaf(v.detach(), specs[k],
                                                    strat.mesh))
                       for k, v in tree_leaves(params)},
            "mu": _np(state["mu"] if torch.is_tensor(state["mu"]) else
                      zero.flatten(dict(tree_leaves(state["mu"])),
                                   zero.flat_order(params)))}


GPT2_3D = dict(n_layer=4, n_head=4)
GPT2_3D_TRAINING = {"batch_size": 32, "gradient_accumulation_steps": 2,
                    "schedule": "1f1b", "learning_rate": 1e-3,
                    "weight_decay": 0.01, "grad_clip_norm": 1.0}


def zero_world_case(rank, world, vit_np, x, y, gpt2_np, ids):
    """tests/test_torch_zero.py's world of 8 ranks: the ViT ZeRO runs on
    dp = 2 (an (x = 4, dp = 2) mesh: x holds replicas) and on dp x tp =
    2 x 2 (x = 2), ZeRO-2 chunk accumulation and the bf16 first moment on
    dp = 2, the chunk-space norm, and the 3D 1F1B GPT-2 step with
    ``zero2_adamw`` and ``zero1_adamw``."""
    from quintnet_tpu_torch.core.mesh import MeshSpec, build_mesh

    dp2 = build_mesh(MeshSpec.create(x=world // 2, dp=2))
    dptp = build_mesh(MeshSpec.create(x=world // 4, dp=2, tp=2))
    out = {"dp2": _zero_vit_runs(dp2, vit_np, x, y, ZERO_VIT_RUNS + (
        ("zero1_acc2", "zero1_adamw", 2, None),
        ("zero2_acc2", "zero2_adamw", 2, None),
        ("adamw_mu_bf16", "adamw", 1, "bfloat16"),
        ("zero1_mu_bf16", "zero1_adamw", 1, "bfloat16"))),
        "dptp": _zero_vit_runs(dptp, vit_np, x, y, ZERO_VIT_RUNS),
        "norm": _chunk_norm_case(dptp, vit_np, x, y),
        "coords": {"dp2": dp2.coords, "dptp": dptp.coords}}
    out["3d"] = {opt: _gpt2_3d_step(gpt2_np, ids, opt)
                 for opt in ("zero2_adamw", "zero1_adamw")}
    return out


# ---------------------------------------------------------------------
# the strategy facade's axis roles on pp and ZeRO meshes
# ---------------------------------------------------------------------

def strategy_roles(name, sizes, training):
    """``get_strategy(name, config)``'s name and axis roles (with
    ``zero1_axis``, ``zero_stage`` and ``fsdp_axis``) for a mesh
    ``sizes``."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.parallel.strategy import get_strategy

    s = get_strategy(name, Config.from_dict({
        "mesh_dim": list(sizes.values()), "mesh_name": list(sizes),
        "training": training}))
    return {"name": s.name, "batch_axes": s.batch_axes,
            "model_axes": s.model_axes, "partial_axes": s.partial_axes,
            "zero1_axis": s.zero1_axis, "zero_stage": s.zero_stage,
            "uses_pp": s.uses_pp, "fsdp_axis": s.fsdp_axis}


def strategy_case(rank, world, cases):
    """:func:`strategy_roles` of each (case id, name, sizes, training)
    of ``cases``, one after the other (each builds its own mesh). A
    barrier at the end: no rank leaves the world (and closes its
    connections) before every rank has finished joining it."""
    import torch.distributed as dist

    out = {cid: strategy_roles(name, sizes, training)
           for cid, name, sizes, training in cases}
    dist.barrier()
    return out


# ---------------------------------------------------------------------
# ZeRO-3 / FSDP: the steps of tests/test_torch_fsdp.py
# ---------------------------------------------------------------------

def fsdp_model(name, kw, remat=False):
    """The tiny model of an fsdp case (``pp_model``'s, without flash
    attention for GPT-2 so that the CPU runs the plain attention either
    way, and with ``remat``)."""
    if name == "gpt2":
        from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec

        return gpt2_model_spec(GPT2Config.tiny(**kw), remat=remat)
    from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec

    return vit_model_spec(ViTConfig(**kw), remat=remat)


def fsdp_sgd_step(name, kw, np_params, x, y, accum=1, remat=False,
                  sizes=None):
    """One SGD step (lr 0.05, no clipping) of the tiny model through
    ``get_strategy`` on the mesh ``sizes`` with ``training.fsdp`` (one
    device without ``sizes``): the loss and every parameter gathered
    whole."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.parallel.tp import gather_leaf
    from quintnet_tpu_torch.train.trainer import make_optimizer

    training = {"optimizer": "sgd", "learning_rate": 0.05,
                "gradient_accumulation_steps": accum}
    d = {"training": training}
    if sizes:
        d.update(mesh_dim=list(sizes.values()), mesh_name=list(sizes))
        training["fsdp"] = True
    config = Config.from_dict(d)
    model = fsdp_model(name, kw, remat)
    strat = get_strategy(None, config)
    opt = make_optimizer(config)
    params = tree_map(lambda t: t.requires_grad_(True), strat.shard_params(
        model, pp_params(name, np_params)))
    state = strat.init_opt_state(model, opt, params)
    batch = strat.shard_batch((torch.tensor(x), torch.tensor(y)))
    params, state, loss = strat.make_train_step(model, opt)(params, state,
                                                            batch)
    specs = dict(tree_leaves(strat.param_specs(model)))
    return {"loss": float(loss), "fsdp_axis": strat.fsdp_axis,
            "params": {".".join(k): _np(gather_leaf(v.detach(), specs[k],
                                                    strat.mesh))
                       for k, v in tree_leaves(params)}}


def fsdp_dp2_world_case(rank, world, gpt2_args, sgd_runs, trainer_args,
                        jobs=None):
    """tests/test_torch_fsdp.py's world of 2 ranks (dp = 2, fsdp): the
    GPT-2 AdamW step (:func:`gpt2_mesh_case`), the SGD steps of
    ``sgd_runs`` (tag -> :func:`fsdp_sgd_step`'s arguments: GPT-2 plain,
    under remat and with accumulation, ViT), ``Trainer.fit`` with
    evaluation and the ``jobs`` of :func:`jobs_world_case` (Llama)."""
    out = {"gpt2": gpt2_mesh_case(rank, world, *gpt2_args),
           "trainer": trainer_case(rank, world, *trainer_args,
                                   {"fsdp": True})}
    for tag, (name, kw, np_params, x, y, accum, remat) in sgd_runs.items():
        out[tag] = fsdp_sgd_step(name, kw, np_params, x, y, accum, remat,
                                 sizes={"dp": world})
    out.update(jobs_world_case(rank, world, jobs or {}))
    return out


def fsdp_dp4tp2_world_case(rank, world, gpt2_args, jobs):
    """tests/test_torch_fsdp.py's world of 8 ranks: the GPT-2 AdamW step
    on dp x tp = 4 x 2 (:func:`gpt2_mesh_case`) and the ``jobs`` of
    :func:`jobs_world_case` (the MoE GPT-2 on dp x ep = 4 x 2)."""
    return {"gpt2": gpt2_mesh_case(rank, world, *gpt2_args),
            **jobs_world_case(rank, world, jobs)}


# ---------------------------------------------------------------------
# sharded checkpoints on a 2 x 2 x 2 world (tests/test_torch_checkpoint_
# mesh.py)
# ---------------------------------------------------------------------

def _leaves_np(tree):
    return {".".join(k): _np(v).copy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in tree_leaves(tree)}


def _vit_3d_state(vit_np, optimizer):
    """The tiny ViT's 3D strategy, its shards and their fresh optimizer
    state under ``optimizer``, and the spec tree of the saved state."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.train.checkpoint import CHUNK
    from quintnet_tpu_torch.train.trainer import make_optimizer

    config = Config.from_dict({"mesh_dim": [2, 2, 2],
                               "mesh_name": ["dp", "tp", "pp"],
                               "training": {"optimizer": optimizer}})
    strat = get_strategy(None, config)
    model = pp_model("vit", CKPT_VIT)
    opt = make_optimizer(config)
    params = strat.shard_params(model, pp_params("vit", vit_np))
    state = strat.init_opt_state(model, opt, params)
    ps = strat.param_specs(model)
    specs = {"params": ps, "opt": {k: ((CHUNK if torch.is_tensor(v) else ps)
                                       if k in ("mu", "nu") else ())
                                   for k, v in state.items()}}
    return strat, model, params, state, specs


CKPT_VIT = dict(image_size=14, patch_size=7, in_channels=1, hidden_dim=16,
                depth=4, num_heads=2, num_classes=10)


def _round_trip(vit_np, optimizer, directory):
    """Save steps 0 and 5 of a 3D ViT state (moments made non-zero) with
    ``max_to_keep=2`` and restore the newest onto fresh zeros: equal bit
    for bit on this rank?"""
    from quintnet_tpu_torch.train.checkpoint import CheckpointManager

    strat, _, params, state, specs = _vit_3d_state(vit_np, optimizer)
    with torch.no_grad():     # moments as a run leaves them: replicas
        for i, name in enumerate(("mu", "nu")):    # agree, chunks do not
            if torch.is_tensor(state[name]):
                state[name].copy_(torch.arange(state[name].numel()) * 0.5
                                  + strat.mesh.rank + i)
            else:
                state[name] = tree_map(lambda p: p * 2.0 + i, params)
    state["count"] = 7
    saved = {"params": params, "opt": state, "step": 0}
    mgr = CheckpointManager(directory, max_to_keep=2, mesh=strat.mesh)
    for step in (0, 5):
        mgr.save(step, dict(saved, step=step), specs=specs,
                 meta={"strategy": strat.name})
    zeros = tree_map(torch.zeros_like, {"params": params, "opt": {
        k: v for k, v in state.items() if k != "count"}})
    zeros["opt"]["count"] = 0
    zeros["step"] = 0
    got = mgr.restore(zeros, specs=specs)
    want = _leaves_np(dict(saved, step=5))
    have = _leaves_np(got)
    return {"steps": mgr.all_steps(), "equal": set(want) == set(have) and all(
        np.array_equal(have[k], want[k]) for k in want),
        "count_type": type(got["opt"]["count"]).__name__}


def _restore_elsewhere(vit_np, directory):
    """A 3D save (tp = 2, ZeRO-1 chunks) restored onto a dp = 8 mesh of
    the same world: the parameters converted to the standard QKV layout
    with the head count, and refused without it; the chunks refused."""
    from quintnet_tpu_torch.core.mesh import MeshSpec, build_mesh
    from quintnet_tpu_torch.parallel.tp import gather_leaf
    from quintnet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                     MeshMismatchError)

    strat, model, params, state, specs = _vit_3d_state(vit_np,
                                                       "zero1_adam")
    CheckpointManager(directory, mesh=strat.mesh).save(
        1, {"params": params, "opt": state}, specs=specs)
    dp8 = build_mesh(MeshSpec.create(dp=8))
    mgr = CheckpointManager(directory, mesh=dp8)
    full = pp_params("vit", vit_np)
    template = {"params": tree_map(torch.zeros_like, full)}
    out = {}
    try:
        mgr.restore(template)
    except MeshMismatchError as e:
        out["no_heads"] = str(e)
    try:
        mgr.restore({"params": template["params"],
                     "opt": {"mu": torch.zeros_like(state["mu"])}},
                    num_heads=CKPT_VIT["num_heads"])
    except MeshMismatchError as e:
        out["chunks"] = str(e)
    got = mgr.restore(template, num_heads=CKPT_VIT["num_heads"])
    out["params"] = {".".join(k): _np(gather_leaf(v, (), dp8))
                     for k, v in tree_leaves(got["params"])}
    return out


def _vit_3d_fit(directory, xtr, ytr, xte, yte):
    """The tiny ViT trained one epoch on the 2 x 2 x 2 mesh (1F1B over 2
    micro-batches, Adam) with a checkpoint directory; its reported val
    accuracy."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.data.datasets import ArrayDataset, make_batches
    from quintnet_tpu_torch.train.trainer import Trainer

    config = Config.from_dict({
        "mesh_dim": [2, 2, 2], "mesh_name": ["dp", "tp", "pp"],
        "training": {"batch_size": 32, "gradient_accumulation_steps": 2,
                     "schedule": "1f1b", "optimizer": "adam",
                     "learning_rate": 1e-3, "grad_clip_norm": None,
                     "epochs": 1, "log_every": 0}})
    tr = Trainer(config, pp_model("vit", CKPT_VIT), task_type="classification",
                 checkpoint_dir=directory, device="cpu",
                 log_fn=lambda m: None)
    train, test = ArrayDataset(xtr, ytr), ArrayDataset(xte, yte)
    hist = tr.fit(lambda ep, start=0: make_batches(train, 32, seed=ep,
                                                   start_batch=start),
                  val_batches_fn=lambda ep: make_batches(test, 32,
                                                         shuffle=False))
    return hist.val_metric[-1]


def _gpt2_trainer(directory, mesh_sizes, training):
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.train.trainer import Trainer

    config = Config.from_dict({
        "mesh_dim": list(mesh_sizes.values()),
        "mesh_name": list(mesh_sizes),
        "training": {"learning_rate": 1e-3, "weight_decay": 0.01,
                     "grad_clip_norm": 1.0, "log_every": 0, "seed": 0,
                     **training}})
    return Trainer(config, pp_model("gpt2", GPT2_3D), task_type="clm",
                   checkpoint_dir=directory, device="cpu",
                   log_fn=lambda m: None)


def _gathered(trainer, tree):
    from quintnet_tpu_torch.parallel.tp import gather_leaf

    specs = dict(tree_leaves(trainer.strategy.param_specs(trainer.model)))
    # a copy: a replicated leaf's "gather" is the live parameter itself
    return {".".join(k): _np(gather_leaf(v.detach(), specs[k],
                                         trainer.strategy.mesh)).copy()
            for k, v in tree_leaves(tree)}


def _cut_resume(directory, mesh_sizes, training, batches):
    """A run of ``len(batches)`` one-batch epochs uncut (saving every
    epoch), then its directory cut after step 1 and a fresh Trainer
    resuming from it: this rank's uncut and resumed final parameters
    (gathered whole) and moments (this rank's own: a ZeRO chunk or the
    sharded leaves), both Histories, and the uncut parameters after step
    1 gathered whole."""
    import shutil

    import torch.distributed as dist

    uncut = _gpt2_trainer(directory, mesh_sizes, training)
    first = []
    step_fn = uncut.step_fn

    def step(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        if not first:
            first.append(_gathered(uncut, out[0]))
        return out

    uncut.step_fn = step
    h_uncut = uncut.fit(lambda ep: [batches[ep]], epochs=len(batches))
    p_u, s_u = uncut.final_state
    if dist.get_rank() == 0:
        for name in os.listdir(directory):
            if name.isdigit() and int(name) > 1:
                shutil.rmtree(os.path.join(directory, name))
    dist.barrier()
    resumed = _gpt2_trainer(directory, mesh_sizes, training)
    h_res = resumed.fit(lambda ep: [batches[ep]], epochs=len(batches))
    p_r, s_r = resumed.final_state
    return {"uncut": (_gathered(uncut, p_u), _leaves_np(s_u["mu"]),
                      _leaves_np(s_u["nu"]), h_uncut.train_loss),
            "resumed": (_gathered(resumed, p_r), _leaves_np(s_r["mu"]),
                        _leaves_np(s_r["nu"]), h_res.train_loss),
            "after1": first[0], "steps": sorted(
                int(n) for n in os.listdir(directory) if n.isdigit())}


def _truncated_rank_file(directory):
    """The newest step of a 3D ZeRO-1 run's directory with rank 3's shard
    file cut in half: whether this rank's own read of it fails, and the
    step every rank's ``Trainer.resume_state`` falls back to."""
    import torch.distributed as dist

    from quintnet_tpu_torch.train.checkpoint import shard_file

    tr = _gpt2_trainer(directory, {"dp": 2, "tp": 2, "pp": 2},
                       GPT2_3D_CUT)
    mgr = tr._manager()
    newest = mgr.latest_step()
    if dist.get_rank() == 0:
        path = os.path.join(directory, str(newest), shard_file(3))
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    dist.barrier()
    params, opt_state = tr.init_state()
    try:
        mgr.restore({"params": params, "opt": opt_state, "epoch": 0},
                    step=newest, specs=tr._state_specs(opt_state))
        own_read_failed = False
    except Exception:  # noqa: BLE001 — any failure of this rank's read
        own_read_failed = True
    _, _, cursor = tr.resume_state()
    return {"newest": newest, "own_read_failed": own_read_failed,
            "resumed_at": cursor.global_step,
            "bad_steps": sorted(tr._bad_ckpt_steps)}


def _failed_save(directory, vit_np):
    """A save in which rank 5 fails to write its part, and two in which
    rank 0 fails to make the step's directory or to rename it: every rank
    raises and no step is listed; then a save killed before its rename (a
    hidden directory left behind) is not listed and the next manager
    clears it."""
    import torch.distributed as dist

    from quintnet_tpu_torch.train import checkpoint
    from quintnet_tpu_torch.utils import safetensors_io as st

    strat, _, params, state, specs = _vit_3d_state(vit_np, "adam")
    mgr = checkpoint.CheckpointManager(directory, mesh=strat.mesh)
    save_file = st.save_file

    def failing(*args, **kwargs):
        raise OSError("disk full (injected)")

    if dist.get_rank() == 5:
        st.save_file = failing
    try:
        mgr.save(9, {"params": params, "opt": state}, specs=specs)
        raised = None
    except (OSError, RuntimeError) as e:
        raised = f"{type(e).__name__}: {e}"
    finally:
        st.save_file = save_file
    listed = mgr.all_steps()
    left = sorted(os.listdir(directory))
    dist.barrier()
    rank0 = {}
    for name in ("_tmp_dir", "_commit"):    # rank 0 fails before / after
        if dist.get_rank() == 0:            # the others write their parts
            setattr(mgr, name, failing)
        try:
            mgr.save(11, {"params": params, "opt": state}, specs=specs)
            rank0[name] = [None]
        except (OSError, RuntimeError) as e:
            rank0[name] = [f"{type(e).__name__}: {e}"]
        finally:
            mgr.__dict__.pop(name, None)
        rank0[name] += [mgr.all_steps(), sorted(os.listdir(directory))]
        dist.barrier()
    killed = os.path.join(directory, ".tmp-10-killed")
    if dist.get_rank() == 0:
        os.makedirs(killed)
        with open(os.path.join(killed, checkpoint.shard_file(0)), "wb") as f:
            f.write(b"\0" * 16)
    dist.barrier()
    listed_killed = mgr.all_steps()
    checkpoint.CheckpointManager(directory, mesh=strat.mesh)
    return {"raised": raised, "listed": listed, "left": left,
            "rank0": rank0, "listed_killed": listed_killed,
            "after_clean": sorted(os.listdir(directory))}


GPT2_3D_CUT = dict(GPT2_3D_TRAINING, batch_size=8,
                   optimizer="zero1_adamw")
FSDP_CUT = {"batch_size": 8, "optimizer": "adamw", "fsdp": True}


def ckpt_world_case(rank, world, vit_np, data, gpt2_batches, dirs):
    """tests/test_torch_checkpoint_mesh.py's world of 8 ranks: the 3D
    round trips (Adam, ZeRO-1), a restore onto a dp = 8 mesh, the 3D ViT
    fit whose checkpoint ``verify_vit`` reloads, the cut-and-resume of a
    3D ZeRO-1 GPT-2 run and of an fsdp dp x tp = 4 x 2 run, a truncated
    rank file, and a failed save."""
    out = {"round_trip": {opt: _round_trip(vit_np, opt, dirs[opt])
                          for opt in ("adam", "zero1_adam")},
           "elsewhere": _restore_elsewhere(vit_np, dirs["elsewhere"]),
           "val_accuracy": _vit_3d_fit(dirs["vit"], *data),
           "3d": _cut_resume(dirs["3d"], {"dp": 2, "tp": 2, "pp": 2},
                             GPT2_3D_CUT, gpt2_batches),
           "fsdp": _cut_resume(dirs["fsdp"], {"dp": 4, "tp": 2}, FSDP_CUT,
                               gpt2_batches)}
    out["truncated"] = _truncated_rank_file(dirs["3d"])
    out["failed_save"] = _failed_save(dirs["failed"], vit_np)
    return out


# ---------------------------------------------------------------------
# Llama and MoE (tests/test_torch_llama.py, tests/test_torch_moe.py and
# the Llama and MoE cases of tests/test_torch_fsdp.py)
# ---------------------------------------------------------------------

def family_model(family, kw, *, use_flash=False, remat=False,
                 sp_mode="ring"):
    """The tiny training model of a family: ``GPT2Config.tiny(**kw)``,
    ``ViTConfig(**kw)`` or ``LlamaConfig.tiny(**kw)`` (``sp_mode``: the
    sequence-parallel attention of GPT-2 and Llama on an sp mesh)."""
    if family == "gpt2":
        from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec

        return gpt2_model_spec(GPT2Config.tiny(**kw), use_flash=use_flash,
                               remat=remat, sp_mode=sp_mode)
    if family == "vit":
        from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec

        return vit_model_spec(ViTConfig(**kw), remat=remat)
    from quintnet_tpu_torch.models.llama import LlamaConfig, llama_model_spec

    return llama_model_spec(LlamaConfig.tiny(**kw), use_flash=use_flash,
                            remat=remat, sp_mode=sp_mode)


def family_params(family, np_params):
    """JAX params (numpy) of a family -> the port's tensors on the CPU."""
    from quintnet_tpu_torch import bridge

    fn = {"gpt2": bridge.gpt2_params_from_numpy,
          "vit": bridge.vit_params_from_numpy,
          "llama": bridge.llama_params_from_numpy}[family]
    return fn(np_params, "cpu")


def strategy_steps(family, kw, np_params, x, y, sizes=None, *,
                   training=None, steps=1, use_flash=False, more=0,
                   sp_mode="ring"):
    """``steps`` optimizer steps of the tiny model through
    ``get_strategy`` on the mesh ``sizes`` (one device without), by
    default SGD at lr 0.05 with no clipping (the JAX goldens'
    ``optax.sgd(0.05)``): the step losses, ``more`` further step losses,
    and every parameter gathered whole (in the layout the run holds: the
    tp-blocked fused QKV of GPT-2 and ViT). On an sp mesh the batch's
    sequence is cut by the model's ``batch_specs`` and attention runs by
    ``sp_mode``."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.parallel.tp import gather_leaf
    from quintnet_tpu_torch.train.trainer import make_optimizer

    d = {"training": {"optimizer": "sgd", "learning_rate": 0.05,
                      "grad_clip_norm": None, **(training or {})}}
    if sizes:
        d.update(mesh_dim=list(sizes.values()), mesh_name=list(sizes))
    config = Config.from_dict(d)
    model = family_model(family, kw, use_flash=use_flash, sp_mode=sp_mode)
    strat = get_strategy(None, config)
    opt = make_optimizer(config)
    params = tree_map(lambda t: t.requires_grad_(True), strat.shard_params(
        model, family_params(family, np_params)))
    state = strat.init_opt_state(model, opt, params)
    batch = strat.shard_batch((torch.tensor(x), torch.tensor(y)), model)
    step = strat.make_train_step(model, opt)
    losses = []
    for _ in range(steps + more):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    specs = dict(tree_leaves(strat.param_specs(model)))
    return {"strategy": strat.name, "losses": losses[:steps],
            "more": losses[steps:], "coords": strat.mesh.coords,
            "fsdp_axis": strat.fsdp_axis,
            "specs": {".".join(k): v for k, v in specs.items()},
            "params": {".".join(k): _np(gather_leaf(v.detach(), specs[k],
                                                    strat.mesh))
                       for k, v in tree_leaves(params)}}


def moe_layer_case(sizes, np_params, x, args_kw, *, tp=False,
                   replicated_x=False, expert_type="mlp"):
    """``nn/moe.moe_apply`` on this rank of the mesh ``sizes`` (ep, and
    tp with ``tp``): the experts this rank's shard, ``x`` [B, T, D] cut to
    its ep rows (whole with ``replicated_x``). Returns (this rank's
    output rows, its ep coordinate)."""
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes
    from quintnet_tpu_torch.nn.moe import MoEArgs, moe_apply, moe_specs
    from quintnet_tpu_torch.parallel.tp import shard_leaf

    mesh = mesh_from_sizes(**sizes)
    specs = moe_specs(ep_axis="ep", tp_axis="tp" if tp else None,
                      expert_type=expert_type)
    p = tree_map(lambda a, s: shard_leaf(torch.tensor(a), s, mesh),
                 np_params, specs)
    ep = mesh.axis("ep")
    xt = torch.tensor(x)
    if not replicated_x:
        k = xt.shape[0] // ep.size
        xt = xt[ep.index * k:(ep.index + 1) * k]
    y, _ = moe_apply(p, xt, MoEArgs(**args_kw), ep_axis=ep,
                     tp_axis=mesh.axis("tp") if tp else None)
    return _np(y), ep.index


def moe_trainer_case(rank, world, kw, ids, sizes):
    """``Trainer.fit`` (one epoch of one batch, AdamW lr 1e-3) and its
    evaluation of a MoE GPT-2 on the mesh ``sizes``."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    config = Config.from_dict({
        "mesh_dim": list(sizes.values()), "mesh_name": list(sizes),
        "training": {"batch_size": len(ids), "optimizer": "adamw",
                     "learning_rate": 1e-3, "epochs": 1, "log_every": 0}})
    tr = Trainer(config, gpt2_model_spec(GPT2Config.tiny(**kw)),
                 task_type="clm", device="cpu", log_fn=lambda m: None)
    t = torch.tensor(ids)
    hist = tr.fit(lambda ep: [(t, t)], epochs=1,
                  val_batches_fn=lambda ep: [(t, t)])
    return {"strategy": tr.strategy.name, "train_loss": hist.train_loss,
            "val_loss": hist.val_loss}


def jobs_world_case(rank, world, jobs):
    """Every job of ``jobs`` (tag -> (kind, args, kwargs)) in this world,
    one after the other; kinds: ``"steps"`` (:func:`strategy_steps`),
    ``"layer"`` (:func:`moe_layer_case`), ``"trainer"``
    (:func:`moe_trainer_case`)."""
    run = {"steps": strategy_steps, "layer": moe_layer_case,
           "trainer": lambda *a, **k: moe_trainer_case(rank, world, *a,
                                                       **k)}
    return {tag: run[kind](*args, **kwargs)
            for tag, (kind, args, kwargs) in jobs.items()}

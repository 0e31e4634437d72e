"""Rank bodies of the port's distributed tests (run by ``_torch_dist``).

Each function runs in one process of a gloo world on the CPU, takes
numpy inputs made by the test in the parent (where the JAX goldens are
computed) and returns numpy results, which the parent compares rank by
rank. Nothing here imports jax: the children import this module by
name.
"""

from __future__ import annotations

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
                        labels, accum, cfg_kw):
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
                     "gradient_accumulation_steps": accum}})
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

    return {"strategy": strat.name, "loss": float(loss),
            "params": gathered(params), "mu": gathered(state["mu"]),
            "coords": strat.mesh.coords}


def gpt2_mesh_case(rank, world, np_params, ids, labels, runs):
    """Every (mesh_dim, mesh_name, accum) run of ``runs`` in this world,
    one after the other."""
    return [_gpt2_strategy_step(rank, world, md, mn, np_params, ids, labels,
                                acc, {"n_layer": 2})
            for md, mn, acc in runs]


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

def trainer_case(rank, world, np_params, batches, val):
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    config = Config.from_dict({
        "mesh_dim": [world], "mesh_name": ["dp"],
        "training": {"optimizer": "sgd", "learning_rate": 0.1,
                     "grad_clip_norm": 1.0, "log_every": 1, "seed": 0}})
    logs = []
    tr = Trainer(config, gpt2_model_spec(GPT2Config.tiny(n_layer=2)),
                 task_type="clm", device="cpu", log_fn=logs.append)
    params = tree_map(lambda t: t.requires_grad_(True),
                      gpt2_params_from_numpy(np_params, "cpu"))
    hist = tr.fit(lambda ep: [batches[ep]], epochs=len(batches),
                  params=params, opt_state=tr.optimizer.init(params),
                  val_batches_fn=lambda ep: [val])
    p, s = tr.final_state
    return {"train_loss": hist.train_loss, "val_loss": hist.val_loss,
            "params": _flat(p), "logs": len(logs),
            "strategy": tr.strategy.name}


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

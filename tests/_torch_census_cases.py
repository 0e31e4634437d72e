"""Rank bodies of the collective-census tests (run by ``_torch_dist``).

Each job runs one program of the port on this rank of a gloo world with
the collective counter on (``analysis/step_audit.collective_census``)
and returns the census, the structural counts the expected-census
formulas take (parameter leaves, per-axis replicated and sharded
leaves), and the step's loss with the counter on and off. The parent
holds each census to JAX's ``quintnet_tpu.analysis.specs.expected_*``
and to the port's own. Nothing here imports jax: the children import
this module by name.
"""

from __future__ import annotations

import numpy as np
import torch

from quintnet_tpu_torch.core.pytree import tree_map

from _torch_dist_cases import family_model, family_params


def _train_setup(family, kw, np_params, x, y, sizes, training):
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.train.trainer import make_optimizer

    config = Config.from_dict({
        "mesh_dim": list(sizes.values()), "mesh_name": list(sizes),
        "training": {"batch_size": len(x), **training}})
    model = family_model(family, kw)
    strat = get_strategy(None, config)
    opt = make_optimizer(config)
    params = tree_map(lambda t: t.requires_grad_(True), strat.shard_params(
        model, family_params(family, np_params)))
    state = strat.init_opt_state(model, opt, params)
    batch = strat.shard_batch((torch.tensor(x), torch.tensor(y)), model)
    return strat, model, strat.make_train_step(model, opt), params, state, \
        batch


def train_census(family, kw, np_params, x, y, training, *, sizes):
    """One train step of the strategy ``sizes``/``training`` picks, with
    the counter on; then the same step on fresh state with it off."""
    from quintnet_tpu_torch.analysis.specs import spec_leaf_counts
    from quintnet_tpu_torch.analysis.step_audit import collective_census

    strat, model, step, params, state, batch = _train_setup(
        family, kw, np_params, x, y, sizes, training)
    census = collective_census(step, params, state, batch)
    loss_on = census.result[2].detach().numpy()
    *_, step2, params2, state2, batch2 = _train_setup(
        family, kw, np_params, x, y, sizes, training)
    loss_off = step2(params2, state2, batch2)[2].detach().numpy()
    specs = strat.param_specs(model)
    return {"strategy": strat.name, "census": census.as_dict(),
            "dynamic": census.dynamic,
            "leaves": {a: spec_leaf_counts(specs, a) for a in sizes},
            "loss_on": loss_on, "loss_off": loss_off}


def serve_census(family, cfg_kw, np_tree, engine_kw, tp):
    """Every prefill bucket, the decode step and every verify bucket of
    an engine on this rank's mesh, each under its own census (the
    warm-up's calls: all-zero tables, every write in the null block)."""
    from quintnet_tpu_torch.analysis.step_audit import (collective_census,
                                                        donation_report)
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    from _torch_serve_cases import _cfg, _params

    cfg = _cfg(family, cfg_kw)
    eng = ServeEngine(gpt2_family(cfg), _params(family, np_tree, cfg, tp),
                      device="cpu", **engine_kw)
    zrow = np.zeros((eng.table_width,), np.int32)
    S = len(eng._tok)
    zeros = [0] * S
    out = {"axes": (eng.tp_axis, eng.sp_axis, eng.ep_axis)}
    for b in eng.prefill_buckets:
        out[f"prefill[{b}]"] = collective_census(
            eng._prefill, np.zeros((1, b), np.int32), 0, 1, zrow, 0,
            0).as_dict()
    out["decode"] = collective_census(
        eng._decode, np.zeros_like(eng._tok), np.zeros_like(eng._pos),
        np.zeros_like(eng._tables), zeros, zeros).as_dict()
    # the decode program's in-place state on this rank's pool shard
    k, v, *scales = eng.pool.caches()
    i32 = dict(dtype=torch.int32)
    rep = donation_report(
        eng._decodes[None], k, v, torch.zeros((S,), **i32),
        torch.zeros((S,), **i32), torch.zeros(eng._tables.shape, **i32),
        eng.pool.block_size, **eng._kv_kw(scales))
    by = rep.by_path()
    out["decode_in_place"] = {
        "pool": by["args[0]"].donated and by["args[1]"].donated,
        "undonated_aliasable": [a.path for a in rep.undonated_aliasable]}
    for k in (eng.spec.buckets if eng.spec is not None else ()):
        out[f"verify[{k}]"] = collective_census(
            eng._verify, np.zeros((S, k + 1), np.int32),
            np.zeros((S,), np.int32), np.ones((S,), np.int32),
            np.zeros_like(eng._tables), zeros, zeros).as_dict()
    return out


def tp_layer_census(mesh):
    """JAX's tp layer goldens on this rank's shards: a column -> row
    forward, its gradient, and the gathered column's gradient."""
    from quintnet_tpu_torch.analysis.step_audit import collective_census
    from quintnet_tpu_torch.parallel import tp

    ax = mesh.axis("tp")
    g = torch.Generator().manual_seed(ax.index)
    pc = {"w": torch.randn((8, 16 // ax.size), generator=g),
          "b": torch.zeros((16 // ax.size,))}
    pr = {"w": torch.randn((16 // ax.size, 8), generator=g),
          "b": torch.zeros((8,))}
    x = torch.randn((4, 8), generator=g)

    def fwd():
        h = tp.column_parallel_linear(pc, x, axis=ax)
        return tp.row_parallel_linear(pr, h, axis=ax).sum()

    def grad():
        leaves = [t.requires_grad_(True) for t in (*pc.values(),
                                                   *pr.values())]
        torch.autograd.grad(fwd(), leaves)

    def gathered_grad():
        leaves = [t.requires_grad_(True) for t in pc.values()]
        y = tp.column_parallel_linear(pc, x, axis=ax, gather_output=True)
        torch.autograd.grad(y.sum(), leaves)

    with torch.no_grad():
        out = {"forward": collective_census(fwd).as_dict()}
    out["grad"] = collective_census(grad).as_dict()
    out["gathered_grad"] = collective_census(gathered_grad).as_dict()
    return out


def census_world_case(rank, world, jobs):
    """Every job of ``jobs`` (tag -> (kind, mesh sizes, args)) in this
    world, one after the other, each on a mesh built for it; kinds:
    ``"train"`` (:func:`train_census`: the strategy builds its own mesh
    of the world), ``"serve"`` (:func:`serve_census`) and ``"tp_layer"``
    (:func:`tp_layer_census`)."""
    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.core.mesh import MeshSpec, build_mesh

    out = {}
    for tag, (kind, sizes, args) in jobs.items():
        if kind == "train":
            out[tag] = train_census(*args, sizes=sizes)
        elif kind == "tp_layer":
            out[tag] = tp_layer_census(build_mesh(MeshSpec.create(**sizes)))
        else:
            family, cfg_kw, np_tree, engine_kw = args
            mesh = build_mesh(MeshSpec.create(**sizes))
            out[tag] = serve_census(
                family, cfg_kw, np_tree, dict(engine_kw, mesh=mesh),
                sizes.get(engine_kw.get("tp_axis", "tp"), 1))
        runtime.barrier()
    return out

"""Rank bodies of the port's vocab-parallel tests (``tests/test_torch_vp.py``),
run by ``_torch_dist.run_world``.

Each function runs in one process of a gloo world on the CPU, takes numpy
inputs made by the test in the parent (where the JAX goldens are computed)
and returns numpy results. Nothing here imports jax: the children import
this module by name.
"""

from __future__ import annotations

import torch

from _torch_dist_cases import _np, family_model, family_params, \
    strategy_steps


def _axes(sizes):
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes

    mesh = mesh_from_sizes(**sizes)
    return mesh, mesh.axis("tp"), (mesh.axis("sp") if "sp" in sizes
                                   else None)


def loss_case(world, sizes, logits, labels, vocab_size=None):
    """``clm_loss_vp`` on this rank's block of ``logits`` [B, T, V] (its
    tp columns, and with sp its slice of the sequence) and ``labels``:
    the loss and this rank's gradient of its block (JAX's transpose
    rule: tp x sp times the true gradient's block)."""
    from quintnet_tpu_torch.models.gpt2 import clm_loss_vp

    _, tp, sp = _axes(sizes)
    V, T = logits.shape[2], logits.shape[1]
    n = V // tp.size
    cols = slice(tp.index * n, (tp.index + 1) * n)
    rows = slice(None)
    if sp is not None:
        t = T // sp.size
        rows = slice(sp.index * t, (sp.index + 1) * t)
    x = torch.tensor(logits[:, rows, cols]).requires_grad_(True)
    loss = clm_loss_vp(x, torch.tensor(labels[:, rows]), tp_axis=tp,
                       sp_axis=sp, vocab_size=vocab_size)
    loss.backward()
    return {"loss": float(loss), "grad": _np(x.grad), "tp": tp.index,
            "sp": 0 if sp is None else sp.index}


def generate_case(world, family, kw, np_params, ids, max_new, sampled):
    """tp-sharded decoding (``gpt2_generate_tp`` / ``llama_generate_tp``)
    of the vocab-parallel model ``kw`` on tp = ``world`` from the whole
    (padded) parameters ``np_params``: greedy, and sampled at temperature
    0.8, top-k 5 from seed 11 with ``sampled``."""
    from quintnet_tpu_torch.core.pytree import tree_map
    from quintnet_tpu_torch.models import gpt2_generate, llama_generate
    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.llama import LlamaConfig
    from quintnet_tpu_torch.parallel.tp import shard_leaf

    mesh, _, _ = _axes({"tp": world})
    model = family_model(family, kw)
    params = model.to_tp_layout(family_params(family, np_params), world)
    specs = model.partition_specs(tp_axis="tp")
    params = tree_map(lambda x, s: shard_leaf(x, s, mesh), params, specs)
    if family == "gpt2":
        cfg, fn = GPT2Config.tiny(**kw), gpt2_generate.gpt2_generate_tp
    else:
        cfg, fn = LlamaConfig.tiny(**kw), llama_generate.llama_generate_tp
    out = {"greedy": fn(params, ids, cfg, mesh=mesh, max_new_tokens=max_new),
           "wte_rows": int(params["embedding"][
               "wte" if family == "gpt2" else "tok"].shape[0])}
    if sampled:
        out["sampled"] = fn(params, ids, cfg, mesh=mesh,
                            max_new_tokens=max_new, temperature=0.8,
                            top_k=5, seed=11)
    return out


def ckpt_case(world, sizes, np_params, ids, directory):
    """One AdamW step of the vocab-parallel tiny GPT-2 on ``sizes``, the
    parameters saved as a sharded checkpoint, then restored twice: onto
    the same mesh (each rank's own blocks, equal bit for bit) and with no
    mesh (``wte`` whole, equal to the gathered table bit for bit)."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.parallel.tp import gather_leaf
    from quintnet_tpu_torch.train.checkpoint import CheckpointManager
    from quintnet_tpu_torch.train.trainer import make_optimizer

    config = Config.from_dict({
        "mesh_dim": list(sizes.values()), "mesh_name": list(sizes),
        "training": {"optimizer": "adamw", "learning_rate": 1e-2,
                     "grad_clip_norm": 1.0}})
    model = family_model("gpt2", {"vocab_parallel": True})
    strat = get_strategy(None, config)
    opt = make_optimizer(config)
    params = tree_map(lambda t: t.requires_grad_(True), strat.shard_params(
        model, family_params("gpt2", np_params)))
    state = strat.init_opt_state(model, opt, params)
    batch = strat.shard_batch((torch.tensor(ids), torch.tensor(ids)), model)
    params, state, _ = strat.make_train_step(model, opt)(params, state, batch)
    specs = strat.param_specs(model)
    mgr = CheckpointManager(directory, mesh=strat.mesh)
    mgr.save(1, {"params": params}, specs={"params": specs})
    same = mgr.restore({"params": tree_map(torch.zeros_like, params)})
    own = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves(same["params"]), tree_leaves(params)))
    whole = CheckpointManager(directory).restore()["params"]
    wte = gather_leaf(params["embedding"]["wte"].detach(),
                      specs["embedding"]["wte"], strat.mesh)
    return {"same_mesh_equal": own,
            "local_wte_rows": int(params["embedding"]["wte"].shape[0]),
            "no_mesh_wte_equal": bool(torch.equal(
                whole["embedding"]["wte"], wte))}


def vp_world_case(rank, world, jobs):
    """Every job of ``jobs`` (tag -> (kind, args, kwargs)) in this world,
    one after the other. Kinds: ``"loss"``, ``"generate"``, ``"ckpt"``
    (the functions above) and ``"steps"``
    (``_torch_dist_cases.strategy_steps``)."""
    import torch.distributed as dist

    run = {"loss": loss_case, "generate": generate_case, "ckpt": ckpt_case}
    out = {}
    for tag, (kind, args, kwargs) in jobs.items():
        if kind == "steps":
            out[tag] = strategy_steps(*args, **kwargs)
        else:
            out[tag] = run[kind](world, *args, **kwargs)
    dist.barrier()
    return out

"""Rank bodies of the serving-mesh tests (run by ``_torch_dist``).

Every rank of one gloo world runs the same engine, with the same
requests, in the same order, on its own view of a mesh (the port's
counterpart of JAX's ``shard_map`` step); the test compares what each
rank returns with the JAX package's engines and the port's single-device
engine, computed in the parent. Nothing here imports jax: the children
import this module by name.
"""

from __future__ import annotations

import numpy as np
import torch


def _params(family: str, np_tree, cfg, tp: int):
    """The port's params from JAX's numpy tree, in the family's
    training layout for a tp of ``tp`` (GPT-2's fused QKV tp-blocked)."""
    from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                           llama_params_from_numpy)
    from quintnet_tpu_torch.models.gpt2 import gpt2_to_tp_layout

    if family == "llama":
        return llama_params_from_numpy(np_tree, "cpu")
    return gpt2_to_tp_layout(gpt2_params_from_numpy(np_tree, "cpu"), cfg,
                             tp)


def _cfg(family: str, cfg_kw):
    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.llama import LlamaConfig

    return (LlamaConfig if family == "llama" else GPT2Config).tiny(**cfg_kw)


def _registry(adapters):
    """The port's registry of a job's adapters: id -> (numpy LoRA tree,
    rank, alpha)."""
    from quintnet_tpu_torch.bridge import lora_params_from_numpy
    from quintnet_tpu_torch.models.lora import LoRAConfig
    from quintnet_tpu_torch.serve import AdapterRegistry

    reg = AdapterRegistry()
    for aid, (tree, rank, alpha) in adapters.items():
        reg.register(aid, tree=lora_params_from_numpy(tree, "cpu"),
                     cfg=LoRAConfig(rank=rank, alpha=alpha))
    return reg


def run_engine_job(job, trees, mesh=None):
    """One engine run of ``job`` (a dict: family, cfg_kw, params key,
    engine kw, the requests (prompt, max_new, seed[, adapter id]), and
    optionally adapters) on ``mesh`` (None: one device). Returns the
    streams and what the tests read of the engine."""
    from quintnet_tpu_torch.serve import (ServeEngine, gpt2_family,
                                          llama_family)

    cfg = _cfg(job["family"], job["cfg_kw"])
    tp = 1
    if mesh is not None and job.get("engine", {}).get("tp_axis", "tp") \
            in mesh.shape:
        tp = mesh.shape[job.get("engine", {}).get("tp_axis", "tp")]
    params = _params(job["family"], trees[job["params"]], cfg, tp)
    fam = (llama_family if job["family"] == "llama" else gpt2_family)(cfg)
    kw = dict(job.get("engine", {}))
    if job.get("adapters"):
        kw["adapters"] = _registry(job["adapters"])
    eng = ServeEngine(fam, params, device="cpu", mesh=mesh, **kw)
    outs = []
    for wave in job["waves"]:
        rids = [eng.submit(np.asarray(r[0], np.int32), r[1], seed=r[2],
                           adapter_id=r[3] if len(r) > 3 else None)
                for r in wave]
        steps = 0
        while eng.has_work:
            eng.step()
            steps += 1
            assert steps < 2000, "engine failed to drain"
        outs += [eng.result(r) for r in rids]
    summary = eng.metrics.summary()
    return {"streams": outs,
            "axes": (eng.tp_axis, eng.sp_axis, eng.ep_axis),
            "pool_shape": tuple(eng.pool.caches()[0].shape),
            "scale_shape": (tuple(eng.pool.caches()[2].shape)
                            if len(eng.pool.caches()) > 2 else None),
            "prefix_hit_tokens": eng.metrics.prefix_hit_tokens,
            "prefill_chunks": eng.metrics.prefill_chunks,
            "blocks_used": eng.pool.num_used,
            "weight_bytes": eng.weight_bytes,
            "moe": {k: v for k, v in summary.items()
                    if k.startswith("moe")}}


def _ring_job(job, mesh):
    """``ring_paged_prefill`` on this rank: the chunk's q/k/v [1, H, P,
    Dh] cut to this rank's slice, the pools and table as given; returns
    the local output and the pools after the write."""
    from quintnet_tpu_torch.nn.attention import ring_paged_prefill
    from quintnet_tpu_torch.serve.kv_quant import make_policy

    ax = mesh.axis("sp")
    t = {k: torch.tensor(np.asarray(v)) for k, v in job["arrays"].items()}
    pl = t["q"].shape[2] // ax.size
    cut = slice(ax.index * pl, (ax.index + 1) * pl)
    kc, vc = t["k_cache"].clone(), t["v_cache"].clone()
    scales = None
    if "k_scale" in t:
        scales = (t["k_scale"].clone(), t["v_scale"].clone())
    o, *pools = ring_paged_prefill(
        t["q"][:, :, cut], t["k"][:, :, cut], t["v"][:, :, cut],
        job["start"], job["t0"], kc, vc, sp_axis=ax,
        block_tables=t["table"], block_size=job["block_size"],
        kv_scales=scales, policy=make_policy(job["layout"]))
    return {"o": o.numpy(), "pools": [p.numpy() for p in pools]}


def serve_mesh_case(rank, world, trees, jobs):
    """Every job of ``jobs`` (name -> dict with "mesh": axis sizes) on
    this rank, each on a mesh built for it; returns name -> result."""
    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.core.mesh import MeshSpec, build_mesh

    out = {}
    for name, job in jobs.items():
        mesh = build_mesh(MeshSpec.create(**job["mesh"]))
        out[name] = (_ring_job(job, mesh) if job.get("kind") == "ring"
                     else run_engine_job(job, trees, mesh))
        runtime.barrier()
    return out

"""Rank bodies of the generation and LoRA tests (run by ``_torch_dist``).

Each function runs in one process of a gloo world on the CPU, takes
numpy inputs made by the test in the parent (where the JAX goldens and
the single-device port's results are computed) and returns numpy
results by rank. Nothing here imports jax: the children import this
module by name.
"""

from __future__ import annotations

import numpy as np
import torch

from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map


def _tree(np_tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), np_tree)


def _flat(tree):
    return {".".join(k): v.detach().cpu().numpy().copy()
            for k, v in tree_leaves(tree)}


def _shard(tree, specs, mesh):
    from quintnet_tpu_torch.parallel.tp import shard_leaf

    return tree_map(lambda t, s: shard_leaf(t, s, mesh), tree, specs)


class _Tokenizer:
    def decode(self, ids):
        return " ".join(f"w{i % 7}" for i in ids)


def gen_world_case(rank, world, gpt2_np, gpt2_kw, ids, llama_np, llama_kw,
                   llama_ids, prompts, sample):
    """tp = ``world`` decoding: GPT-2 and Llama, greedy (with EOS) and
    sampled, and the generation eval on the tp mesh."""
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config,
                                                gpt2_partition_specs,
                                                gpt2_to_tp_layout)
    from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate_tp
    from quintnet_tpu_torch.models.llama import (LlamaConfig,
                                                 llama_partition_specs)
    from quintnet_tpu_torch.models.llama_generate import llama_generate_tp
    from quintnet_tpu_torch.train.metrics import evaluate_generation

    mesh = mesh_from_sizes(tp=world)
    cfg = GPT2Config.tiny(**gpt2_kw)
    local = _shard(gpt2_to_tp_layout(_tree(gpt2_np), cfg, world),
                   gpt2_partition_specs(cfg, tp_axis="tp"), mesh)
    out = {"gpt2_greedy": gpt2_generate_tp(local, ids, cfg, mesh=mesh,
                                           max_new_tokens=8,
                                           eos_token_id=7),
           "gpt2_sampled": gpt2_generate_tp(local, ids, cfg, mesh=mesh,
                                            max_new_tokens=8, seed=9,
                                            **sample)}
    lcfg = LlamaConfig.tiny(**llama_kw)
    llocal = _shard(_tree(llama_np), llama_partition_specs(lcfg, tp_axis="tp"),
                    mesh)
    out["llama_greedy"] = llama_generate_tp(llocal, llama_ids, lcfg,
                                            mesh=mesh, max_new_tokens=8,
                                            eos_token_id=7)
    out["llama_sampled"] = llama_generate_tp(llocal, llama_ids, lcfg,
                                             mesh=mesh, max_new_tokens=8,
                                             seed=3, **sample)
    out["eval_tp"] = evaluate_generation(
        local, cfg, prompts, _Tokenizer(), max_new_tokens=6,
        eos_token_id=7, batch_size=2, mesh=mesh)
    try:
        evaluate_generation(local, cfg, prompts, _Tokenizer(), beams=2,
                            mesh=mesh)
        out["beams_refused"] = ""
    except ValueError as e:
        out["beams_refused"] = str(e)
    return out


def lora_world_case(rank, world, gpt2_np, gpt2_kw, lora_np, lora_kw, ids,
                    steps, lr):
    """dp x tp = 2 x 2: the shard-local LoRA merge's forward with
    ``lora_np["merge"]``, and ``make_lora_train_step`` for ``steps`` Adam
    steps from ``lora_np["train"]`` on the global batch (each dp rank its
    rows), the adapters gathered whole after."""
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config, clm_loss,
                                                gpt2_forward,
                                                gpt2_partition_specs,
                                                gpt2_to_tp_layout)
    from quintnet_tpu_torch.models.lora import (LoRAConfig,
                                                lora_merge_blocks,
                                                lora_partition_specs,
                                                make_lora_train_step)
    from quintnet_tpu_torch.parallel.tp import block_specs, gather_leaf
    from quintnet_tpu_torch.train.trainer import Optimizer

    mesh = mesh_from_sizes(dp=2, tp=2)
    tp = mesh.axis("tp")
    cfg = GPT2Config.tiny(**gpt2_kw)
    lcfg = LoRAConfig(**lora_kw)
    base_specs = gpt2_partition_specs(cfg, tp_axis="tp")
    lspecs = lora_partition_specs(block_specs(tp_axis="tp", stacked=True),
                                  lcfg)
    base = _shard(gpt2_to_tp_layout(_tree(gpt2_np), cfg, 2), base_specs,
                  mesh)
    t_ids = torch.tensor(ids).long()

    def merged_loss(base, lora, batch):
        merged = {**base,
                  "blocks": lora_merge_blocks(base["blocks"], lora, lcfg)}
        logits, _ = gpt2_forward(merged, batch[0], cfg, tp_axis=tp)
        return clm_loss(logits, batch[1])

    with torch.no_grad():
        lora = _shard(_tree(lora_np["merge"]), lspecs, mesh)
        merged = {**base,
                  "blocks": lora_merge_blocks(base["blocks"], lora, lcfg)}
        out = {"merged_logits": gpt2_forward(merged, t_ids, cfg,
                                             tp_axis=tp)[0].numpy()}
    lora = _shard(_tree(lora_np["train"]), lspecs, mesh)
    opt = Optimizer("adam", lr)
    state = opt.init(lora)
    step = make_lora_train_step(mesh, merged_loss, opt, lora_specs=lspecs)
    before = _flat(base)
    losses = []
    for _ in range(steps):
        lora, state, loss = step(base, lora, state, (t_ids, t_ids))
        losses.append(float(loss))
    out["losses"] = losses
    specs = dict(tree_leaves(lspecs))
    out["lora"] = {".".join(k): gather_leaf(v.detach(), specs[k],
                                            mesh).numpy().copy()
                   for k, v in tree_leaves(lora)}
    out["base_unchanged"] = all(np.array_equal(before[k], v)
                                for k, v in _flat(base).items())
    out["moments"] = sorted(".".join(k) for k, _ in
                            tree_leaves(state["mu"]))
    return out

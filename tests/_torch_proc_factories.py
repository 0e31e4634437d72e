"""Engine builders for the port's PROCESS-fleet tests
(``quintnet_tpu_torch/fleet/proc.py``).

Replica processes load this module by FILE PATH (the fleet's engine
spec: ``{"file": __file__, "func": "build_tiny_gpt2", "kwargs":
{...}}``) and call the named builder with ``device=`` added by the
fleet. A spawned child cannot unpickle a test's closure and must build
its own engine anyway: that is what guarantees every replica holds the
same (family, params), the migration contract's precondition. The
builders are deterministic in their kwargs: the weights come from
``weights_path`` (a safetensors file of the JAX package's weights,
written by the test with the port's writer, so the child serves the
bridged tree the test's JAX oracle serves) or else from
``gpt2_init(torch.Generator().manual_seed(seed))``, which the parent
repeats for its own oracle.
"""

import torch


def tiny_params(cfg, *, seed=0, weights_path=None):
    """The builder's weights, on the CPU (the engine moves them): the
    safetensors file's tree (keys are the tree's paths joined by '.') or
    the seeded port init."""
    from quintnet_tpu_torch.models.gpt2 import gpt2_init
    from quintnet_tpu_torch.utils.safetensors_io import load_file

    if weights_path is None:
        return gpt2_init(torch.Generator().manual_seed(seed), cfg)
    params = {}
    for key, t in load_file(weights_path).items():
        node = params
        *path, leaf = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return params


def build_tiny_gpt2(*, device="cpu", seed: int = 0, weights_path=None,
                    n_layer: int = 2, max_slots: int = 2,
                    block_size: int = 4, num_blocks: int = 24,
                    max_seq_len: int = 24, temperature: float = 0.0,
                    top_k: int = 0, eos_token_id=None, prefill_len=None,
                    chunked_prefill: bool = False,
                    prefill_chunk_budget=None, kv_dtype=None,
                    weights_dtype=None, prefix_cache: bool = True,
                    kv_tier_bytes: int = 0):
    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    # one intra-op thread a child, as in the test process: CPU sums
    # group by thread count, and the tests hold children bit-equal to
    # engines the parent runs
    torch.set_num_threads(1)
    cfg = GPT2Config.tiny(n_layer=n_layer)
    params = tiny_params(cfg, seed=seed, weights_path=weights_path)
    return ServeEngine(gpt2_family(cfg), params, device=device,
                       max_slots=max_slots, block_size=block_size,
                       num_blocks=num_blocks, max_seq_len=max_seq_len,
                       prefill_len=prefill_len,
                       chunked_prefill=chunked_prefill,
                       prefill_chunk_budget=prefill_chunk_budget,
                       kv_dtype=kv_dtype, weights_dtype=weights_dtype,
                       prefix_cache=prefix_cache, temperature=temperature,
                       top_k=top_k, eos_token_id=eos_token_id,
                       kv_tier_bytes=kv_tier_bytes)


def write_weights(tree, path):
    """Write a nested-dict weight tree (numpy arrays or tensors, e.g. the
    JAX package's params through ``np.asarray``) as the safetensors file
    ``build_tiny_gpt2(weights_path=)`` reads."""
    import numpy as np

    from quintnet_tpu_torch.utils.safetensors_io import save_file

    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            flat[".".join(prefix)] = np.asarray(node)

    walk(tree, ())
    save_file(flat, path)
    return path

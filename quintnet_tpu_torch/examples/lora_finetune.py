"""LoRA finetuning walkthrough: train rank-r adapters over a frozen GPT-2,
then save, reload, merge and generate.

Port of ``quintnet_tpu/examples/lora_finetune.py``: Adam state exists
only for the adapters (under 1% of the model at r = 8), the base stays
frozen, and the merged model is a plain GPT-2 again. Attention runs
through ``ops.flash_attention`` (the K1-K3 kernels on the card, the
plain versions on the CPU)::

    python -m quintnet_tpu_torch.examples.lora_finetune --steps 30  # card
    python -m quintnet_tpu_torch.examples.lora_finetune --device cpu \\
        --steps 10 --rank 16 --targets qkv
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--targets", nargs="+", default=["qkv", "proj", "fc"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from quintnet_tpu_torch.core.device import resolve_device
    from quintnet_tpu_torch.core.pytree import tree_leaves
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config, clm_loss,
                                                gpt2_forward, gpt2_init)
    from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
    from quintnet_tpu_torch.models.lora import (LoRAConfig, load_lora,
                                                lora_init, lora_merge_tree,
                                                lora_param_count, lora_wrap,
                                                make_lora_train_step,
                                                save_lora)
    from quintnet_tpu_torch.train.trainer import Optimizer

    dev = resolve_device(args.device)
    cfg = GPT2Config.tiny(n_positions=max(64, args.seq))
    params = gpt2_init(torch.Generator(device=dev).manual_seed(0), cfg)
    lcfg = LoRAConfig(rank=args.rank, alpha=args.alpha,
                      targets=tuple(args.targets))
    lora = lora_init(torch.Generator(device=dev).manual_seed(1),
                     params["blocks"], lcfg)

    n_base = sum(p.numel() for _, p in tree_leaves(params))
    n_lora = lora_param_count(lora)
    print(f"base {n_base / 1e6:.2f}M params frozen; training "
          f"{n_lora / 1e3:.1f}k adapter params ({100 * n_lora / n_base:.2f}%)"
          f" at rank {args.rank}")

    fwd = lora_wrap(lambda p, ids: gpt2_forward(p, ids, cfg,
                                                use_flash=True)[0],
                    params, lcfg)
    opt = Optimizer("adam", args.lr)
    opt_state = opt.init(lora)
    step = make_lora_train_step(
        None, lambda base, lo, b: clm_loss(fwd(lo, b[0]), b[1]), opt)

    # toy objective: reproduce a fixed synthetic batch
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.seq))).to(dev)
    t0 = time.perf_counter()
    for i in range(args.steps):
        lora, opt_state, loss = step(params, lora, opt_state, (ids, ids))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f}")
    print(f"{args.steps} adapter steps in {time.perf_counter() - t0:.1f}s")

    # the safetensors file a serving registry would load, read back
    # before the merged model generates
    path = os.path.join(tempfile.mkdtemp(prefix="lora_"),
                        "adapters.safetensors")
    save_lora(lora, lcfg, path)
    lora, lcfg = load_lora(path, device=dev)
    print(f"saved + reloaded adapters via {path} "
          f"({os.path.getsize(path)} bytes)")

    merged = lora_merge_tree(params, lora, lcfg)
    out = gpt2_generate(merged, ids[:1, :8].cpu().numpy(), cfg,
                        max_new_tokens=8)
    print(f"merged model generated {out.shape[1] - 8} tokens ok")
    return out


if __name__ == "__main__":
    main()

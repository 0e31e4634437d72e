"""Single-device reload verifier for ViT training, one device or a mesh.

Port of ``quintnet_tpu/tools/verify_vit.py``: reload the newest
checkpoint with no trainer and no mesh, evaluate ``vit_apply`` over the
test split and compare its accuracy with the one the training run
reported::

    python -m quintnet_tpu_torch.tools.verify_vit --checkpoint-dir ckpt \\
        [--expected-accuracy 0.93] [--data-dir data] [--device cpu]

A checkpoint of a sharded run (``train/checkpoint.py``) comes back as
whole host arrays in the layout the run held them; a tensor-parallel
run's fused QKV columns are in the tp-blocked order and are put back in
the standard [q|k|v] order (``parallel/tp.qkv_standard_from_blocked``).
The tp is the one the step records (its mesh), so unlike the JAX tool
this one takes no ``--tp``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np
import torch


def verify_vit(checkpoint_dir: str, cfg, *,
               data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
               data_dir: Optional[str] = None, batch_size: int = 256,
               device="cuda") -> dict:
    """Newest checkpoint -> ``{"epoch", "loss", "accuracy",
    "n_examples"}`` over ``data`` (default: ``load_mnist(data_dir,
    split="test")``) in batches of ``batch_size`` (a remainder is
    dropped, as the trainer's ``make_batches`` drops it). The fused QKV
    is put back in the standard layout from the tp the step records (1
    for a one-device step)."""
    from quintnet_tpu_torch.core.device import resolve_device
    from quintnet_tpu_torch.core.pytree import tree_map
    from quintnet_tpu_torch.models.vit import (accuracy, cross_entropy_loss,
                                               vit_apply)
    from quintnet_tpu_torch.parallel.tp import tree_qkv_layout
    from quintnet_tpu_torch.train.checkpoint import CheckpointManager

    dev = resolve_device(device)
    mgr = CheckpointManager(checkpoint_dir)
    record = mgr.sharding()
    saved_tp = (dict(zip(record["mesh"]["names"],
                         record["mesh"]["sizes"])).get("tp", 1)
                if record is not None else 1)
    state = mgr.restore()          # whole host arrays, no mesh involved
    params = tree_qkv_layout(state["params"], cfg.num_heads, saved_tp,
                             to_blocked=False)
    params = tree_map(lambda t: t.to(dev), params)
    if data is None:
        from quintnet_tpu_torch.data.datasets import load_mnist

        data = load_mnist(data_dir, split="test")
    x, y = data
    losses, accs, n = [], [], 0
    with torch.no_grad():
        for i in range(0, len(x) - (len(x) % batch_size) or len(x),
                       batch_size):
            xb = torch.as_tensor(np.asarray(x[i:i + batch_size]),
                                 dtype=torch.float32).to(dev)
            yb = torch.as_tensor(np.asarray(y[i:i + batch_size])).long().to(
                dev)
            logits = vit_apply(params, xb, cfg)
            losses.append(float(cross_entropy_loss(logits, yb)) * len(xb))
            accs.append(float(accuracy(logits, yb)) * len(xb))
            n += len(xb)
    return {"epoch": int(state.get("epoch", -1)),
            "loss": sum(losses) / max(n, 1),
            "accuracy": sum(accs) / max(n, 1), "n_examples": n}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--hidden-dim", type=int, default=64)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--num-heads", type=int, default=4)
    ap.add_argument("--patch-size", type=int, default=7)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--expected-accuracy", type=float, default=None,
                    help="val accuracy the training run reported; exit 1 if "
                         "the reloaded model misses it by more than 1%%")
    args = ap.parse_args(argv)

    from quintnet_tpu_torch.models.vit import ViTConfig

    cfg = ViTConfig(hidden_dim=args.hidden_dim, depth=args.depth,
                    num_heads=args.num_heads, patch_size=args.patch_size)
    res = verify_vit(args.checkpoint_dir, cfg, data_dir=args.data_dir, batch_size=args.batch_size,
                     device=args.device)
    print(f"reloaded epoch {res['epoch']}: loss {res['loss']:.4f} "
          f"accuracy {res['accuracy']:.4f} ({res['n_examples']} examples)")
    if args.expected_accuracy is not None:
        diff = abs(res["accuracy"] - args.expected_accuracy)
        ok = diff <= 0.01
        print(f"training-run accuracy {args.expected_accuracy:.4f} -> "
              f"|diff| {diff:.4f} {'PASS' if ok else 'FAIL'} (bar 1%)")
        raise SystemExit(0 if ok else 1)
    return res


if __name__ == "__main__":
    main()

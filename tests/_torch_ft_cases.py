"""Rank bodies of ``tests/test_torch_ft.py``'s 2-rank world (run by
``_torch_dist``): the tiny ViT on a dp x tp = 1 x 2 mesh, the 2-axis
case of the JAX package's ``tests/test_ft.py`` as one gloo world.

Nothing here imports jax: the children import this module by name.
"""

from __future__ import annotations

import os

import torch

from quintnet_tpu_torch.core.pytree import tree_leaves

SAMPLES, BATCH, EPOCHS = 48, 16, 2          # 3 steps an epoch, 6 in all
VIT = dict(image_size=28, patch_size=7, in_channels=1, hidden_dim=16,
           depth=2, num_heads=2, num_classes=10)


def _trainer(ckpt, **training):
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    t = {"batch_size": BATCH, "epochs": EPOCHS, "optimizer": "adam",
         "learning_rate": 1e-3, "log_every": 0, "seed": 0, **training}
    cfg = Config.from_dict({"mesh_dim": [1, 2], "mesh_name": ["dp", "tp"],
                            "training": t})
    return Trainer(cfg, vit_model_spec(ViTConfig(**VIT)), device="cpu",
                   checkpoint_dir=ckpt, log_fn=lambda m: None)


def _batches():
    from quintnet_tpu_torch.data.datasets import (ArrayDataset, make_batches,
                                                  synthetic_mnist)

    ds = ArrayDataset(*synthetic_mnist(SAMPLES, seed=0))
    return lambda ep, start=0: make_batches(ds, BATCH, seed=ep,
                                            start_batch=start)


def _equal(a, b) -> bool:
    """This rank's shards of two final states, bit for bit."""
    (pa, oa), (pb, ob) = a, b
    pairs = list(zip(tree_leaves(pa), tree_leaves(pb)))
    for key in ("mu", "nu"):
        pairs += zip(tree_leaves(oa[key]), tree_leaves(ob[key]))
    return (oa["count"] == ob["count"]
            and all(ka == kb and torch.equal(x, y)
                    for (ka, x), (kb, y) in pairs))


def ft_world_case(rank, world, root):
    """The uncut run; a run killed after step 6 (cadence every 2 steps)
    and resumed by fresh trainers; a preemption delivered as a real
    SIGTERM to rank 1 alone after step 4, then resumed. Returns this
    rank's view of each."""
    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.ft import (ChaosKilled, ChaosMonkey, FTContext,
                                       PreemptionHandler, TrainingPreempted)

    bf = _batches()
    ref = _trainer(None)
    hist_ref = ref.fit(bf)

    kill_dir = os.path.join(root, "kill")
    try:
        _trainer(kill_dir, save_every_steps=2).fit(
            bf, ft=FTContext(chaos=ChaosMonkey(kill_at_step=6,
                                               mode="raise")))
        raise AssertionError("the chaos kill did not fire")
    except ChaosKilled:
        pass
    resumed = _trainer(kill_dir, save_every_steps=2)
    hist = resumed.fit(bf)
    out = {"kill": {"losses": hist.train_loss,
                    "ref_losses": hist_ref.train_loss,
                    "equal": _equal(resumed.final_state, ref.final_state)}}

    pre_dir = os.path.join(root, "preempt")
    chaos = (ChaosMonkey(kill_at_step=4, mode="sigterm") if rank == 1
             else None)
    with PreemptionHandler() as handler:
        try:
            _trainer(pre_dir).fit(bf, ft=FTContext(preemption=handler,
                                                   chaos=chaos))
            raise AssertionError("the preemption did not stop the run")
        except TrainingPreempted as e:
            stopped = (e.epoch, e.step_in_epoch, e.global_step)
    runtime.barrier()           # rank 0 renamed the step into place
    steps = sorted(int(n) for n in os.listdir(pre_dir) if n.isdigit())
    again = _trainer(pre_dir)
    hist = again.fit(bf)
    out["preempt"] = {"signalled": handler.triggered, "stopped": stopped,
                      "steps_on_disk": steps, "losses": hist.train_loss,
                      "equal": _equal(again.final_state, ref.final_state)}
    return out

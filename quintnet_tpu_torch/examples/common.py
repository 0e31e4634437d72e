"""Shared example plumbing: arguments, config load, the ViT runner.

Port of ``quintnet_tpu/examples/common.py`` for one device. The JAX
examples take ``--simulate N`` (N virtual CPU devices); the port's take
``--device`` (``cuda`` by default, ``cpu`` when asked). A config is a
``.json`` file or, where PyYAML is installed, the reference's YAML.
"""

from __future__ import annotations

import argparse


def parse_args(default_config: str, argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=default_config)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--limit", type=int, default=None,
                    help="cap train/val samples per epoch (smoke runs)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--data-dir", default=None)
    return ap.parse_args(argv)


def _mnist(data_dir, split):
    """The MNIST split, or the synthetic stand-in when no MNIST files
    exist; returns ``(x, y, source)``."""
    from quintnet_tpu_torch.data import load_mnist

    try:
        return (*load_mnist(data_dir, split=split, synthetic_ok=False),
                "mnist")
    except FileNotFoundError:
        return (*load_mnist(data_dir, split=split), "synthetic_mnist")


def run_vit(args, strategy_name: str = "auto", *, one_device: bool = False):
    """Train the config's ViT with ``Trainer.fit`` and evaluate each epoch
    on the test split. ``one_device``: force the config's mesh to one
    device (``train_single_device``). Resumes from ``--checkpoint-dir``
    when it holds a checkpoint."""
    from quintnet_tpu_torch.core.config import MeshConfig, load_config
    from quintnet_tpu_torch.data import ArrayDataset, make_batches
    from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    if one_device:
        cfg.mesh, cfg.strategy_name = MeshConfig(), "single"
        strategy_name = "single"
    if args.epochs:
        cfg.training.epochs = args.epochs
    vcfg = ViTConfig.from_model_config(cfg.model)
    model = vit_model_spec(vcfg, remat=cfg.training.remat_mode)
    strategy = get_strategy(strategy_name, cfg)
    xtr, ytr, source = _mnist(args.data_dir, "train")
    xte, yte, _ = _mnist(args.data_dir, "test")
    if args.limit:
        xtr, ytr = xtr[:args.limit], ytr[:args.limit]
        xte, yte = xte[:args.limit], yte[:args.limit]
    train, test = ArrayDataset(xtr, ytr), ArrayDataset(xte, yte)
    bs = cfg.training.batch_size
    trainer = Trainer(cfg, model, strategy=strategy,
                      task_type="classification",
                      checkpoint_dir=args.checkpoint_dir, device=args.device)
    print(f"strategy={strategy.name} device={trainer.device} data={source} "
          f"({len(xtr)} train, {len(xte)} test)")
    hist = trainer.fit(
        lambda ep, start=0: make_batches(train, bs, seed=ep,
                                         start_batch=start),
        val_batches_fn=lambda ep: make_batches(test, bs, shuffle=False))
    msg = (f"done in {hist.wall_time_s:.1f}s; "
           f"final train_loss {hist.train_loss[-1]:.4f}")
    if hist.val_metric:
        msg += f"; final val_accuracy {hist.val_metric[-1]:.4f} ({source})"
    print(msg)
    return hist

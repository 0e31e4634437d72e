"""Shared example plumbing: arguments, launching the ranks, the ViT runner.

Port of ``quintnet_tpu/examples/common.py``. The JAX examples take
``--simulate N`` (N virtual CPU devices in one process); the port runs
one process per rank of the config's mesh, either under ``torchrun``
(one rank per process it starts) or spawned here
(``runtime.spawn_world``), joined by a ``FileStore`` in a temporary
directory. The dp and tp walkthroughs take ``--nproc N``: their one mesh
axis gets N ranks instead of the config's size. ``--device`` is
``cuda`` (rank r on ``cuda:r``, backend NCCL)
by default; ``cpu`` runs every rank on the CPU over gloo; a named card
(``cuda:0``) with ``--backend gloo`` lets the ranks share it. A config
is a ``.json`` file or, where PyYAML is installed, the reference's YAML.
"""

from __future__ import annotations

import argparse
import os


def parse_args(default_config: str, argv=None, axis=None):
    """The ViT examples' arguments; ``axis``: the example's one mesh
    axis, whose size ``--nproc`` sets (for ``dp`` also ``--fsdp``, which
    turns ``training.fsdp`` on)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=default_config)
    add_launch_args(ap)
    if axis:
        ap.add_argument("--nproc", type=int, default=None,
                        help=f"ranks to spawn here: the mesh becomes "
                             f"{axis} = N (default: the config's mesh)")
        ap.set_defaults(axis=axis)
    if axis == "dp":
        ap.add_argument("--fsdp", action="store_true",
                        help="ZeRO-3: shard the blocks, their gradients and "
                             "Adam's moments over dp (training.fsdp)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--limit", type=int, default=None,
                    help="cap train/val samples per epoch (smoke runs)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--data-dir", default=None)
    return ap.parse_args(argv)


def add_launch_args(ap):
    """``--device`` and ``--backend`` (see the module docstring)."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: rank r on cuda:r), cuda:N (every "
                         "rank on card N) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on CUDA, gloo on "
                         "the CPU)")
    return ap


def _rank_device(args):
    """What ``runtime.initialize`` gets: a named device as it is, or
    None for plain ``cuda`` (``cuda:LOCAL_RANK``)."""
    return None if args.device == "cuda" else args.device


def _rank_entry(rank, world, store, fn, args, extra):
    import torch

    from quintnet_tpu_torch.core import runtime

    os.environ["LOCAL_RANK"] = str(rank)
    if args.device == "cpu":     # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    runtime.initialize(backend=args.backend, init_method=f"file://{store}",
                       rank=rank, world_size=world,
                       device=_rank_device(args))
    try:
        fn(args, *extra)
    finally:
        runtime.shutdown()


def launch(fn, args, world: int, *extra):
    """``fn(args, *extra)`` on every rank of a ``world``-rank mesh.

    - one rank: called here, in this process, and its result returned;
    - under ``torchrun`` (``RANK`` set): this process is one rank, joined
      from torchrun's environment;
    - else ``world`` ranks spawned here (``runtime.spawn_world``); a rank
      that fails makes this call raise. Returns None.
    """
    from quintnet_tpu_torch.core import runtime

    if world == 1:
        return fn(args, *extra)
    if "RANK" in os.environ:
        runtime.initialize(backend=args.backend, device=_rank_device(args))
        try:
            return fn(args, *extra)
        finally:
            runtime.shutdown()
    runtime.spawn_world(_rank_entry, world, fn, args, extra)
    return None


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
    """Train the config's ViT on its mesh (:func:`launch`), evaluating
    each epoch on the test split. ``one_device``: force the config's mesh
    to one device (``train_single_device``). Saves to and resumes from
    ``--checkpoint-dir`` (on a mesh every rank writes its part of each
    step, ``train/checkpoint.py``)."""
    from quintnet_tpu_torch.core.config import MeshConfig, load_config

    cfg = load_config(args.config)
    if getattr(args, "fsdp", False):
        cfg.training.fsdp = True
    if getattr(args, "nproc", None):
        cfg.mesh = MeshConfig(mesh_dim=[args.nproc], mesh_name=[args.axis])
    if one_device:
        cfg.mesh, cfg.strategy_name = MeshConfig(), "single"
        strategy_name = "single"
    return launch(_train_vit, args, cfg.mesh.world_size, cfg, strategy_name)


def _train_vit(args, cfg, strategy_name):
    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.data import ArrayDataset, make_batches
    from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.train.trainer import Trainer

    say = print if runtime.is_main_process() else (lambda *a: None)
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
    device = runtime.device() if runtime.is_multiprocess() else args.device
    trainer = Trainer(cfg, model, strategy=strategy,
                      task_type="classification",
                      checkpoint_dir=args.checkpoint_dir, device=device)
    say(f"strategy={strategy.name} mesh={strategy.mesh.shape} "
        f"device={trainer.device} data={source} ({len(xtr)} train, "
        f"{len(xte)} test)" + (" fsdp over dp" if strategy.fsdp_axis
                               else ""))
    hist = trainer.fit(
        lambda ep, start=0: make_batches(train, bs, seed=ep,
                                         start_batch=start),
        val_batches_fn=lambda ep: make_batches(test, bs, shuffle=False))
    msg = (f"done in {hist.wall_time_s:.1f}s; "
           f"final train_loss {hist.train_loss[-1]:.4f}")
    if hist.val_metric:
        msg += f"; final val_accuracy {hist.val_metric[-1]:.4f} ({source})"
    say(msg)
    return hist

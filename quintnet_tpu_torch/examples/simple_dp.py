"""DP-only ViT-MNIST walkthrough: ``dp_config.json``'s mesh.

Port of ``quintnet_tpu/examples/simple_dp.py``, one process per rank::

    # spawn the config's ranks here (rank r on cuda:r, NCCL)
    python -m quintnet_tpu_torch.examples.simple_dp
    # every rank on the CPU, over gloo
    python -m quintnet_tpu_torch.examples.simple_dp --device cpu \\
        --epochs 1 --limit 256
    # dp = 2 ranks instead of the config's 4
    python -m quintnet_tpu_torch.examples.simple_dp --device cpu --nproc 2 \\
        --epochs 1 --limit 256
    # ZeRO-3: the blocks, their gradients and Adam's moments sharded over
    # dp (or training.fsdp: true in the config), with checkpoints
    python -m quintnet_tpu_torch.examples.simple_dp --device cpu --nproc 2 \\
        --fsdp --epochs 1 --limit 256 --checkpoint-dir /tmp/ck
    # one process a card under torchrun (not yet run on cards): the
    # config's 4 ranks, or --nproc N beside --nproc-per-node N
    torchrun --nproc-per-node 4 -m quintnet_tpu_torch.examples.simple_dp

Without MNIST files under ``--data-dir``, ``$QT_DATA_DIR`` or ``./data``
the run trains on the ``synthetic_mnist`` stand-in and says so.
"""

import os

from quintnet_tpu_torch.examples.common import parse_args, run_vit


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    args = parse_args(os.path.join(here, "dp_config.json"), argv,
                      axis="dp")
    return run_vit(args, "dp")


if __name__ == "__main__":
    main()

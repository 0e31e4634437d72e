"""Full 3D (dp x tp x pp = 2 x 2 x 2) ViT-MNIST training: ``config.json``'s
mesh, the 1F1B schedule over 2 micro-batches.

Port of ``quintnet_tpu/examples/full_3d.py``, one process per rank::

    # spawn the config's 8 ranks here (rank r on cuda:r, NCCL)
    python -m quintnet_tpu_torch.examples.full_3d
    # every rank on the CPU, over gloo
    python -m quintnet_tpu_torch.examples.full_3d --device cpu \\
        --epochs 1 --limit 256
    # the 8 ranks sharing one card, over gloo
    python -m quintnet_tpu_torch.examples.full_3d --device cuda:0 \\
        --backend gloo --epochs 1 --limit 256
    # one process a card under torchrun (not yet run on cards)
    torchrun --nproc-per-node 8 -m quintnet_tpu_torch.examples.full_3d

Without MNIST files under ``--data-dir``, ``$QT_DATA_DIR`` or ``./data``
the run trains on the ``synthetic_mnist`` stand-in and says so.
"""

import os

from quintnet_tpu_torch.examples.common import parse_args, run_vit


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    args = parse_args(os.path.join(here, "config.json"), argv)
    return run_vit(args, "3d")


if __name__ == "__main__":
    main()

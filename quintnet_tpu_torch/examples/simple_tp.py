"""TP-only ViT-MNIST walkthrough: ``tp_config.json``'s mesh.

Port of ``quintnet_tpu/examples/simple_tp.py``, one process per rank::

    # spawn the config's ranks here (rank r on cuda:r, NCCL)
    python -m quintnet_tpu_torch.examples.simple_tp
    # every rank on the CPU, over gloo
    python -m quintnet_tpu_torch.examples.simple_tp --device cpu \\
        --epochs 1 --limit 256
    # tp = 2 ranks instead of the config's 2
    python -m quintnet_tpu_torch.examples.simple_tp --device cpu --nproc 2 \\
        --epochs 1 --limit 256
    # one process a card under torchrun (not yet run on cards): the
    # config's 2 ranks, or --nproc N beside --nproc-per-node N
    torchrun --nproc-per-node 2 -m quintnet_tpu_torch.examples.simple_tp

Without MNIST files under ``--data-dir``, ``$QT_DATA_DIR`` or ``./data``
the run trains on the ``synthetic_mnist`` stand-in and says so.
"""

import os

from quintnet_tpu_torch.examples.common import parse_args, run_vit


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    args = parse_args(os.path.join(here, "tp_config.json"), argv,
                      axis="tp")
    return run_vit(args, "tp")


if __name__ == "__main__":
    main()

"""PP-only ViT-MNIST walkthrough: ``pp_config.json``'s mesh (4 stages,
the 1F1B schedule over 4 micro-batches).

Port of ``quintnet_tpu/examples/simple_pp.py``, one process per rank::

    # spawn the config's ranks here (rank r on cuda:r, NCCL)
    python -m quintnet_tpu_torch.examples.simple_pp
    # every rank on the CPU, over gloo
    python -m quintnet_tpu_torch.examples.simple_pp --device cpu \\
        --epochs 1 --limit 256
    # the 4 ranks sharing one card, over gloo
    python -m quintnet_tpu_torch.examples.simple_pp --device cuda:0 \\
        --backend gloo --epochs 1 --limit 256
    # pp = 2 ranks instead of the config's 4
    python -m quintnet_tpu_torch.examples.simple_pp --device cpu --nproc 2 \\
        --epochs 1 --limit 256
    # one process a card under torchrun (not yet run on cards)
    torchrun --nproc-per-node 4 -m quintnet_tpu_torch.examples.simple_pp

Without MNIST files under ``--data-dir``, ``$QT_DATA_DIR`` or ``./data``
the run trains on the ``synthetic_mnist`` stand-in and says so.
"""

import os

from quintnet_tpu_torch.examples.common import parse_args, run_vit


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    args = parse_args(os.path.join(here, "pp_config.json"), argv,
                      axis="pp")
    return run_vit(args, "pp")


if __name__ == "__main__":
    main()

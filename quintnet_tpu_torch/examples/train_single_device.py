"""Single-device ViT baseline: ``dp_config.json``'s model on one device.

Port of ``quintnet_tpu/examples/train_single_device.py``::

    python -m quintnet_tpu_torch.examples.train_single_device --epochs 1
    python -m quintnet_tpu_torch.examples.train_single_device --device cpu \\
        --epochs 1 --limit 256 --checkpoint-dir ckpt

The config's mesh (4 dp ranks) is forced to one device; the global batch
(32) stays. Without MNIST files under ``--data-dir``, ``$QT_DATA_DIR`` or
``./data`` the run trains on the ``synthetic_mnist`` stand-in and says
so.
"""

import os

from quintnet_tpu_torch.examples.common import parse_args, run_vit


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    args = parse_args(os.path.join(here, "dp_config.json"), argv)
    return run_vit(args, one_device=True)


if __name__ == "__main__":
    main()

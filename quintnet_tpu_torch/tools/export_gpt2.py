"""Export a trained GPT-2 checkpoint to an HF-layout safetensors file.

Port of ``quintnet_tpu/tools/export_gpt2.py``. A checkpoint step
(``train/checkpoint.py``, one device or a mesh) restores whole with no
mesh and no trainer, so the export is a restore and a layout change::

    python -m quintnet_tpu_torch.tools.export_gpt2 \\
        --checkpoint-dir ckpts/ --out gpt2_merged.safetensors \\
        [--step N] [--tp-layout TP]

``--tp-layout``: the tp size the model was trained with, so the fused
QKV columns are put back from the tp-blocked layout into HF's [q|k|v].
The sizes (``--n-layer``, ``--n-embd``, ``--n-head``, ``--vocab-size``,
``--n-positions``) default to GPT-2 124M's. Nothing runs on a device:
the arrays go from the checkpoint's files to the output file on the
host.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--tp-layout", type=int, default=1)
    ap.add_argument("--n-layer", type=int, default=12)
    ap.add_argument("--n-embd", type=int, default=768)
    ap.add_argument("--n-head", type=int, default=12)
    ap.add_argument("--vocab-size", type=int, default=50257)
    ap.add_argument("--n-positions", type=int, default=1024)
    args = ap.parse_args(argv)

    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.gpt2_io import save_hf_gpt2
    from quintnet_tpu_torch.train.checkpoint import CheckpointManager

    cfg = GPT2Config(vocab_size=args.vocab_size,
                     n_positions=args.n_positions, n_embd=args.n_embd,
                     n_layer=args.n_layer, n_head=args.n_head)
    mgr = CheckpointManager(args.checkpoint_dir)
    step = mgr.latest_step() if args.step is None else args.step
    state = mgr.restore(step=step)     # whole host arrays, no mesh
    save_hf_gpt2(state["params"], cfg, args.out, tp_layout=args.tp_layout)
    print(f"wrote {args.out} (step {step})")
    return step


if __name__ == "__main__":
    main()

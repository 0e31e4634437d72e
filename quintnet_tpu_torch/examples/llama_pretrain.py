"""Llama pretraining on packed CLM rows, on any mesh of the port.

Port of ``quintnet_tpu/examples/llama_pretrain.py``, one process per
rank (``examples/common.launch``)::

    python -m quintnet_tpu_torch.examples.llama_pretrain --device cpu \\
        --steps 4                                     # one CPU process
    python -m quintnet_tpu_torch.examples.llama_pretrain --device cpu \\
        --mesh dp2,ep2 --experts 4 --steps 2          # 4 gloo CPU ranks
    python -m quintnet_tpu_torch.examples.llama_pretrain --steps 4  # card

The model is the JAX example's small Llama (dim 64, 4 layers, 4/2
heads: GQA, vocab 264 for the byte tokenizer) or, with ``--preset``, a
published geometry (``llama32_1b``: Llama-3.2-1B's widths, random
weights from seed 0). It trains under the generic ``Trainer`` on
concat-and-chunk packed rows (``data.PackedLMDataset``, no padding)
with a cosine schedule after 10 warmup steps, clipping at 1.0 and
``zero2_adamw`` (plain AdamW under ``--fsdp``, which shards the blocks
over dp instead). Attention goes through ``ops.flash_attention`` (the
K1-K3 kernels on the card).

``--mesh dp2,tp2`` names the mesh (axes dp, tp, pp, ep; an sp part
raises ``NotImplementedError``: ROADMAP.md §1, item 6); ``--experts N``
makes every block a SwiGLU MoE of N experts (Mixtral-style; an ep axis
shards them); ``--isolate-docs`` masks attention across the packed
documents (segment ids from the EOS separator). ``--device`` and
``--backend`` choose where the ranks run (``examples/common.py``).
"""

from __future__ import annotations

import argparse
import itertools
import re

from quintnet_tpu_torch.examples.common import add_launch_args, launch

PRESETS = ("tiny", "llama32_1b", "llama_160m")


def _parse_mesh(ap, spec):
    """``"dp2,tp2"`` -> (names, dims); None: one device."""
    if not spec:
        return ["dp"], [1]
    names, dims = [], []
    for part in spec.split(","):
        m = re.fullmatch(r"([a-z]+)(\d+)", part)
        if not m:
            ap.error(f"bad --mesh part {part!r} (want e.g. dp2,tp2)")
        names.append(m.group(1))
        dims.append(int(m.group(2)))
    return names, dims


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default=None,
                    help="e.g. dp2,tp2 (default: one device)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=None,
                    help="optimizer steps per epoch (default: every row)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--docs", type=int, default=512,
                    help="synthetic documents to pack")
    ap.add_argument("--experts", type=int, default=0,
                    help="n_experts: Mixtral-style SwiGLU-MoE blocks (add "
                         "an ep axis to --mesh to shard them)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: blocks stored dp-sharded, gathered a "
                         "layer at a time (training.fsdp)")
    ap.add_argument("--isolate-docs", action="store_true",
                    help="mask cross-document attention in the packed rows "
                         "(segment ids from the EOS separator)")
    ap.add_argument("--preset", choices=PRESETS, default="tiny",
                    help="model geometry (default: the JAX example's)")
    add_launch_args(ap)
    args = ap.parse_args(argv)

    from quintnet_tpu_torch.core.config import Config

    names, dims = _parse_mesh(ap, args.mesh)
    cfg = Config.from_dict({
        "mesh_dim": dims, "mesh_name": names,
        "training": {
            "batch_size": args.batch, "epochs": args.epochs,
            "optimizer": "adamw" if args.fsdp else "zero2_adamw",
            "learning_rate": 3e-3, "lr_schedule": "cosine",
            "warmup_steps": 10, "decay_steps": 200, "grad_clip_norm": 1.0,
            "log_every": 20, "fsdp": args.fsdp}})
    return launch(_pretrain, args, cfg.mesh.world_size, cfg)


def _pretrain(args, cfg):
    import dataclasses

    import numpy as np

    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.data import ByteTokenizer, PackedLMDataset
    from quintnet_tpu_torch.models.llama import LlamaConfig, llama_model_spec
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.train.trainer import Trainer

    say = print if runtime.is_main_process() else (lambda *a: None)
    tok = ByteTokenizer()
    eos = tok.eos_token_id
    moe = dict(n_experts=args.experts,
               segment_eos_id=eos if args.isolate_docs else None)
    if args.preset == "tiny":
        lcfg = LlamaConfig.tiny(vocab_size=264, n_positions=args.seq, dim=64,
                                n_layers=4, n_heads=4, n_kv_heads=2,
                                intermediate_size=128, **moe)
    else:
        lcfg = dataclasses.replace(getattr(LlamaConfig, args.preset)(), **moe)
    strat = get_strategy("auto", cfg)
    model = llama_model_spec(lcfg, use_flash=True)
    say(f"strategy={strat.name} mesh={strat.mesh.shape} llama "
        f"dim={lcfg.dim} L={lcfg.n_layers} gqa {lcfg.n_heads}/"
        f"{lcfg.n_kv_heads} experts={lcfg.n_experts}")

    rng = np.random.default_rng(0)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy",
             "dogs", "while", "packing", "sequences", "tightly"]
    texts = [" ".join(rng.choice(words, size=rng.integers(8, 40)))
             for _ in range(args.docs)]
    ds = PackedLMDataset.from_texts(texts, tok, seq_len=args.seq)
    say(f"packed {args.docs} docs -> {len(ds)} rows x {args.seq} tokens, "
        f"zero padding")

    device = runtime.device() if runtime.is_multiprocess() else args.device
    trainer = Trainer(cfg, model, strategy=strat, task_type="clm",
                      device=device)

    def batches(epoch):
        it = ds.batches(args.batch, seed=epoch)
        return itertools.islice(it, args.steps) if args.steps else it

    hist = trainer.fit(batches)
    say(f"done in {hist.wall_time_s:.1f}s; loss {hist.train_loss[0]:.3f} "
        f"-> {hist.train_loss[-1]:.3f}")
    return hist


if __name__ == "__main__":
    main()

"""GPT-2 summarization finetune on one device.

Port of ``quintnet_tpu/examples/gpt2_finetune.py``. Run::

    python -m quintnet_tpu_torch.examples.gpt2_finetune --steps 4
    python -m quintnet_tpu_torch.examples.gpt2_finetune --tiny --steps 4 \\
        --device cpu

It reads the reference finetune config (``gpt2_config.json`` beside this
file: the JAX package's ``gpt2_config.yaml`` in JSON, which loads
without PyYAML; ``--config`` takes either form). That config asks for a
2 x 2 x 2 dp x tp x pp mesh; the port trains on one device, so the mesh
is forced to one device, its dp ranks' micro-batches become gradient
accumulation steps (the global batch and the micro-batch stay the
reference's: 512 and 32), and the example says so. The data is the
synthetic summarization set unless ``--csv`` names an article/highlights
file; the tokenizer is the byte-level one. Attention goes through
``ops.flash_attention`` (the K1-K3 kernels on the card), except that the
config's ``attn_pdrop = 0.1`` sends it to the plain blockwise path,
which carries the dropout: no kernel runs at that rate.

``--tiny`` trains a 4-layer, 32-wide GPT-2 on 64-token rows (a smoke
run); ``--steps N`` stops each epoch after N optimizer steps.
"""

from __future__ import annotations

import argparse
import itertools
import os


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=os.path.join(here,
                                                     "gpt2_config.json"))
    ap.add_argument("--csv", default=None, help="article/highlights CSV")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help="optimizer steps per epoch (default: the whole "
                         "train set)")
    ap.add_argument("--tiny", action="store_true",
                    help="use a tiny GPT-2 (smoke runs)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default=None)
    args = ap.parse_args(argv)

    from quintnet_tpu_torch.core.config import MeshConfig, load_config
    from quintnet_tpu_torch.data import ByteTokenizer, SummarizationDataset
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    if cfg.mesh.world_size > 1:
        # the data-parallel ranks' micro-batches become accumulation
        # steps: the same global batch and per-device micro-batch
        split = cfg.dp_size * cfg.ep_size
        cfg.training.gradient_accumulation_steps *= split
        print(f"mesh {cfg.mesh.axis_sizes} forced to one device: the port "
              f"trains on one device (ROADMAP.md §1, slice 3); "
              f"gradient_accumulation_steps x {split} = "
              f"{cfg.training.gradient_accumulation_steps}")
        cfg.mesh = MeshConfig()
        cfg.strategy_name = "single"
    if args.epochs:
        cfg.training.epochs = args.epochs

    tok = ByteTokenizer()
    if args.tiny:
        # the vocab must cover the tokenizer's ids
        gcfg = GPT2Config.tiny(vocab_size=-(-max(tok.vocab_size, 128)
                                            // 8) * 8)
    else:
        gcfg = GPT2Config.from_dict(
            {**cfg.model.extra, **{k: v for k, v in vars(cfg.model).items()
                                   if not isinstance(v, dict)}})
    max_len = int(cfg.data.get("max_seq_length", 512))
    if args.tiny:
        max_len = min(max_len, gcfg.n_positions)
    bs = cfg.training.batch_size
    micro = cfg.micro_batch_size_resolved()
    if args.csv:
        train_ds = SummarizationDataset.from_csv(
            args.csv, tok, max_length=max_len,
            limit=cfg.data.get("train_samples"))
        val_ds = SummarizationDataset.from_csv(
            args.csv, tok, max_length=max_len,
            limit=cfg.data.get("val_samples"))
    else:
        train_ds = SummarizationDataset.synthetic(
            int(cfg.data.get("train_samples", 1024)), tok,
            max_length=max_len)
        val_ds = SummarizationDataset.synthetic(
            int(cfg.data.get("val_samples", 128)), tok, max_length=max_len,
            seed=1)

    model = gpt2_model_spec(gcfg, remat=cfg.training.remat_mode,
                            use_flash=True)
    trainer = Trainer(cfg, model, task_type="clm",
                      checkpoint_dir=args.checkpoint_dir, device=args.device)
    print(f"strategy={trainer.strategy.name} device={trainer.device} "
          f"gpt2 n_layer={gcfg.n_layer} n_embd={gcfg.n_embd} "
          f"pdrops={gcfg.pdrops}")

    def train_batches(epoch):
        batches = train_ds.batches(bs, seed=epoch)
        return itertools.islice(batches, args.steps) if args.steps else batches

    # validation in micro-batches: a whole global batch of full-vocab
    # logits would not fit one device
    hist = trainer.fit(
        train_batches,
        val_batches_fn=lambda ep: val_ds.batches(micro, shuffle=False))
    print(f"done in {hist.wall_time_s:.1f}s; "
          f"train_loss {hist.train_loss[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()

"""GPT-2 summarization finetune on the config's dp x tp x pp mesh.

Port of ``quintnet_tpu/examples/gpt2_finetune.py``, one process per
rank (``examples/common.launch``)::

    python -m quintnet_tpu_torch.examples.gpt2_finetune --tiny --steps 4 \\
        --device cpu                                  # gloo, 8 CPU ranks
    # 8 ranks sharing one card over gloo
    python -m quintnet_tpu_torch.examples.gpt2_finetune --steps 2 \\
        --device cuda:0 --backend gloo
    # 8 cards over NCCL (not yet run on cards): spawned here, or torchrun
    python -m quintnet_tpu_torch.examples.gpt2_finetune --steps 4
    torchrun --nproc-per-node 8 -m quintnet_tpu_torch.examples.gpt2_finetune

It reads the reference finetune config (``gpt2_config.json`` beside this
file: the JAX package's ``gpt2_config.yaml`` in JSON, which loads
without PyYAML; ``--config`` takes either form) and trains what it asks
for, as the JAX example does: a 2 x 2 x 2 dp x tp x pp mesh (8 ranks)
with the 1F1B schedule over its 8 accumulation steps (the pipeline's
micro-batches) and ``zero1_adamw`` (AdamW with its state sharded over
dp). The data is the synthetic summarization set unless ``--csv`` names
an article/highlights file; the tokenizer is the byte-level one.
Attention goes through ``ops.flash_attention`` (the K1-K3 kernels on
the card), except that the config's ``attn_pdrop = 0.1`` sends it to
the plain blockwise path, which carries the dropout: no kernel runs at
that rate.

``training.dtype`` chooses the compute dtype as in the JAX example:
``bfloat16`` casts the f32 parameters to bf16 at use (the K1-K3 bf16
kernels on the card), ``float32`` keeps f32; anything else raises
``ValueError``. ``training.adam_mu_dtype: bfloat16`` stores Adam's first
moment in bf16.

``--tiny`` trains a 4-layer, 32-wide GPT-2 on 64-token rows (a smoke
run); ``--steps N`` stops each epoch after N optimizer steps.
``--experts N`` makes every block's MLP a top-2 MoE of N experts
(GPT-2-MoE from random weights; an ``ep`` axis in the config's mesh
shards them).
``--gen-eval N`` then generates summaries for N validation rows with
the KV-cache decoder and reports ROUGE-1/2/L and BLEU
(``train/metrics.evaluate_generation``): the trained parameters are
gathered whole from every rank and taken back from the tp layout, and
rank 0 decodes on its device; greedy unless ``--gen-temp`` (then
``--gen-top-k``/``--gen-top-p`` filter the sampling chain, seeded by
``training.seed``), beam search with ``--gen-beams``::

    python -m quintnet_tpu_torch.examples.gpt2_finetune --tiny --steps 1 \
        --epochs 1 --device cpu --gen-eval 4

``--checkpoint-dir`` saves every rank's part of each step there (and
resumes from it), with ``model_config.json`` (the model's geometry and
its tp layout) beside the steps. Starting from Hugging Face weights
(the JAX example's ``--checkpoint``) waits for ``models/gpt2_io.py``
(ROADMAP.md §1, item 9).
``--device`` and ``--backend`` choose where the ranks run
(``examples/common.py``).
"""

from __future__ import annotations

import argparse
import itertools
import os

from quintnet_tpu_torch.examples.common import add_launch_args, launch


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
    ap.add_argument("--experts", type=int, default=0,
                    help="n_experts: turn the model into a GPT-2-MoE "
                         "(top-2 routed expert MLPs, ep-shardable)")
    ap.add_argument("--gen-eval", type=int, default=0, metavar="N",
                    help="after training, generate summaries for N val "
                         "samples (KV-cache decoder) and report "
                         "ROUGE-1/2/L + BLEU (greedy unless --gen-temp)")
    ap.add_argument("--gen-temp", type=float, default=0.0,
                    help="sampling temperature for --gen-eval (0=greedy)")
    ap.add_argument("--gen-top-k", type=int, default=0)
    ap.add_argument("--gen-top-p", type=float, default=1.0)
    ap.add_argument("--gen-beams", type=int, default=1,
                    help="beam width for --gen-eval (single-device "
                         "decode)")
    add_launch_args(ap)
    ap.add_argument("--checkpoint-dir", default=None)
    args = ap.parse_args(argv)

    from quintnet_tpu_torch.core.config import load_config

    cfg = load_config(args.config)
    return launch(_finetune, args, cfg.mesh.world_size, cfg)


def _finetune(args, cfg):
    import torch

    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.data import ByteTokenizer, SummarizationDataset
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    say = print if runtime.is_main_process() else (lambda *a: None)
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
    if args.experts:
        import dataclasses

        gcfg = dataclasses.replace(gcfg, n_experts=args.experts)
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

    if cfg.training.dtype not in ("bfloat16", "float32"):
        raise ValueError(
            f"training.dtype must be 'bfloat16' or 'float32', "
            f"got {cfg.training.dtype!r}")
    compute_dtype = (torch.bfloat16 if cfg.training.dtype == "bfloat16"
                     else None)
    model = gpt2_model_spec(gcfg, remat=cfg.training.remat_mode,
                            use_flash=True, compute_dtype=compute_dtype)
    device = runtime.device() if runtime.is_multiprocess() else args.device
    trainer = Trainer(cfg, model, task_type="clm",
                      checkpoint_dir=args.checkpoint_dir, device=device)
    if args.checkpoint_dir and runtime.is_main_process():
        # the model's geometry beside the checkpoints, so a later tool
        # can rebuild the restore template without the run's flags
        import dataclasses
        import json

        os.makedirs(args.checkpoint_dir, exist_ok=True)
        with open(os.path.join(args.checkpoint_dir, "model_config.json"),
                  "w") as f:
            json.dump({"family": "gpt2", "tp_layout": cfg.tp_size,
                       **dataclasses.asdict(gcfg)}, f, indent=1)
    say(f"strategy={trainer.strategy.name} mesh={trainer.strategy.mesh.shape}"
        f" device={trainer.device} "
        f"gpt2 n_layer={gcfg.n_layer} n_embd={gcfg.n_embd} "
        f"experts={gcfg.n_experts} "
        f"pdrops={gcfg.pdrops} dtype={cfg.training.dtype} "
        f"adam_mu_dtype={cfg.training.adam_mu_dtype} "
        f"schedule={cfg.training.schedule} optimizer={cfg.training.optimizer}")

    def train_batches(epoch):
        batches = train_ds.batches(bs, seed=epoch)
        return itertools.islice(batches, args.steps) if args.steps else batches

    # validation in micro-batches (one a dp rank): a whole global batch
    # of full-vocab logits would not fit one device
    val_rows = micro * cfg.dp_size * cfg.ep_size
    hist = trainer.fit(
        train_batches,
        val_batches_fn=lambda ep: val_ds.batches(val_rows, shuffle=False))
    say(f"done in {hist.wall_time_s:.1f}s; "
        f"train_loss {hist.train_loss[-1]:.4f}")
    if args.gen_eval:
        scores = _gen_eval(args, cfg, gcfg, trainer, val_ds, tok, max_len)
        if scores is not None:
            say("generation eval:",
                {k: round(v, 4) for k, v in scores.items()})
    return hist


def _gen_eval(args, cfg, gcfg, trainer, val_ds, tok, max_len):
    """ROUGE/BLEU of ``--gen-eval`` rows on the trained weights: every
    leaf gathered whole over the mesh (a collective: every rank takes
    part), taken back from the tp layout, decoded on rank 0 alone
    (others return None)."""
    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.core.pytree import tree_leaves
    from quintnet_tpu_torch.models.gpt2 import gpt2_from_tp_layout
    from quintnet_tpu_torch.parallel.tp import gather_leaf
    from quintnet_tpu_torch.train.metrics import evaluate_generation

    params = trainer.final_state[0]
    mesh = trainer.strategy.mesh
    if mesh is not None and mesh.size > 1:
        specs = dict(tree_leaves(
            trainer.strategy.param_specs(trainer.model)))

        def gathered(tree, path=()):
            if isinstance(tree, dict):
                return {k: gathered(v, path + (k,)) for k, v in tree.items()}
            return gather_leaf(tree.detach(), specs[path], mesh)

        params = gathered(params)
    if not runtime.is_main_process():
        return None
    params = gpt2_from_tp_layout(params, gcfg, cfg.tp_size)
    max_prompt = max(max_len // 2, 8)
    prompts = val_ds.eval_prompts(max_prompt_len=max_prompt,
                                  limit=args.gen_eval)
    return evaluate_generation(
        params, gcfg, prompts, tok,
        max_new_tokens=min(64, gcfg.n_positions - max_prompt),
        eos_token_id=getattr(tok, "eos_token_id", None),
        temperature=args.gen_temp, top_k=args.gen_top_k,
        top_p=args.gen_top_p, beams=args.gen_beams,
        seed=cfg.training.seed)


if __name__ == "__main__":
    main()

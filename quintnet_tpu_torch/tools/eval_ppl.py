"""Perplexity of a GPT-2 or Llama checkpoint over a text file.

Port of ``quintnet_tpu/tools/eval_ppl.py``: the packed-stride standard.
The whole file is tokenised, packed into windows of ``--seq`` with no
padding (``data/datasets.pack_documents``; the EOS-padded tail of the
last window carries no loss), and the mean CLM loss over the real
targets gives ppl = exp(loss). The byte tokenizer is the default (no
network); an HF tokenizer directory gives real BPE::

    python -m quintnet_tpu_torch.tools.eval_ppl --text file.txt \\
        [--family gpt2|llama] [--checkpoint model.safetensors] \\
        [--tokenizer tok_dir] [--seq 512] [--batch 8] [--device cpu]

A GPT-2 ``--checkpoint`` is an HF safetensors file
(``models/gpt2_io.load_hf_gpt2``, e.g. ``tools/export_gpt2``'s output);
a Llama one is an HF model directory, read through ``transformers``
(imported here only, as is ``transformers`` for ``--tokenizer``).
Without ``--checkpoint`` a random tiny model runs (a plumbing smoke;
its number means nothing). On the card attention goes through the flash
dispatcher, so the forward runs the K1 kernel (``evaluate(use_flash=
False)``: the plain attention instead).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import numpy as np
import torch


def packed_windows(tokenizer, text: str, seq: int):
    """``(rows [N, seq] int32, labels [N, seq], real tokens)``: ``text``
    encoded, EOS-separated and packed; the EOS padding of the last
    window is masked out of the labels."""
    from quintnet_tpu_torch.data.datasets import pack_documents
    from quintnet_tpu_torch.models.gpt2 import IGNORE_INDEX

    eos = getattr(tokenizer, "eos_token_id", 0) or 0
    enc = tokenizer.encode(text)
    if not enc:
        raise ValueError("the text holds no tokens to evaluate")
    rows = pack_documents([enc], seq, eos_id=eos, drop_remainder=False)
    labels = rows.copy()
    n_real = len(enc) + 1          # + the appended EOS separator
    rem = n_real % seq
    if rem:
        labels[-1, rem:] = IGNORE_INDEX
    return rows, labels, n_real


def eval_loss(apply_fn, params, rows, labels, *, batch: int,
              device) -> float:
    """The mean CLM loss over ``rows`` in batches of ``batch``, each
    batch weighted by its real (unmasked) shifted targets."""
    from quintnet_tpu_torch.models.gpt2 import IGNORE_INDEX, clm_loss

    losses, weights = [], []
    with torch.no_grad():
        for i in range(0, len(rows), batch):
            b, lb = rows[i:i + batch], labels[i:i + batch]
            ids = torch.as_tensor(b, dtype=torch.long, device=device)
            lab = torch.as_tensor(lb, dtype=torch.long, device=device)
            losses.append(float(clm_loss(apply_fn(params, ids), lab)))
            weights.append(int(np.sum(lb[:, 1:] != IGNORE_INDEX)))
    return float(np.average(losses, weights=weights))


def _tiny_vocab(tokenizer) -> int:
    return -(-max(getattr(tokenizer, "vocab_size", 257), 128) // 8) * 8


def load_model(family: str, checkpoint, tokenizer, seq: int, *, device,
               use_flash: bool = True, isolate_docs: bool = False):
    """``(params, apply_fn)`` of the model to score: the checkpoint's, or
    a random tiny model (seed 0) sized for ``tokenizer`` and ``seq``."""
    eos = getattr(tokenizer, "eos_token_id", 0) or 0

    def isolated(cfg):
        return (dataclasses.replace(cfg, segment_eos_id=eos)
                if isolate_docs else cfg)

    gen = torch.Generator(device=device).manual_seed(0)
    if family == "gpt2":
        from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_apply,
                                                    gpt2_init)

        if checkpoint:
            from quintnet_tpu_torch.models.gpt2_io import load_hf_gpt2

            params, cfg = load_hf_gpt2(checkpoint, device=device)
        else:
            cfg = GPT2Config.tiny(vocab_size=_tiny_vocab(tokenizer),
                                  n_positions=max(64, seq))
            params = gpt2_init(gen, cfg)
        cfg = isolated(cfg)
        return params, (lambda p, ids: gpt2_apply(p, ids, cfg,
                                                  use_flash=use_flash))
    from quintnet_tpu_torch.models.llama import (LlamaConfig, llama_apply,
                                                 llama_from_hf_state,
                                                 llama_init)

    if checkpoint:
        # a Llama checkpoint is an HF model directory (config + weights),
        # read by transformers and imported through llama_from_hf_state
        if not os.path.isdir(checkpoint):
            raise ValueError(f"--family llama --checkpoint wants an HF "
                             f"model directory, got {checkpoint!r}")
        import transformers

        hf = transformers.LlamaForCausalLM.from_pretrained(
            checkpoint, torch_dtype=torch.float32).eval()
        cfg = LlamaConfig.from_hf_config(hf.config)
        params = llama_from_hf_state(hf.state_dict(), cfg, device=device)
    else:
        cfg = LlamaConfig.tiny(vocab_size=_tiny_vocab(tokenizer),
                               n_positions=max(64, seq))
        params = llama_init(gen, cfg)
    cfg = isolated(cfg)
    return params, (lambda p, ids: llama_apply(p, ids, cfg,
                                               use_flash=use_flash))


def evaluate(text_path: str, *, family: str = "gpt2", checkpoint=None,
             tokenizer=None, seq: int = 512, batch: int = 8,
             device="cuda", use_flash: bool = True,
             isolate_docs: bool = False) -> dict:
    """The perplexity of ``family`` (from ``checkpoint``, else a random
    tiny model) over the text file: ``{"loss", "perplexity", "windows",
    "real_tokens", "seconds"}`` (``seconds``: the scoring alone, the
    model loaded). ``tokenizer``: an HF tokenizer directory, else the
    byte tokenizer. ``use_flash``: attention through the flash
    dispatcher (the K1 kernel on the card), else the plain attention."""
    from quintnet_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if tokenizer:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(tokenizer)
    else:
        from quintnet_tpu_torch.data.datasets import ByteTokenizer

        tok = ByteTokenizer()
    with open(text_path, encoding="utf-8") as f:
        rows, labels, n_real = packed_windows(tok, f.read(), seq)
    params, apply_fn = load_model(family, checkpoint, tok, seq, device=dev,
                                  use_flash=use_flash,
                                  isolate_docs=isolate_docs)
    t0 = time.perf_counter()
    loss = eval_loss(apply_fn, params, rows, labels, batch=batch,
                     device=dev)
    return {"loss": loss, "perplexity": math.exp(min(loss, 20.0)),
            "windows": len(rows), "real_tokens": n_real,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--text", required=True)
    ap.add_argument("--family", default="gpt2", choices=["gpt2", "llama"])
    ap.add_argument("--checkpoint", default=None,
                    help="HF safetensors file (gpt2) or HF model directory "
                         "(llama); a random tiny model if omitted")
    ap.add_argument("--tokenizer", default=None,
                    help="HF tokenizer directory; default byte-level")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--isolate-docs", action="store_true",
                    help="mask cross-document attention in the packed "
                         "windows (segment_eos_id on the model config): "
                         "match this to how the model was trained")
    args = ap.parse_args(argv)
    try:
        res = evaluate(args.text, family=args.family,
                       checkpoint=args.checkpoint, tokenizer=args.tokenizer,
                       seq=args.seq, batch=args.batch, device=args.device,
                       isolate_docs=args.isolate_docs)
    except ValueError as e:
        raise SystemExit(f"eval_ppl: {e}") from None
    print(f"{res['windows']} windows x {args.seq} tokens "
          f"({res['real_tokens']} real tokens)")
    print(f"loss {res['loss']:.4f}  perplexity {res['perplexity']:.2f}")
    return res


if __name__ == "__main__":
    main()

"""Metrics: classification, perplexity, ROUGE/BLEU and the generation eval.

Port of ``quintnet_tpu/train/metrics.py``. ROUGE-1/2/L and BLEU are
implemented directly, as in JAX (ROUGE f-measures on unigrams, bigrams
and the LCS; BLEU-4 with the brevity penalty), in pure Python.
:func:`evaluate_generation` scores continuations from the KV-cache
decoders (``models/gpt2_generate.py``: greedy, sampled, beams, or tp on a
live mesh; any ``generate_fn``).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from quintnet_tpu_torch.models.gpt2 import perplexity

__all__ = ["accuracy", "perplexity", "rouge_scores", "bleu_score",
           "compute_rouge_bleu", "evaluate_generation"]


def accuracy(logits, labels):
    """Share of rows whose argmax over the last dim equals the label."""
    return (logits.argmax(dim=-1) == labels).float().mean()


# --------------------------------------------------------------------------
# ROUGE / BLEU (pure python)

def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _f1(match: int, pred: int, ref: int) -> float:
    if pred == 0 or ref == 0 or match == 0:
        return 0.0
    p, r = match / pred, match / ref
    return 2 * p * r / (p + r)


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_scores(prediction: str, reference: str) -> Dict[str, float]:
    """ROUGE-1/2/L f-measures (whitespace tokens, lowercased)."""
    p = prediction.lower().split()
    r = reference.lower().split()
    out = {}
    for n, key in ((1, "rouge1"), (2, "rouge2")):
        pn, rn = _ngrams(p, n), _ngrams(r, n)
        match = sum((pn & rn).values())
        out[key] = _f1(match, max(len(p) - n + 1, 0), max(len(r) - n + 1, 0))
    out["rougeL"] = _f1(_lcs_len(p, r), len(p), len(r))
    return out


def bleu_score(prediction: str, references: Sequence[str],
               max_n: int = 4) -> float:
    """BLEU-4 of one sentence: the geometric mean of the clipped n-gram
    precisions (a zero match counts 0.1) times the brevity penalty."""
    p = prediction.lower().split()
    refs = [r.lower().split() for r in references]
    if not p:
        return 0.0
    log_prec = 0.0
    for n in range(1, max_n + 1):
        pn = _ngrams(p, n)
        if not pn:
            return 0.0
        best = Counter()
        for r in refs:
            rn = _ngrams(r, n)
            for g in pn:
                best[g] = max(best[g], rn.get(g, 0))
        match = sum(min(c, best[g]) for g, c in pn.items())
        prec = max(match, 0.1) / sum(pn.values()) if match == 0 else \
            match / sum(pn.values())
        log_prec += math.log(prec)
    ref_len = min((abs(len(r) - len(p)), len(r)) for r in refs)[1]
    bp = 1.0 if len(p) >= ref_len else math.exp(1 - ref_len / len(p))
    return bp * math.exp(log_prec / max_n)


def compute_rouge_bleu(predictions: Sequence[str],
                       references: Sequence[str]) -> Dict[str, float]:
    """Mean ROUGE-1/2/L and BLEU over (prediction, reference) pairs."""
    agg = {"rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0, "bleu": 0.0}
    n = max(len(predictions), 1)
    for pred, ref in zip(predictions, references):
        r = rouge_scores(pred, ref)
        for k in ("rouge1", "rouge2", "rougeL"):
            agg[k] += r[k] / n
        agg["bleu"] += bleu_score(pred, [ref]) / n
    return agg


# --------------------------------------------------------------------------
# generation eval

@torch.no_grad()
def evaluate_generation(params, cfg, prompts: Sequence, tokenizer, *,
                        max_new_tokens: int = 64,
                        eos_token_id: Optional[int] = None,
                        batch_size: int = 8,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 1.0, seed=0, beams: int = 1,
                        generate_fn=None,
                        mesh=None, tp_axis: str = "tp") -> Dict[str, float]:
    """Generate continuations with the KV-cache decoder and score
    ROUGE-1/2/L and BLEU against the references.

    ``prompts``: (prompt token ids, reference text) pairs (e.g.
    ``SummarizationDataset.eval_prompts``), grouped by length and
    generated ``batch_size`` at a time; each continuation is cut at its
    first ``eos_token_id``. ``seed``: the sampling chain's seed of every
    batch (JAX's ``key``). ``mesh``: tp-sharded decoding on this rank of
    a live mesh, ``params`` in their tp training layout
    (``gpt2_generate_tp``). ``generate_fn(params, batch_ids, cfg,
    max_new_tokens=, eos_token_id=, temperature=, top_k=, top_p=,
    seed=)`` replaces the decoder (e.g. ``llama_generate``); with ``beams
    > 1`` it gets ``beams=`` instead of the sampling keywords. The
    built-in beam decoder is single-device: beams under a tp > 1 mesh are
    refused."""
    from quintnet_tpu_torch.models.gpt2_generate import (gpt2_beam_search,
                                                         gpt2_generate,
                                                         gpt2_generate_tp)

    tp = 1 if mesh is None else mesh.shape.get(tp_axis, 1)
    if beams > 1 and generate_fn is None and tp > 1:
        raise ValueError(
            "beams > 1 under a tp>1 mesh is not implemented by the "
            "built-in decoder; use beams=1 (sampling/greedy tp "
            "decode), a single-device mesh, or a beam-capable "
            "generate_fn")

    by_len: Dict[int, List[int]] = {}
    for i, (ids, _ref) in enumerate(prompts):
        by_len.setdefault(len(ids), []).append(i)

    preds: List[str] = [""] * len(prompts)
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                  seed=seed)
    for n, idxs in sorted(by_len.items()):
        for j in range(0, len(idxs), batch_size):
            grp = idxs[j:j + batch_size]
            batch = np.asarray([prompts[i][0] for i in grp], np.int32)
            if generate_fn is not None:
                kw = dict(beams=beams) if beams > 1 else sample
                out = generate_fn(params, batch, cfg,
                                  max_new_tokens=max_new_tokens,
                                  eos_token_id=eos_token_id, **kw)
            elif beams > 1:
                out = gpt2_beam_search(params, batch, cfg, beams=beams,
                                       max_new_tokens=max_new_tokens,
                                       eos_token_id=eos_token_id)
            elif tp > 1:
                out = gpt2_generate_tp(params, batch, cfg, mesh=mesh,
                                       tp_axis=tp_axis,
                                       max_new_tokens=max_new_tokens,
                                       eos_token_id=eos_token_id, **sample)
            else:
                out = gpt2_generate(params, batch, cfg,
                                    max_new_tokens=max_new_tokens,
                                    eos_token_id=eos_token_id, **sample)
            for row, i in zip(np.asarray(out), grp):
                new = row[n:]
                if eos_token_id is not None:
                    stop = np.where(new == eos_token_id)[0]
                    if stop.size:
                        new = new[: stop[0]]
                preds[i] = tokenizer.decode([int(t) for t in new])

    return compute_rouge_bleu(preds, [ref for _ids, ref in prompts])

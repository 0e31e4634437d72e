"""Causal-LM datasets: byte tokenizer, summarization rows, packed rows.

Port of the GPT-2 half of ``quintnet_tpu/data/datasets.py``, numpy only
(the same code, so the port and the JAX package see the same batches
from the same seed). Batches are host numpy ``(input_ids, labels)``
int32 pairs; the trainer moves them to the device.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


class ByteTokenizer:
    """Byte-level fallback tokenizer (no-network stand-in for HF
    GPT2Tokenizer): ids 0-255 are bytes, 256=pad/eos."""

    vocab_size = 257
    pad_token_id = 256
    eos_token_id = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8",
                                                            errors="replace")


def pack_documents(docs: Sequence[Sequence[int]], seq_len: int,
                   *, eos_id: int, drop_remainder: bool = True
                   ) -> np.ndarray:
    """Concat-and-chunk sequence packing: token docs are joined with an
    EOS separator and chunked into [N, seq_len] rows with no padding —
    every position carries training signal (vs the reference's per-row
    right-padding where short rows waste most of the batch,
    utils/Dataloader.py:263-319). Standard LM-pretraining packing;
    cross-document attention is accepted (GPT-2 convention).

    Returns int32 [N, seq_len]. The remainder tail is dropped by
    default (set ``drop_remainder=False`` to keep it EOS-padded)."""
    flat: List[int] = []
    for d in docs:
        flat.extend(int(t) for t in d)
        flat.append(eos_id)
    n = len(flat) // seq_len
    rem = len(flat) - n * seq_len
    if rem and not drop_remainder:
        flat.extend([eos_id] * (seq_len - rem))
        n += 1
    return np.asarray(flat[: n * seq_len], np.int32).reshape(n, seq_len)


def segments_from_tokens(rows: np.ndarray, eos_id: int) -> np.ndarray:
    """Packed rows [N, S] -> per-position document ids [N, S] int32 for
    attention segment masking (ops/flash_attention.flash_attention
    ``segment_ids``): each EOS separator closes its document, so the id
    increments AFTER every eos. Ids restart at 0 per row (attention
    never crosses rows, so only within-row distinctness matters)."""
    rows = np.asarray(rows)
    ends = np.cumsum(rows == eos_id, axis=1)
    seg = np.concatenate([np.zeros_like(ends[:, :1]), ends[:, :-1]], axis=1)
    return seg.astype(np.int32)


class PackedLMDataset:
    """Causal-LM dataset over packed rows: labels ARE the inputs (the
    model's CLM loss does the shift; models/gpt2.py clm_loss), so there
    is no -100 masking and no padding — maximal tokens/step.

    Build from raw texts + any tokenizer with ``encode``/``eos_token_id``
    (HF GPT2Tokenizer or the ByteTokenizer fallback). Cross-document
    attention is the default (GPT-2 convention); pass the rows through
    :func:`segments_from_tokens` and hand the result to the attention
    stack for strict document isolation."""

    def __init__(self, rows: np.ndarray):
        assert rows.ndim == 2, rows.shape
        self.rows = rows

    @staticmethod
    def from_texts(texts: Sequence[str], tokenizer, *, seq_len: int,
                   drop_remainder: bool = True) -> "PackedLMDataset":
        eos = getattr(tokenizer, "eos_token_id", 0) or 0
        docs = [tokenizer.encode(t) for t in texts]
        return PackedLMDataset(pack_documents(docs, seq_len, eos_id=eos,
                                              drop_remainder=drop_remainder))

    def __len__(self):
        return len(self.rows)

    def batches(self, batch_size: int, *, seed: int = 0,
                shuffle: bool = True, drop_last: bool = True,
                start_batch: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.rows))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
        for i in range(start_batch * batch_size, end, batch_size):
            b = self.rows[idx[i:i + batch_size]]
            yield b, b.copy()


class SummarizationDataset:
    """CSV (article, highlights) pairs -> CLM tensors with the reference's
    prompt format: ``article + "\\n\\nTL;DR: " + summary`` and labels =
    input_ids with prompt/pad masked to -100
    (utils/Dataloader.py:263-319).
    """

    PROMPT = "\n\nTL;DR: "

    def __init__(self, rows: Sequence[Tuple[str, str]], tokenizer,
                 *, max_length: int = 512):
        self.rows = list(rows)
        self.tok = tokenizer
        self.max_length = max_length

    @staticmethod
    def from_csv(path: str, tokenizer, *, max_length: int = 512,
                 article_col: str = "article", summary_col: str = "highlights",
                 limit: Optional[int] = None) -> "SummarizationDataset":
        import csv

        rows = []
        with open(path, newline="", encoding="utf-8") as f:
            for i, rec in enumerate(csv.DictReader(f)):
                if limit is not None and i >= limit:
                    break
                rows.append((rec[article_col], rec[summary_col]))
        return SummarizationDataset(rows, tokenizer, max_length=max_length)

    @staticmethod
    def synthetic(n: int, tokenizer, *, max_length: int = 128, seed: int = 0
                  ) -> "SummarizationDataset":
        rng = np.random.default_rng(seed)
        words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta",
                 "eta", "theta"]
        rows = []
        for _ in range(n):
            k = rng.integers(8, 20)
            art = " ".join(rng.choice(words, size=k))
            summ = " ".join(art.split()[: max(2, k // 4)])
            rows.append((art, summ))
        return SummarizationDataset(rows, tokenizer, max_length=max_length)

    def __len__(self):
        return len(self.rows)

    def encode_row(self, article: str, summary: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
        pad = getattr(self.tok, "pad_token_id", 0) or 0
        prompt_ids = self.tok.encode(article + self.PROMPT)
        summ_ids = self.tok.encode(summary)
        # Keep the training signal: when prompt+summary overflow, drop
        # article tokens from the LEFT (the "\n\nTL;DR: " marker at the
        # prompt's tail survives). Plain right-truncation can leave a row
        # with every label masked — at small max_length whole batches
        # become no-ops and the loss is silently 0.
        max_prompt = max(self.max_length - len(summ_ids), 0)
        if len(prompt_ids) > max_prompt:
            prompt_ids = prompt_ids[len(prompt_ids) - max_prompt:]
        ids = (prompt_ids + summ_ids)[: self.max_length]
        n_prompt = min(len(prompt_ids), self.max_length)
        labels = [-100] * n_prompt + ids[n_prompt:]
        padlen = self.max_length - len(ids)
        ids = ids + [pad] * padlen
        labels = labels + [-100] * padlen
        return (np.asarray(ids, np.int32), np.asarray(labels, np.int32))

    def batches(self, batch_size: int, *, seed: int = 0, shuffle: bool = True,
                drop_last: bool = True, start_batch: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.rows))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
        # start_batch skips by index — no skipped row is ever tokenised
        # (the win over generic skip_batches is largest here)
        for i in range(start_batch * batch_size, end, batch_size):
            enc = [self.encode_row(*self.rows[j]) for j in idx[i:i + batch_size]]
            yield (np.stack([e[0] for e in enc]),
                   np.stack([e[1] for e in enc]))

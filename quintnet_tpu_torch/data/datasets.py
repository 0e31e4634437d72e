"""Datasets: MNIST images and causal-LM rows (numpy batches).

Port of ``quintnet_tpu/data/datasets.py``, numpy only: the MNIST half
(IDX / ``.gz`` / ``mnist.npz`` files, the reference's normalisation, the
deterministic ``synthetic_mnist`` stand-in, ``ArrayDataset`` and
``make_batches``), the GPT-2 half (byte tokenizer, summarization
rows, packed rows) and the Hugging Face readers (``load_hf_dataset``,
``summarization_from_hf``, ``mnist_from_hf``; ``datasets`` imported
inside them). It is the same code, so the port and the JAX package
see the same arrays and the same batch order from the same seed.
Batches are host numpy ``(x, y)`` pairs; the trainer moves them to the
device. Every map-style iterator takes ``start_batch=`` (skip by index
arithmetic, for step-granular resume); :func:`skip_batches` skips any
other iterator by consuming it.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}


def _read_idx(path: str) -> np.ndarray:
    """One IDX file (optionally gzipped) -> its uint8 array."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def load_mnist(data_dir: Optional[str] = None, *, split: str = "train",
               synthetic_ok: bool = True,
               synthetic_size: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """(images [N, 28, 28, 1] float32 normalised, labels [N] int32).

    Looks for ``mnist.npz`` or the IDX files (``.gz`` or plain) under
    ``data_dir``, then ``$QT_DATA_DIR``, then ``./data``; without them,
    falls back to :func:`synthetic_mnist` (seed 0 for train, 1 for test)
    when ``synthetic_ok``, else raises ``FileNotFoundError``. The
    normalisation is the reference's (mean 0.1307, std 0.3081)."""
    candidates = [d for d in (data_dir, os.environ.get("QT_DATA_DIR"),
                              "data") if d]
    which = "train" if split == "train" else "test"
    for d in candidates:
        npz = os.path.join(d, "mnist.npz")
        if os.path.exists(npz):
            z = np.load(npz)
            return (_norm(z[f"x_{which}"]),
                    z[f"y_{which}"].astype(np.int32))
        img = os.path.join(d, MNIST_FILES[f"{which}_images"])
        lbl = os.path.join(d, MNIST_FILES[f"{which}_labels"])
        for im, lb in ((img, lbl), (img[:-3], lbl[:-3])):  # .gz / plain
            if os.path.exists(im) and os.path.exists(lb):
                return _norm(_read_idx(im)), _read_idx(lb).astype(np.int32)
    if not synthetic_ok:
        raise FileNotFoundError(
            f"MNIST not found under {candidates}; place mnist.npz or IDX "
            "files there, or allow synthetic_ok")
    return synthetic_mnist(synthetic_size, seed=0 if split == "train" else 1)


def _norm(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32) / 255.0
    x = (x - 0.1307) / 0.3081
    return x.reshape(x.shape[0], 28, 28, 1)


def synthetic_mnist(n: int, *, seed: int = 0,
                    signal: Tuple[float, float] = (0.06, 0.55),
                    noise: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """A learnable stand-in for MNIST, not MNIST: each class is a fixed
    random 28 x 28 prototype (shared by every split) scaled by a
    per-sample amplitude from ``U[signal]``, plus Gaussian noise of std
    ``noise``. Images [n, 28, 28, 1] float32, labels [n] int32."""
    protos = np.random.default_rng(42).normal(
        size=(10, 28, 28, 1)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    amp = rng.uniform(signal[0], signal[1],
                      size=(n, 1, 1, 1)).astype(np.float32)
    eps = rng.normal(scale=noise, size=(n, 28, 28, 1)).astype(np.float32)
    return protos[labels] * amp + eps, labels


@dataclass
class ArrayDataset:
    """In-memory (x, y) pairs."""

    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.x)


def make_batches(ds: ArrayDataset, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True,
                 start_batch: int = 0
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """An epoch of global batches in the order a seeded permutation
    gives. ``start_batch`` skips the first batches by index arithmetic:
    batch ``start_batch + n`` equals batch ``start_batch + n`` of a fresh
    epoch, and no skipped sample is touched."""
    idx = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
    for i in range(start_batch * batch_size, end, batch_size):
        j = idx[i:i + batch_size]
        yield ds.x[j], ds.y[j]


def skip_batches(batches, n: int) -> Iterator:
    """Skip the first ``n`` batches of any iterable by consuming them.
    A stream that ends before ``n`` raises ``ValueError``: the resume
    cursor points past the data, so the dataset or the batch size changed
    since the checkpoint (a stream of exactly ``n`` is an epoch-end
    resume)."""
    it = iter(batches)
    for k in range(n):
        try:
            next(it)
        except StopIteration:
            raise ValueError(
                f"resume cursor skips {n} batches but the stream ended "
                f"after {k} — dataset or batch size changed since the "
                "checkpoint was written?") from None
    return it


def load_hf_dataset(path: str, split: str = "train"):
    """A Hugging Face ``save_to_disk`` directory or one ``.arrow`` file ->
    a ``datasets.Dataset`` (the reference's CustomDataset).

    A directory goes through ``load_from_disk``; a DatasetDict gives its
    ``split`` (an unknown split raises ``ValueError`` listing the
    others). An ``.arrow`` file goes through ``Dataset.from_file``. The
    ``datasets`` package is optional and imported here: without it this
    raises a clear ``ImportError`` (the IDX/npz/CSV readers above need
    nothing)."""
    try:
        from datasets import Dataset, DatasetDict, load_from_disk
    except ImportError as e:
        raise ImportError(
            "load_hf_dataset needs the optional 'datasets' package; the "
            "built-in IDX/npz/CSV loaders work without it") from e

    if not os.path.exists(path):
        raise FileNotFoundError(f"dataset path does not exist: {path}")
    if os.path.isdir(path):
        ds = load_from_disk(path)
        if isinstance(ds, DatasetDict):
            if split not in ds:
                raise ValueError(f"split {split!r} not found; available: "
                                 f"{list(ds.keys())}")
            return ds[split]
        return ds
    if path.endswith(".arrow"):
        return Dataset.from_file(path)
    raise ValueError(
        f"unsupported dataset path {path!r}: expected a save_to_disk "
        "directory or a .arrow file")


def summarization_from_hf(path: str, tokenizer, *, split: str = "train",
                          max_length: int = 512,
                          article_col: str = "article",
                          summary_col: str = "highlights",
                          limit: Optional[int] = None
                          ) -> "SummarizationDataset":
    """A CNN/DailyMail-style HF dataset -> :class:`SummarizationDataset`
    (the first ``limit`` rows)."""
    ds = load_hf_dataset(path, split)
    n = min(limit, len(ds)) if limit is not None else len(ds)
    rows = []
    for i in range(n):
        row = ds[i]               # one Arrow row decoded per index
        rows.append((row[article_col], row[summary_col]))
    return SummarizationDataset(rows, tokenizer, max_length=max_length)


def mnist_from_hf(path: str, *, split: str = "train",
                  image_col: str = "image", label_col: str = "label"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """HF-format MNIST -> normalised ``(images [N, 28, 28, 1] f32, labels
    [N] int32)``, with :func:`load_mnist`'s mean and std. ``image_col``
    holds PIL images or nested lists/arrays."""
    ds = load_hf_dataset(path, split)
    imgs = np.stack([np.asarray(r[image_col], dtype=np.uint8) for r in ds])
    labels = np.asarray([r[label_col] for r in ds], dtype=np.int32)
    return _norm(imgs.reshape(len(imgs), 28, 28)), labels


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

    def eval_prompts(self, *, max_prompt_len: int, limit: Optional[int] = None
                     ) -> List[Tuple[List[int], str]]:
        """(prompt token ids, reference summary) pairs for the generation
        eval (``train/metrics.evaluate_generation``). Prompts are
        LEFT-truncated (the "...\n\nTL;DR: " tail kept) to at most
        ``max_prompt_len`` tokens and rounded DOWN to a multiple of 8 (so
        few distinct lengths batch together), as in the JAX package."""
        out = []
        for article, summary in self.rows[: limit or len(self.rows)]:
            ids = self.tok.encode(article + self.PROMPT)
            n = min(len(ids), max_prompt_len)
            n = max((n // 8) * 8, min(n, 8))
            out.append((ids[len(ids) - n:], summary))
        return out

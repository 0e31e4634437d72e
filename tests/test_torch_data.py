"""The port's datasets (quintnet_tpu_torch/data/datasets.py) against the
JAX package's, on the CPU: the same arrays and the same batch order,
exactly, from the same files and seeds; ``start_batch=k`` equals
skipping k batches."""

import gzip
import struct
from pathlib import Path

import numpy as np
import pytest

from quintnet_tpu.data import datasets as jd
from quintnet_tpu_torch.data import datasets as pd

FIXTURE = str(Path(__file__).resolve().parent / "fixtures" / "mnist")


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_mnist_fixture_equals_jax(split):
    x, y = pd.load_mnist(FIXTURE, split=split)
    jx, jy = jd.load_mnist(FIXTURE, split=split)
    assert x.shape[1:] == (28, 28, 1) and x.dtype == np.float32
    assert len(x) == (24 if split == "train" else 8)
    _assert_same(x, jx)
    _assert_same(y, jy)


def test_load_mnist_plain_idx_and_npz_equal_jax(tmp_path):
    """Uncompressed IDX files and an ``mnist.npz`` load like the JAX
    package's loader reads them."""
    raw = tmp_path / "idx"
    raw.mkdir()
    for name in pd.MNIST_FILES.values():
        with gzip.open(f"{FIXTURE}/{name}") as f:
            (raw / name[:-3]).write_bytes(f.read())
    for split in ("train", "test"):
        for a, b in zip(pd.load_mnist(str(raw), split=split),
                        jd.load_mnist(str(raw), split=split)):
            _assert_same(a, b)
    npz = tmp_path / "npz"
    npz.mkdir()
    imgs = pd._read_idx(f"{FIXTURE}/{pd.MNIST_FILES['train_images']}")
    lbls = pd._read_idx(f"{FIXTURE}/{pd.MNIST_FILES['train_labels']}")
    np.savez(npz / "mnist.npz", x_train=imgs, y_train=lbls,
             x_test=imgs[:5], y_test=lbls[:5])
    for split in ("train", "test"):
        for a, b in zip(pd.load_mnist(str(npz), split=split),
                        jd.load_mnist(str(npz), split=split)):
            _assert_same(a, b)


def test_read_idx_header():
    a = pd._read_idx(f"{FIXTURE}/{pd.MNIST_FILES['test_images']}")
    assert a.dtype == np.uint8 and a.shape == (8, 28, 28)
    with gzip.open(f"{FIXTURE}/{pd.MNIST_FILES['test_images']}") as f:
        magic, n = struct.unpack(">II", f.read(8))
    assert magic & 0xFF == 3 and n == 8


def test_load_mnist_falls_back_to_synthetic(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("QT_DATA_DIR", raising=False)
    for split, seed in (("train", 0), ("test", 1)):
        x, y = pd.load_mnist(str(tmp_path), split=split, synthetic_size=64)
        sx, sy = pd.synthetic_mnist(64, seed=seed)
        _assert_same(x, sx)
        _assert_same(y, sy)
    with pytest.raises(FileNotFoundError, match="MNIST not found"):
        pd.load_mnist(str(tmp_path), synthetic_ok=False)


def test_load_mnist_reads_qt_data_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QT_DATA_DIR", FIXTURE)
    x, _ = pd.load_mnist(split="test")
    _assert_same(x, jd.load_mnist(FIXTURE, split="test")[0])


@pytest.mark.parametrize("n,seed", [(50, 0), (17, 1), (300, 5)])
def test_synthetic_mnist_equals_jax(n, seed):
    for a, b in zip(pd.synthetic_mnist(n, seed=seed),
                    jd.synthetic_mnist(n, seed=seed)):
        _assert_same(a, b)


BATCH_CASES = {
    "shuffled": dict(seed=3),
    "shuffled_start_2": dict(seed=3, start_batch=2),
    "ordered": dict(shuffle=False),
    "keep_last": dict(seed=1, drop_last=False),
    "keep_last_start_4": dict(seed=1, drop_last=False, start_batch=4),
}


@pytest.mark.parametrize("name", sorted(BATCH_CASES))
def test_make_batches_equals_jax(name):
    x, y = pd.synthetic_mnist(45, seed=2)
    kw = BATCH_CASES[name]
    got = list(pd.make_batches(pd.ArrayDataset(x, y), 8, **kw))
    want = list(jd.make_batches(jd.ArrayDataset(x, y), 8, **kw))
    assert len(got) == len(want) > 0
    for (a, b), (c, d) in zip(got, want):
        _assert_same(a, c)
        _assert_same(b, d)


def _packed():
    rows = np.random.default_rng(0).integers(0, 200, (37, 16)).astype(
        np.int32)
    return pd.PackedLMDataset(rows)


def _summ():
    from quintnet_tpu_torch.data import ByteTokenizer

    return pd.SummarizationDataset.synthetic(37, ByteTokenizer(),
                                             max_length=48)


ITERATORS = {
    "make_batches": lambda **kw: pd.make_batches(
        pd.ArrayDataset(*pd.synthetic_mnist(37, seed=4)), 8, seed=6, **kw),
    "packed_lm": lambda **kw: _packed().batches(8, seed=6, **kw),
    "summarization": lambda **kw: _summ().batches(8, seed=6, **kw),
}


@pytest.mark.parametrize("k", [0, 1, 3, 4])
@pytest.mark.parametrize("name", sorted(ITERATORS))
def test_start_batch_equals_skipping(name, k):
    make = ITERATORS[name]
    a = list(make(start_batch=k))
    b = list(pd.skip_batches(make(), k))
    assert len(a) == len(b) == 4 - k
    for (x1, y1), (x2, y2) in zip(a, b):
        _assert_same(x1, x2)
        _assert_same(y1, y2)


def test_packed_and_summarization_batches_equal_jax():
    from quintnet_tpu.data.datasets import ByteTokenizer as JTok
    from quintnet_tpu_torch.data import ByteTokenizer

    rows = _packed().rows
    for kw in (dict(seed=2), dict(seed=2, start_batch=3)):
        for (a, b), (c, d) in zip(pd.PackedLMDataset(rows).batches(8, **kw),
                                  jd.PackedLMDataset(rows).batches(8, **kw)):
            _assert_same(a, c)
            _assert_same(b, d)
        got = pd.SummarizationDataset.synthetic(
            37, ByteTokenizer(), max_length=48).batches(8, **kw)
        want = jd.SummarizationDataset.synthetic(
            37, JTok(), max_length=48).batches(8, **kw)
        for (a, b), (c, d) in zip(got, want):
            _assert_same(a, c)
            _assert_same(b, d)


def test_skip_batches_past_the_end_raises():
    ds = pd.ArrayDataset(*pd.synthetic_mnist(24, seed=0))
    assert list(pd.skip_batches(pd.make_batches(ds, 8), 3)) == []
    with pytest.raises(ValueError, match="ended after 3"):
        pd.skip_batches(pd.make_batches(ds, 8), 5)

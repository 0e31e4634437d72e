"""The port's Hugging Face dataset readers (``data/datasets.py``:
``load_hf_dataset``, ``summarization_from_hf``, ``mnist_from_hf``) on
data built in ``tmp_path``: the cases of the JAX package's
``tests/test_data_hf.py``, and the bridges' arrays equal to the JAX
readers' on the same files, exactly. Needs the ``datasets`` package
(skipped without it).
"""

import glob

import numpy as np
import pytest

datasets = pytest.importorskip("datasets")

from quintnet_tpu.data.datasets import mnist_from_hf as jax_mnist_from_hf
from quintnet_tpu.data.datasets import \
    summarization_from_hf as jax_summarization_from_hf
from quintnet_tpu_torch.data.datasets import (ByteTokenizer, load_hf_dataset,
                                              mnist_from_hf,
                                              summarization_from_hf)


@pytest.fixture
def summ_dir(tmp_path):
    ds = datasets.DatasetDict({
        "train": datasets.Dataset.from_dict({
            "article": [f"article number {i} with several words"
                        for i in range(6)],
            "highlights": [f"summary {i}" for i in range(6)],
        }),
        "validation": datasets.Dataset.from_dict({
            "article": ["val article"], "highlights": ["val summary"],
        }),
    })
    p = tmp_path / "summ"
    ds.save_to_disk(str(p))
    return str(p)


def test_load_dir_with_splits(summ_dir):
    assert len(load_hf_dataset(summ_dir, "train")) == 6
    assert load_hf_dataset(summ_dir, "validation")[0]["article"] == \
        "val article"


def test_unknown_split_lists_available(summ_dir):
    with pytest.raises(ValueError, match="train"):
        load_hf_dataset(summ_dir, "test")


def test_load_single_dataset_dir(tmp_path):
    p = tmp_path / "single"
    datasets.Dataset.from_dict({"a": [1, 2, 3]}).save_to_disk(str(p))
    # a save without splits ignores the split
    assert len(load_hf_dataset(str(p), "train")) == 3


def test_load_bare_arrow_file(summ_dir):
    arrow = glob.glob(f"{summ_dir}/train/*.arrow")[0]
    assert len(load_hf_dataset(arrow)) == 6
    with pytest.raises(ValueError, match="unsupported dataset path"):
        load_hf_dataset(summ_dir + "/dataset_dict.json")


def test_missing_path_raises():
    with pytest.raises(FileNotFoundError):
        load_hf_dataset("/nonexistent/nowhere")


def test_summarization_bridge(summ_dir):
    """The prompt is masked to -100 and the summary supervised, and every
    batch equals the JAX reader's on the same directory."""
    sd = summarization_from_hf(summ_dir, ByteTokenizer(), max_length=64,
                               limit=4)
    assert len(sd) == 4
    ids, labels = next(sd.batches(2, shuffle=False))
    assert ids.shape == (2, 64) and labels.shape == (2, 64)
    assert (labels[0] == -100).any() and (labels[0] != -100).any()
    want = jax_summarization_from_hf(summ_dir, ByteTokenizer(),
                                     max_length=64, limit=4)
    assert sd.rows == want.rows
    for (a, b), (c, d) in zip(sd.batches(2, seed=1),
                              want.batches(2, seed=1)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_mnist_bridge(tmp_path):
    """Images normalised with ``load_mnist``'s mean and std, and equal to
    the JAX reader's arrays bit for bit."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (10, 28, 28), dtype=np.uint8)
    p = tmp_path / "mnist"
    datasets.Dataset.from_dict({"image": [im.tolist() for im in imgs],
                                "label": list(range(10))}
                               ).save_to_disk(str(p))
    x, y = mnist_from_hf(str(p))
    assert x.shape == (10, 28, 28, 1) and x.dtype == np.float32
    np.testing.assert_array_equal(y, np.arange(10))
    np.testing.assert_allclose(
        x[0, 0, 0, 0], (imgs[0, 0, 0] / 255.0 - 0.1307) / 0.3081, rtol=1e-5)
    jx, jy = jax_mnist_from_hf(str(p))
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert y.dtype == jy.dtype == np.int32

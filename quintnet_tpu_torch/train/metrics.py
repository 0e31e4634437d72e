"""Training metrics: accuracy and perplexity.

Port of the classification and language-model metrics of
``quintnet_tpu/train/metrics.py`` (ROUGE/BLEU and the generation eval
belong to the generation slice, ROADMAP.md §1 item 5).
"""

from __future__ import annotations

import torch

from quintnet_tpu_torch.models.gpt2 import perplexity

__all__ = ["accuracy", "perplexity"]


def accuracy(logits, labels):
    """Share of rows whose argmax over the last dim equals the label."""
    return (logits.argmax(dim=-1) == labels).float().mean()

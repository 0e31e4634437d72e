"""Host-side data for training (numpy batches)."""

from quintnet_tpu_torch.data.datasets import (ArrayDataset, ByteTokenizer,
                                              PackedLMDataset,
                                              SummarizationDataset,
                                              load_mnist, make_batches,
                                              pack_documents,
                                              segments_from_tokens,
                                              skip_batches, synthetic_mnist)

__all__ = ["ArrayDataset", "ByteTokenizer", "PackedLMDataset",
           "SummarizationDataset", "load_mnist", "make_batches",
           "pack_documents", "segments_from_tokens", "skip_batches",
           "synthetic_mnist"]

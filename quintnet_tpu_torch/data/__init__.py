"""Host-side data for training (numpy batches)."""

from quintnet_tpu_torch.data.datasets import (ByteTokenizer, PackedLMDataset,
                                              SummarizationDataset,
                                              pack_documents,
                                              segments_from_tokens)

__all__ = ["ByteTokenizer", "PackedLMDataset", "SummarizationDataset",
           "pack_documents", "segments_from_tokens"]

"""Command-line tools: the single-device verifier, the fault-tolerance
supervisor, the Hugging Face export and the perplexity evaluation."""

"""Model families (GPT-2)."""

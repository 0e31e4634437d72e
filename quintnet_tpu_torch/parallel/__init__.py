"""Training steps and the strategy facade (one device so far)."""

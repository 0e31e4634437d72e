"""Runnable examples of the port (``python -m quintnet_tpu_torch.examples.<name>``)."""

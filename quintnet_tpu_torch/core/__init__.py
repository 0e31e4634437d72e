"""Device resolution shared by every entry point of the port."""

from quintnet_tpu_torch.core.device import resolve_device

__all__ = ["resolve_device"]

"""Where the port's tensors live.

Every entry point takes ``device="cuda"`` by default and resolves it
here. The CPU is used only when the caller passes ``device="cpu"`` (the
parity tests do); asking for CUDA on a machine without it raises
instead of quietly running somewhere else.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` / a ``torch.device`` ->
    the ``torch.device`` to use. Raises ``RuntimeError`` when CUDA is
    requested and ``torch.cuda.is_available()`` is False, and
    ``ValueError`` for device types the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not "
                f"available (torch {torch.__version__}, "
                f"torch.version.cuda={torch.version.cuda}); pass "
                f"device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(
        f"unsupported device {str(device)!r}: the port runs on 'cuda' "
        f"or, when asked explicitly, on 'cpu'")

"""Device choice for every entry point of the port.

The receiver runs on the card unless the caller asks for the CPU. A
request for CUDA on a machine without it raises: the port never falls
back to the CPU on its own, because a CPU run is a different result (the
plain PyTorch versions of the kernels) at a different speed.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises when
    CUDA is asked for and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

"""PyTorch/CUDA port of the GNSS-SDR-TPU receiver.

The package mirrors ``gnss_sdr_tpu`` module for module. Plain tensor code
is PyTorch; every device program of the receiver's main path is a kernel
written by hand for Hopper (``kernels/csrc``), with a plain PyTorch
version of the same computation beside it. Entry points take
``device=`` and default to ``"cuda"``; ``"cpu"`` runs the plain versions.
"""

__all__ = ["resolve_device"]

from gnss_sdr_tpu_torch.device import resolve_device  # noqa: E402

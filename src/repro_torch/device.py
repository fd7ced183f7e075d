"""The device the port runs on.

``default_device()`` is the card: the port's entry points run on CUDA
unless the caller passes ``device="cpu"`` (as the CPU tests do).  Without
a card it raises — it never falls back to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["default_device"]


def default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU (built for sm_90a, the H100) "
            "and torch.cuda.is_available() is False here; pass device='cpu' "
            "explicitly to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")

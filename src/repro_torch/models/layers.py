"""Dense layer helpers — the part of ``repro.models.layers`` the CNN needs."""
from __future__ import annotations

import torch

__all__ = ["max_pool_nhwc"]


def max_pool_nhwc(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """VALID k×k max-pool over the spatial axes of a (B, H, W, C) map.

    The dense oracle of the event-native pool (bitwise equal to it: max is
    exact), written as a window view and a max so that no library pooling
    operator stands in for the event kernels."""
    win = x.unfold(1, k, stride).unfold(2, k, stride)   # (B, OH, OW, C, k, k)
    return win.amax(dim=(-2, -1))

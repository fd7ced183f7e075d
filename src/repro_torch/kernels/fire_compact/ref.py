"""Plain PyTorch version of the fused fire kernel (B1) — port of
``repro.kernels.fire_compact.ref``."""
from __future__ import annotations

import torch

__all__ = ["fire_compact_ref"]


def fire_compact_ref(acc: torch.Tensor, *, blk_m: int, blk_k: int,
                     threshold: float = 0.0, magnitude: bool = False,
                     qscale: float | None = None):
    """(fired (M, K), occupancy (M/blk_m, K/blk_k) int32)."""
    live = acc.abs() > threshold if magnitude else acc > threshold
    fired = torch.where(live, acc, 0.0)
    if qscale:
        fired = torch.clamp(torch.round(fired / qscale), -128, 127) * qscale
    m, k = acc.shape
    occ = live.reshape(m // blk_m, blk_m, k // blk_k, blk_k).any(3).any(1)
    return fired, occ.to(torch.int32)

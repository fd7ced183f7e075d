"""Launcher of the hand-written CUDA fire kernel (B1, ``csrc/fire_compact.cu``).

Replaces ``repro.kernels.fire_compact.kernel.fire_compact_pallas``.  Takes
CUDA tensors only; the wrapper in ``ops.py`` counts launches and sends CPU
tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["fire_compact_cuda"]


def fire_compact_cuda(acc: torch.Tensor, *, blk_m: int, blk_k: int,
                      threshold: float = 0.0, magnitude: bool = False,
                      qscale: float | None = None):
    """(fired (M, K) f32, occupancy (M/blk_m, K/blk_k) int32)."""
    build.require_cuda(acc=acc)
    if acc.dtype != torch.float32:
        raise TypeError(f"fire_compact takes f32, got {acc.dtype}")
    m, k = acc.shape
    if m % blk_m or k % blk_k:
        raise ValueError(f"({m}, {k}) not a multiple of ({blk_m}, {blk_k})")
    if m == 0 or k == 0:
        raise ValueError("zero-extent fire: a launch with gridDim 0 is an "
                         "invalid configuration")
    fired = torch.empty_like(acc)
    occ = torch.empty((m // blk_m, k // blk_k), dtype=torch.int32,
                      device=acc.device)
    build.launch("mnf_fire_compact", acc, fired, occ, m, k, blk_m, blk_k,
                 float(threshold), int(magnitude),
                 float(qscale) if qscale else 0.0)
    return fired, occ

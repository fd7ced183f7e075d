"""Launcher of the hand-written CUDA event matmul (B2, ``csrc/event_matmul.cu``).

Replaces ``repro.kernels.event_matmul.kernel.event_matmul_pallas``.  Takes
CUDA tensors only; ``ops.py`` holds the counting wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["event_matmul_cuda"]


def event_matmul_cuda(a_vals: torch.Tensor, a_idx: torch.Tensor,
                      counts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (G, bm, N) = sum over live events of a_vals[g, e] @ W[a_idx[g, e]]."""
    build.require_cuda(a_vals=a_vals, a_idx=a_idx, counts=counts, w=w)
    g, e, bm, bk = a_vals.shape
    k, n = w.shape
    if a_vals.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"event_matmul takes f32 ({a_vals.dtype}, {w.dtype})")
    if a_idx.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("event addresses and counts must be int32")
    if a_idx.shape != (g, e) or counts.shape != (g,) or k % bk:
        raise ValueError(f"shapes a_vals {tuple(a_vals.shape)}, a_idx "
                         f"{tuple(a_idx.shape)}, counts {tuple(counts.shape)},"
                         f" w {tuple(w.shape)}")
    if g == 0 or n == 0 or e == 0:
        raise ValueError("zero-extent event matmul: a launch with gridDim 0 "
                         "is an invalid configuration")
    if bm > 32:
        raise ValueError(f"blk_m={bm} > 32 rows per CTA")
    out = torch.empty((g, bm, n), dtype=torch.float32, device=w.device)
    build.launch("mnf_event_matmul", a_vals, a_idx, counts, w, out, g, e, bm,
                 bk, n)
    return out

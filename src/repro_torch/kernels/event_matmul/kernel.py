"""Launchers of the hand-written CUDA event matmul (B2 and B5,
``csrc/event_matmul.cu``).

Replace ``repro.kernels.event_matmul.kernel.event_matmul_pallas`` and
``event_matmul_int8_pallas``.  Take CUDA tensors only; ``ops.py`` holds
the counting wrappers.  The C launcher picks the CTA shape from the
operands' shape: the FC one when G * bm <= 4, the per-tap conv one
otherwise (``csrc/event_matmul.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["event_matmul_cuda", "event_matmul_int8_cuda"]


def _out(a_vals, a_idx, counts, w, dtype) -> torch.Tensor:
    """Check the operands and allocate the (G, bm, N) f32 output."""
    g, e, bm, bk = a_vals.shape
    k, n = w.shape
    if a_vals.dtype != dtype or w.dtype != torch.float32:
        raise TypeError(f"event_matmul takes {dtype} tiles and f32 weights "
                        f"({a_vals.dtype}, {w.dtype})")
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
    if 64 * e >= 2**31 or 4096 * bk >= 2**31:
        raise ValueError(f"capacity {e} or blk_k {bk} too large for the "
                         f"kernel's int32 slot and row indices")
    return torch.empty((g, bm, n), dtype=torch.float32, device=w.device)


def event_matmul_cuda(a_vals: torch.Tensor, a_idx: torch.Tensor,
                      counts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (G, bm, N) = sum over live events of a_vals[g, e] @ W[a_idx[g, e]]."""
    build.require_cuda(a_vals=a_vals, a_idx=a_idx, counts=counts, w=w)
    out = _out(a_vals, a_idx, counts, w, torch.float32)
    g, e, bm, bk = a_vals.shape
    build.launch("mnf_event_matmul", a_vals, a_idx, counts, w, out, g, e, bm,
                 bk, w.shape[1])
    return out


def event_matmul_int8_cuda(a_vals: torch.Tensor, a_idx: torch.Tensor,
                           counts: torch.Tensor, scale: torch.Tensor,
                           zero_point: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """B5: as :func:`event_matmul_cuda` on int8 codes, each tile dequantized
    at load as (q - zero_point) * scale.  ``scale`` (f32) and
    ``zero_point`` (int32) are one-element device tensors: the kernel reads
    them, the host never does."""
    build.require_cuda(a_vals=a_vals, a_idx=a_idx, counts=counts,
                       scale=scale, zero_point=zero_point, w=w)
    if scale.dtype != torch.float32 or zero_point.dtype != torch.int32 \
            or scale.numel() != 1 or zero_point.numel() != 1:
        raise TypeError(f"scale must be one f32 and zero_point one int32 "
                        f"({scale.dtype} {tuple(scale.shape)}, "
                        f"{zero_point.dtype} {tuple(zero_point.shape)})")
    out = _out(a_vals, a_idx, counts, w, torch.int8)
    g, e, bm, bk = a_vals.shape
    build.launch("mnf_event_matmul_int8", a_vals, a_idx, counts, scale,
                 zero_point, w, out, g, e, bm, bk, w.shape[1])
    return out

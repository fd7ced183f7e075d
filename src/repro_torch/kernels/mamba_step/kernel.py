"""Launcher of the hand-written CUDA fire-gated Mamba step (B8,
``csrc/mamba_step.cu``).

Replaces ``repro.kernels.mamba_scan.step.mamba_step_events_pallas``.
Takes CUDA tensors only; ``ops.py`` holds the counting wrapper.  The kernel
derives the live DI-blocks from the events itself (``live_block_mask``'s
rule: slots below the count only), so the launch needs no mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["MAX_BLK_K", "mamba_step_cuda"]

#: Widest DI-block the launcher takes (a CTA holds a thread a channel of
#: each of its blocks, at most 1024 threads).
MAX_BLK_K = 256


def mamba_step_cuda(values: torch.Tensor, block_idx: torch.Tensor,
                    counts: torch.Tensor, da: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor, h: torch.Tensor,
                    *, nkb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, DI), h_new (B, DI, N)) of one gated step.  values (B, E, 1,
    blk_k) f32 events of the fired gate over ``nkb`` DI-blocks, block_idx
    (B, E) / counts (B,) int32, da and h (B, DI, N) f32, bmat and cmat
    (B, N) f32."""
    build.require_cuda(values=values, block_idx=block_idx, counts=counts,
                       da=da, bmat=bmat, cmat=cmat, h=h)
    b, e, bm, bk = values.shape
    _, di, n = h.shape
    if any(t.dtype != torch.float32 for t in (values, da, bmat, cmat, h)):
        raise TypeError("mamba_step takes f32 events, decay, B, C and state")
    if any(t.dtype != torch.int32 for t in (block_idx, counts)):
        raise TypeError("event addresses and counts must be int32")
    if bm != 1 or block_idx.shape != (b, e) or counts.shape != (b,) \
            or nkb * bk < di or da.shape != (b, di, n) \
            or any(t.shape != (b, n) for t in (bmat, cmat)):
        raise ValueError(f"shapes values {tuple(values.shape)}, block_idx "
                         f"{tuple(block_idx.shape)}, nkb {nkb}, da "
                         f"{tuple(da.shape)}, B {tuple(bmat.shape)}, state "
                         f"{tuple(h.shape)}")
    if b == 0 or di == 0 or n == 0 or e == 0:
        raise ValueError("zero-extent mamba step: a launch with gridDim 0 "
                         "is an invalid configuration")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535 rows of the launch grid")
    if bk > MAX_BLK_K:
        raise ValueError(f"DI-blocks of {bk} channels > {MAX_BLK_K}: a CTA "
                         f"holds a thread a channel of each of its blocks")
    y = torch.empty((b, di), dtype=torch.float32, device=h.device)
    h_new = torch.empty_like(h)
    build.launch("mnf_mamba_step", values, block_idx, counts, da, bmat, cmat,
                 h, y, h_new, b, e, di, n, bk, nkb)
    return y, h_new

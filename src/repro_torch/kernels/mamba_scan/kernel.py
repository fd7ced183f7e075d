"""Launcher of the hand-written CUDA selective scan (B10,
``csrc/mamba_scan.cu``).

Replaces ``repro.kernels.mamba_scan.kernel.mamba_scan_pallas``.  Takes
CUDA tensors only; ``ops.py`` holds the counting wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["MAX_N", "mamba_scan_cuda"]

#: Largest state width: a CTA holds at least one channel's N threads.
MAX_N = 1024


def mamba_scan_cuda(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                    h0: torch.Tensor | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, DI), h (B, DI, N)) of the scan.  da, dbx (B, T, DI, N)
    f32, c (B, T, N) f32, h0 (B, DI, N) f32 or None (zeros)."""
    tensors = dict(da=da, dbx=dbx, c=c) | ({} if h0 is None else
                                           dict(h0=h0))
    build.require_cuda(**tensors)
    if any(t.dtype != torch.float32 for t in tensors.values()):
        raise TypeError("mamba_scan takes f32 decay, increment, C and state")
    b, t, di, n = da.shape
    if dbx.shape != da.shape or c.shape != (b, t, n) \
            or (h0 is not None and h0.shape != (b, di, n)):
        raise ValueError(f"shapes da {tuple(da.shape)}, dbx "
                         f"{tuple(dbx.shape)}, c {tuple(c.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if b == 0 or t == 0 or di == 0 or n == 0:
        raise ValueError("zero-extent mamba scan: a launch with gridDim 0 "
                         "is an invalid configuration")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535 rows of the launch grid")
    if n > MAX_N:
        raise ValueError(f"state width {n} > {MAX_N} threads of a CTA")
    y = torch.empty((b, t, di), dtype=torch.float32, device=da.device)
    h = torch.empty((b, di, n), dtype=torch.float32, device=da.device)
    build.launch("mnf_mamba_scan", da, dbx, c, h0, y, h, b, t, di, n)
    return y, h

"""Launcher of the hand-written CUDA fused strip conv (B3, ``csrc/event_conv.cu``).

Replaces ``repro.kernels.event_conv.kernel.event_conv_pallas``.  Takes CUDA
tensors only; ``ops.py`` holds the counting wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["event_conv_cuda"]


def event_conv_cuda(a_vals: torch.Tensor, a_idx: torch.Tensor,
                    tap: torch.Tensor, shift: torch.Tensor, src: torch.Tensor,
                    cnt: torch.Tensor, ws: torch.Tensor, *, nkb: int,
                    row_stride: int = 1) -> torch.Tensor:
    """One launch for a whole strip conv layer -> (G_out, bm, N)."""
    build.require_cuda(a_vals=a_vals, a_idx=a_idx, tap=tap, shift=shift,
                       src=src, cnt=cnt, ws=ws)
    g_in, e, bm, bk = a_vals.shape
    g_out, t_n = src.shape
    rows, n = ws.shape
    if a_vals.dtype != torch.float32 or ws.dtype != torch.float32:
        raise TypeError(f"event_conv takes f32 ({a_vals.dtype}, {ws.dtype})")
    for name, t in dict(a_idx=a_idx, tap=tap, shift=shift, src=src,
                        cnt=cnt).items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if (a_idx.shape != (g_in, e) or cnt.shape != src.shape
            or tap.shape != (t_n,) or shift.shape != (t_n,)
            or rows % (nkb * bk)):
        raise ValueError(f"plan/weights do not match events "
                         f"{tuple(a_vals.shape)}: src {tuple(src.shape)}, "
                         f"ws {tuple(ws.shape)}, nkb {nkb}")
    if g_out == 0 or n == 0 or e == 0:
        raise ValueError("zero-extent strip conv: a launch with gridDim 0 "
                         "is an invalid configuration")
    if bm > 32:
        raise ValueError(f"blk_m={bm} > 32 rows per CTA")
    out = torch.empty((g_out, bm, n), dtype=torch.float32, device=ws.device)
    build.launch("mnf_event_conv", a_vals, a_idx, tap, shift, src, cnt, ws,
                 out, g_out, e, bm, bk, n, t_n, nkb, row_stride)
    return out

"""Launchers of the hand-written CUDA fused strip conv (B3 and B6,
``csrc/event_conv.cu``).

Replace ``repro.kernels.event_conv.kernel.event_conv_pallas`` and
``event_conv_int8_pallas``.  Take CUDA tensors only; ``ops.py`` holds the
counting wrappers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["event_conv_cuda", "event_conv_int8_cuda"]


def _out(a_vals, a_idx, tap, shift, src, cnt, ws, nkb, dtype):
    """Check the operands and allocate the (G_out, bm, N) f32 output."""
    g_in, e, bm, bk = a_vals.shape
    g_out, t_n = src.shape
    rows, n = ws.shape
    if a_vals.dtype != dtype or ws.dtype != torch.float32:
        raise TypeError(f"event_conv takes {dtype} tiles and f32 weights "
                        f"({a_vals.dtype}, {ws.dtype})")
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
    if bm != 8:
        raise ValueError(f"blk_m={bm}: the strip conv kernel takes 8-pixel "
                         f"strips only")
    if max(a_vals.numel(), ws.numel(), g_out * bm * n, src.numel()) >= 2**31:
        raise ValueError("the strip conv kernel indexes with 32-bit offsets: "
                         "tensors of 2**31 elements or more are refused")
    return torch.empty((g_out, bm, n), dtype=torch.float32, device=ws.device)


def event_conv_cuda(a_vals: torch.Tensor, a_idx: torch.Tensor,
                    tap: torch.Tensor, shift: torch.Tensor, src: torch.Tensor,
                    cnt: torch.Tensor, ws: torch.Tensor, *, nkb: int,
                    row_stride: int = 1) -> torch.Tensor:
    """One launch for a whole strip conv layer -> (G_out, bm, N)."""
    build.require_cuda(a_vals=a_vals, a_idx=a_idx, tap=tap, shift=shift,
                       src=src, cnt=cnt, ws=ws)
    out = _out(a_vals, a_idx, tap, shift, src, cnt, ws, nkb, torch.float32)
    g_in, e, bm, bk = a_vals.shape
    build.launch("mnf_event_conv", a_vals, a_idx, tap, shift, src, cnt, ws,
                 out, src.shape[0], e, bm, bk, ws.shape[1], src.shape[1],
                 nkb, row_stride)
    return out


def event_conv_int8_cuda(a_vals: torch.Tensor, a_idx: torch.Tensor,
                         tap: torch.Tensor, shift: torch.Tensor,
                         src: torch.Tensor, cnt: torch.Tensor,
                         scale: torch.Tensor, zero_point: torch.Tensor,
                         ws: torch.Tensor, *, nkb: int,
                         row_stride: int = 1) -> torch.Tensor:
    """B6: as :func:`event_conv_cuda` on int8 codes, each sourced row
    dequantized at load as (q - zero_point) * scale.  ``scale`` (f32) and
    ``zero_point`` (int32) are one-element device tensors."""
    build.require_cuda(a_vals=a_vals, a_idx=a_idx, tap=tap, shift=shift,
                       src=src, cnt=cnt, scale=scale, zero_point=zero_point,
                       ws=ws)
    if scale.dtype != torch.float32 or zero_point.dtype != torch.int32 \
            or scale.numel() != 1 or zero_point.numel() != 1:
        raise TypeError(f"scale must be one f32 and zero_point one int32 "
                        f"({scale.dtype} {tuple(scale.shape)}, "
                        f"{zero_point.dtype} {tuple(zero_point.shape)})")
    out = _out(a_vals, a_idx, tap, shift, src, cnt, ws, nkb, torch.int8)
    g_in, e, bm, bk = a_vals.shape
    build.launch("mnf_event_conv_int8", a_vals, a_idx, tap, shift, src, cnt,
                 scale, zero_point, ws, out, src.shape[0], e, bm, bk,
                 ws.shape[1], src.shape[1], nkb, row_stride)
    return out

"""Plain PyTorch version of the fused strip conv (B3, and B6) — port of
``repro.kernels.event_conv.ref``.

Walks the compacted subtap plan in order; each subtap gathers its source
strips, applies the exact affine row remap (out row i <- src row
stride·i + shift, exact 0 where no row maps), runs the plain event multiply
against its tap's weight slab and adds the result into the layer
accumulator — the per-tap path's ``acc = acc + tap`` order, so the result
is bitwise the per-tap path's (DESIGN.md §6).  ``event_conv_int8_ref`` is
B6's: it dequantizes the int8 codes first, then runs the same walk, so the
remap's unsourced rows are exact 0 whatever the zero point.
"""
from __future__ import annotations

import torch

from repro_torch.core.events import remap_rows
from repro_torch.core.quantize import QParams, dequantize
from repro_torch.kernels.event_matmul.ref import event_matmul_ref

__all__ = ["event_conv_int8_ref", "event_conv_ref"]


def event_conv_ref(a_vals: torch.Tensor, a_idx: torch.Tensor,
                   tap: torch.Tensor, shift: torch.Tensor, src: torch.Tensor,
                   cnt: torch.Tensor, ws: torch.Tensor, *, nkb: int,
                   row_stride: int = 1) -> torch.Tensor:
    """a_vals (G_in, E, bm, bk), a_idx (G_in, E), tap/shift (T,),
    src/cnt (G_out, T), ws (k·k·nkb·bk, N) -> (G_out, bm, N)."""
    g_in, e, bm, bk = a_vals.shape
    g_out, t_n = src.shape
    n = ws.shape[1]
    slabs = ws.reshape(-1, nkb * bk, n)
    acc = a_vals.new_zeros((g_out, bm, n))
    for t, (d, tp) in enumerate(zip(shift.tolist(), tap.tolist())):
        s = src[:, t].long()
        vals = remap_rows(a_vals[s], d, row_stride)
        acc = acc + event_matmul_ref(vals, a_idx[s], cnt[:, t], slabs[tp])
    return acc


def event_conv_int8_ref(a_vals: torch.Tensor, a_idx: torch.Tensor,
                        tap: torch.Tensor, shift: torch.Tensor,
                        src: torch.Tensor, cnt: torch.Tensor,
                        scale: torch.Tensor, zero_point: torch.Tensor,
                        ws: torch.Tensor, *, nkb: int,
                        row_stride: int = 1) -> torch.Tensor:
    """Plain version of B6: a_vals int8 codes, dequantized as
    ``(q - zero_point) * scale`` before the row remap."""
    vals = dequantize(a_vals, QParams(scale=scale, zero_point=zero_point))
    return event_conv_ref(vals, a_idx, tap, shift, src, cnt, ws, nkb=nkb,
                          row_stride=row_stride)

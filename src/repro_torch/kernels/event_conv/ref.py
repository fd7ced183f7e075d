"""Plain PyTorch version of the fused strip conv (B3) — port of
``repro.kernels.event_conv.ref``.

Walks the compacted subtap plan in order; each subtap gathers its source
strips, applies the exact affine row remap (out row i <- src row
stride·i + shift, exact 0 where no row maps), runs the plain event multiply
against its tap's weight slab and adds the result into the layer
accumulator — the per-tap path's ``acc = acc + tap`` order, so the result
is bitwise the per-tap path's (DESIGN.md §6).
"""
from __future__ import annotations

import torch

from repro_torch.core.events import remap_rows
from repro_torch.kernels.event_matmul.ref import event_matmul_ref

__all__ = ["event_conv_ref"]


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

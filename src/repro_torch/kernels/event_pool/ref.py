"""Plain PyTorch versions of the event max-pools (B4) — port of
``repro.kernels.event_pool.ref``, with the kernels' operands.

A segment max keyed by each event's K-block address, identity 0.  Fire
emits non-negative values and event-absent positions are exactly 0, so
either grid equals the dense max-pool of the fired map bit for bit.
Padded event slots and dead parts are masked to the identity before the
scatter-max.
"""
from __future__ import annotations

import torch

from repro_torch.core.events import remap_rows

__all__ = ["event_pool_ref", "event_pool_window_ref"]


def event_pool_ref(a_vals: torch.Tensor, a_idx: torch.Tensor,
                   row: torch.Tensor, src: torch.Tensor, cnt: torch.Tensor,
                   *, nkb: int) -> torch.Tensor:
    """Per-output-pixel grid: (P_out, nkb, bk), row ``row[p,t]`` of tile
    ``a_vals[src[p,t], e]`` max-accumulated at address ``a_idx``."""
    g_in, e, bm, bk = a_vals.shape
    p_n, t_n = src.shape
    dev = a_vals.device
    acc = a_vals.new_zeros((p_n * nkb, bk))
    slot = torch.arange(e, device=dev)
    base = torch.arange(p_n, device=dev)[:, None] * nkb
    for t in range(t_n):
        s = src[:, t].long()
        vals = a_vals[s[:, None], slot[None, :], row[:, t].long()[:, None]]
        vals = torch.where((slot[None, :] < cnt[:, t, None])[:, :, None],
                           vals, 0.0)                        # (P, E, bk)
        idx = (base + a_idx[s].long()).reshape(-1, 1).expand(-1, bk)
        acc.scatter_reduce_(0, idx, vals.reshape(-1, bk), reduce="amax")
    return acc.reshape(p_n, nkb, bk)


def event_pool_window_ref(a_vals: torch.Tensor, a_idx: torch.Tensor,
                          shift: torch.Tensor, src: torch.Tensor,
                          cnt: torch.Tensor, *, nkb: int,
                          row_stride: int) -> torch.Tensor:
    """Window-major grid over a strip stream: (G_out, bm, nkb, bk); each
    subtap's tile rows remap out row i <- src row stride·i + shift."""
    g_in, e, bm, bk = a_vals.shape
    g_out, t_n = src.shape
    dev = a_vals.device
    acc = a_vals.new_zeros((g_out * nkb, bm * bk))
    slot = torch.arange(e, device=dev)
    base = torch.arange(g_out, device=dev)[:, None] * nkb
    for t, d in enumerate(shift.tolist()):
        s = src[:, t].long()
        vals = remap_rows(a_vals[s], d, row_stride)
        vals = torch.where((slot[None, :] < cnt[:, t, None])[:, :, None, None],
                           vals, 0.0)                     # (G, E, bm, bk)
        idx = (base + a_idx[s].long()).reshape(-1, 1).expand(-1, bm * bk)
        acc.scatter_reduce_(0, idx, vals.reshape(-1, bm * bk), reduce="amax")
    return acc.reshape(g_out, nkb, bm, bk).permute(0, 2, 1, 3).contiguous()

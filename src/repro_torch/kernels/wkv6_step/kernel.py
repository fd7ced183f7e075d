"""Launcher of the hand-written CUDA fire-gated WKV6 step (B7,
``csrc/wkv6_step.cu``).

Replaces ``repro.kernels.wkv6.step.wkv6_step_events_pallas``.  Takes CUDA
tensors only; ``ops.py`` holds the counting wrapper.  The kernel derives
the live K-blocks from the events itself (``live_block_mask``'s rule:
slots below the count only), so the launch needs no mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["MAX_D", "wkv6_step_cuda"]

#: Widest row the launcher takes (the row buffer and the readout partials
#: live in 48 KB of shared memory).
MAX_D = 1024


def wkv6_step_cuda(values: torch.Tensor, block_idx: torch.Tensor,
                   counts: torch.Tensor, r: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s: torch.Tensor, *,
                   nkb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(o (G, D), s_new (G, D, D)) of one gated step.  values (G, E, 1,
    blk_k) f32 events of the fired key over ``nkb`` K-blocks, block_idx
    (G, E) / counts (G,) int32, r, v, w, u (G, D) f32, s (G, D, D) f32."""
    build.require_cuda(values=values, block_idx=block_idx, counts=counts,
                       r=r, v=v, w=w, u=u, s=s)
    g, e, bm, bk = values.shape
    _, d = r.shape
    if any(t.dtype != torch.float32 for t in (values, r, v, w, u, s)):
        raise TypeError("wkv6_step takes f32 events, rows and state")
    if any(t.dtype != torch.int32 for t in (block_idx, counts)):
        raise TypeError("event addresses and counts must be int32")
    if bm != 1 or block_idx.shape != (g, e) or counts.shape != (g,) \
            or nkb * bk < d \
            or any(t.shape != (g, d) for t in (v, w, u)) \
            or s.shape != (g, d, d):
        raise ValueError(f"shapes values {tuple(values.shape)}, block_idx "
                         f"{tuple(block_idx.shape)}, nkb {nkb}, rows "
                         f"{tuple(r.shape)}, state {tuple(s.shape)}")
    if g == 0 or d == 0 or e == 0:
        raise ValueError("zero-extent wkv6 step: a launch with gridDim 0 is "
                         "an invalid configuration")
    if d > MAX_D:
        raise ValueError(f"head_dim {d} > {MAX_D}: the row does not fit the "
                         f"kernel's shared memory")
    o = torch.empty((g, d), dtype=torch.float32, device=r.device)
    s_new = torch.empty_like(s)
    build.launch("mnf_wkv6_step", values, block_idx, counts, r, v, w, u, s,
                 o, s_new, g, e, d, bk, nkb)
    return o, s_new

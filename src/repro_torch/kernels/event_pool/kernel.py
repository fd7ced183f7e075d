"""Launchers of the hand-written CUDA event pools (B4, ``csrc/event_pool.cu``).

``event_pool_cuda`` replaces ``repro.kernels.event_pool.kernel.event_pool_pallas``
(per-output-pixel grid); ``event_pool_window_cuda`` replaces
``event_pool_window_pallas`` (window-major strip grid).  CUDA tensors only;
``ops.py`` holds the counting wrappers.
"""
from __future__ import annotations

import torch

from repro_torch.core.events import STRIP_W
from repro_torch.kernels import build

__all__ = ["event_pool_cuda", "event_pool_window_cuda"]


def _check(a_vals, a_idx, plan, src, cnt):
    build.require_cuda(a_vals=a_vals, a_idx=a_idx, plan=plan, src=src,
                       cnt=cnt)
    if a_vals.dtype != torch.float32:
        raise TypeError(f"event pool takes f32, got {a_vals.dtype}")
    for name, t in dict(a_idx=a_idx, plan=plan, src=src, cnt=cnt).items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    g_in, e = a_vals.shape[:2]
    if a_idx.shape != (g_in, e) or cnt.shape != src.shape:
        raise ValueError(f"plan does not match events {tuple(a_vals.shape)}")
    if src.shape[0] == 0 or e == 0:
        raise ValueError("zero-extent event pool: a launch with gridDim 0 "
                         "is an invalid configuration")


def event_pool_cuda(a_vals, a_idx, row, src, cnt, *, nkb: int
                    ) -> torch.Tensor:
    """Per-output-pixel segment max -> (P_out, nkb, bk)."""
    _check(a_vals, a_idx, row, src, cnt)
    g_in, e, bm, bk = a_vals.shape
    p_n, t_n = src.shape
    if row.shape != src.shape:
        raise ValueError(f"row {tuple(row.shape)} != src {tuple(src.shape)}")
    out = torch.empty((p_n, nkb, bk), dtype=torch.float32,
                      device=a_vals.device)
    build.launch("mnf_event_pool", a_vals, a_idx, row, src, cnt, out, p_n, e,
                 bm, bk, nkb, t_n)
    return out


def event_pool_window_cuda(a_vals, a_idx, shift, src, cnt, *, nkb: int,
                           row_stride: int) -> torch.Tensor:
    """Window-major segment max over a strip stream -> (G_out, 8, nkb, bk)."""
    _check(a_vals, a_idx, shift, src, cnt)
    g_in, e, bm, bk = a_vals.shape
    g_out, t_n = src.shape
    if bm != STRIP_W or shift.shape != (t_n,):
        raise ValueError(f"window pool wants strip tiles (bm={bm}) and a "
                         f"(T,) shift plan, got {tuple(shift.shape)}")
    out = torch.empty((g_out, bm, nkb, bk), dtype=torch.float32,
                      device=a_vals.device)
    build.launch("mnf_event_pool_window", a_vals, a_idx, shift, src, cnt, out,
                 g_out, e, bk, nkb, t_n, row_stride)
    return out

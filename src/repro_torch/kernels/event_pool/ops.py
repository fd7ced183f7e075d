"""Event-native max-pools of the event backends (B4, DESIGN.md §7).

``event_pool`` (per-output-pixel grid) and ``event_pool_window``
(window-major strip grid) wrap ``csrc/event_pool.cu``, which replaces
``repro.kernels.event_pool.kernel.event_pool_pallas`` and
``event_pool_window_pallas``: a CUDA tensor launches the kernel and counts
it (``kernels.note_launch``); a CPU tensor takes the plain version
(``ref.py``).  Bound on the card: bytes (live event tiles in, pooled rows
out).

``event_max_pool2d`` / ``event_max_pool2d_window`` pool a conv
``EventStream`` through the cached device plans and return the pooled
rows (B·OH·OW, C).
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import note_launch
from repro_torch.kernels.event_pool.kernel import (event_pool_cuda,
                                                   event_pool_window_cuda)
from repro_torch.kernels.event_pool.ref import (event_pool_ref,
                                                event_pool_window_ref)

__all__ = ["event_max_pool2d", "event_max_pool2d_window", "event_pool",
           "event_pool_window", "pool_inputs", "pool_window_inputs"]


def event_pool(a_vals, a_idx, row, src, cnt, *, nkb: int) -> torch.Tensor:
    """(P_out, nkb, bk) per-output-pixel segment max."""
    args = (a_vals, a_idx, row, src, cnt)
    if a_vals.device.type == "cpu":
        return event_pool_ref(*args, nkb=nkb)
    out = event_pool_cuda(*(t.contiguous() for t in args), nkb=nkb)
    note_launch(event_pool, args, dict(nkb=nkb))
    return out


event_pool.launches = 0
event_pool.capture = None


def event_pool_window(a_vals, a_idx, shift, src, cnt, *, nkb: int,
                      row_stride: int) -> torch.Tensor:
    """(G_out, 8, nkb, bk) window-major segment max."""
    args = (a_vals, a_idx, shift, src, cnt)
    if a_vals.device.type == "cpu":
        return event_pool_window_ref(*args, nkb=nkb, row_stride=row_stride)
    out = event_pool_window_cuda(*(t.contiguous() for t in args), nkb=nkb,
                                 row_stride=row_stride)
    note_launch(event_pool_window, args,
                dict(nkb=nkb, row_stride=row_stride))
    return out


event_pool_window.launches = 0
event_pool_window.capture = None


def pool_inputs(stream, k: int, stride: int) -> tuple:
    """(a_vals, a_idx, row, src, cnt) of the per-pixel pool of ``stream``."""
    bev = stream.events
    src, row, live = ev.device_plan(
        ev.pool_window_map, (tuple(stream.logical_shape), k, stride,
                             stream.blk_m), str(bev.values.device))
    cnt = torch.where(live, bev.counts[src.long()], 0).to(torch.int32)
    return bev.values, bev.block_idx, row, src, cnt


def pool_window_inputs(stream, k: int, stride: int) -> tuple:
    """(a_vals, a_idx, shift, src, cnt) of the window-major pool."""
    assert stream.blk_m == ev.STRIP_W, (stream.blk_m, "strip stream wanted")
    bev = stream.events
    src, live, shift, _ = ev.device_plan(
        ev.pool_strip_map, (tuple(stream.logical_shape), k, stride),
        str(bev.values.device))
    cnt = torch.where(live, bev.counts[src.long()], 0).to(torch.int32)
    return bev.values, bev.block_idx, shift, src, cnt


def event_max_pool2d(stream, k: int, stride: int) -> torch.Tensor:
    """Per-event segment-max pool of a conv stream -> (B·OH·OW, C)."""
    c = stream.logical_shape[-1]
    nkb = stream.events.num_k_blocks
    y = event_pool(*pool_inputs(stream, k, stride), nkb=nkb)
    return y.reshape(y.shape[0], -1)[:, :c]


def event_max_pool2d_window(stream, k: int, stride: int) -> torch.Tensor:
    """Window-major pool of a strip stream -> (B·OH·OW, C)."""
    c = stream.logical_shape[-1]
    nkb = stream.events.num_k_blocks
    y = event_pool_window(*pool_window_inputs(stream, k, stride), nkb=nkb,
                          row_stride=stride)
    return y.reshape(-1, nkb * stream.blk_k)[:, :c]

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
rows (B·OH·OW, C).  ``pool_plan`` and ``pool_window_plan`` are their
static launch accounting, the JAX package's numbers exactly.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import kernel_wrapper, note_launch
from repro_torch.kernels.event_conv.ops import live_slots
from repro_torch.kernels.event_pool.kernel import (event_pool_cuda,
                                                   event_pool_window_cuda)
from repro_torch.kernels.event_pool.ref import (event_pool_ref,
                                                event_pool_window_ref)

__all__ = ["event_max_pool2d", "event_max_pool2d_window", "event_pool",
           "event_pool_window", "pool_inputs", "pool_plan",
           "pool_window_inputs", "pool_window_plan", "pool_work"]


def pool_work(a_vals: torch.Tensor, cnt: torch.Tensor,
              out_elems: int) -> tuple[int, float]:
    """Bytes and operations of one B4a or B4b launch: each live event tile
    and its address read once (f32), the plan's counts, the ``out_elems``
    pooled values written; a max per element of each event a window
    reads."""
    _, e, bm, bk = a_vals.shape
    slots = int(live_slots(a_vals).sum())
    nbytes = slots * (bm * bk + 1) * 4 + out_elems * 4 + cnt.numel() * 8
    return nbytes, float(cnt.clamp(max=e).sum()) * bm * bk


def _pool_call_work(out, a_vals, a_idx, plan, src, cnt, **_):
    return pool_work(a_vals, cnt, out.numel())


@kernel_wrapper(_pool_call_work)
def event_pool(a_vals, a_idx, row, src, cnt, *, nkb: int) -> torch.Tensor:
    """(P_out, nkb, bk) per-output-pixel segment max."""
    args = (a_vals, a_idx, row, src, cnt)
    if a_vals.device.type == "cpu":
        return event_pool_ref(*args, nkb=nkb)
    out = event_pool_cuda(*(t.contiguous() for t in args), nkb=nkb)
    note_launch(event_pool, args, dict(nkb=nkb))
    return out


@kernel_wrapper(_pool_call_work)
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


def pool_plan(logical_shape: tuple, k: int, stride: int, *,
              nkb: int, capacity: int | None = None) -> dict:
    """Static launch accounting of one per-event pool layer against the
    dense pool: one launch; ``grid`` (output pixels, window taps, event
    slots) the kernel walks, ``event_grid`` its step count, ``dense_reads``
    what the dense pool touches (k·k·C a pooled pixel), ``out_rows`` the
    pooled pixels.  The grid is the same for pixel and strip inputs."""
    b, h, w, c = logical_shape
    oh = (h - k) // stride + 1
    ow = (w - k) // stride + 1
    e = nkb if capacity is None else min(capacity, nkb)
    p_out = b * oh * ow
    return dict(
        launches=1, window_taps=k * k,
        grid=(p_out, k * k, e),
        event_grid=p_out * k * k * e,
        dense_reads=p_out * k * k * c,
        out_rows=p_out)


def pool_window_plan(logical_shape: tuple, k: int, stride: int, *,
                     nkb: int, capacity: int | None = None) -> dict:
    """Launch accounting of the window-major grid against the per-event
    one: the grid walks (output strips, k·k·parts, event slots), a strip
    serving 8 pooled pixels a step while straddle ``parts`` multiply the
    taps; ``grid_reduction`` is the per-event grid's step count over
    this one's.  Asserts the stream geometry is window-eligible."""
    b, h, w, c = logical_shape
    reason = ev.pool_window_ineligible_reason(logical_shape, k, stride,
                                              ev.STRIP_W)
    assert reason is None, (logical_shape, k, stride, reason)
    oh = (h - k) // stride + 1
    ow = (w - k) // stride + 1
    e = nkb if capacity is None else min(capacity, nkb)
    parts = ((ev.STRIP_W - 1) * stride + k - 1) // ev.STRIP_W + 1
    g_out = b * oh * (ow // ev.STRIP_W)
    p_out = b * oh * ow
    return dict(
        launches=1, window_taps=k * k, parts=parts,
        grid=(g_out, k * k * parts, e),
        event_grid=g_out * k * k * parts * e,
        pixel_event_grid=p_out * k * k * e,
        grid_reduction=(p_out * k * k * e)
        / max(g_out * k * k * parts * e, 1),
        dense_reads=p_out * k * k * c,
        out_rows=p_out)

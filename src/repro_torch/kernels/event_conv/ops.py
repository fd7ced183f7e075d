"""The fused strip conv of the event backends (B3, and B6 on int8 codes).

``event_conv`` is the wrapper of ``csrc/event_conv.cu``, which replaces
``repro.kernels.event_conv.kernel.event_conv_pallas``, and
``event_conv_dequant`` the wrapper of its int8 entry, which replaces
``event_conv_int8_pallas``: a CUDA tensor launches the kernel and counts
it (``kernels.note_launch``); a CPU tensor takes the plain version
(``ref.py``).  Bound on the card: f32 FMA issue.

``fused_event_conv2d`` runs a whole conv layer from a strip-aligned conv
stream in one launch: it builds the cached ``strip_tap_map`` plan on the
device, the live counts per (output strip, subtap) and the tap-stacked
weights, then calls ``event_conv``, or ``event_conv_dequant`` when the
stream carries int8 codes (``stream.qparams``).  ``fused_conv_plan`` is
its static launch accounting (launches, subtaps, event grid against the
per-tap path), the JAX package's numbers exactly.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core.mnf_conv import conv_out_size
from repro_torch.kernels import note_launch
from repro_torch.kernels.event_conv.kernel import (event_conv_cuda,
                                                  event_conv_int8_cuda)
from repro_torch.kernels.event_conv.ref import (event_conv_int8_ref,
                                               event_conv_ref)

__all__ = ["event_conv", "event_conv_dequant", "fused_conv_plan",
           "fused_event_conv2d", "stacked_weights", "strip_conv_inputs"]


def event_conv(a_vals, a_idx, tap, shift, src, cnt, ws, *, nkb: int,
               row_stride: int = 1) -> torch.Tensor:
    """(G_out, bm, N): sum_t sum_{e<cnt} remap_t(a[src, e]) @ ws tile."""
    args = (a_vals, a_idx, tap, shift, src, cnt, ws)
    if a_vals.device.type == "cpu":
        return event_conv_ref(*args, nkb=nkb, row_stride=row_stride)
    out = event_conv_cuda(*(t.contiguous() for t in args), nkb=nkb,
                          row_stride=row_stride)
    note_launch(event_conv, args, dict(nkb=nkb, row_stride=row_stride))
    return out


event_conv.launches = 0
event_conv.capture = None


def event_conv_dequant(a_vals, a_idx, tap, shift, src, cnt, scale,
                       zero_point, ws, *, nkb: int,
                       row_stride: int = 1) -> torch.Tensor:
    """B6: :func:`event_conv` on int8 codes, each sourced row dequantized
    at load as (q - zero_point) * scale — bitwise B3 fed the dequantized
    tiles."""
    args = (a_vals, a_idx, tap, shift, src, cnt, scale, zero_point, ws)
    if a_vals.device.type == "cpu":
        return event_conv_int8_ref(*args, nkb=nkb, row_stride=row_stride)
    out = event_conv_int8_cuda(*(t.contiguous() for t in args), nkb=nkb,
                               row_stride=row_stride)
    note_launch(event_conv_dequant, args,
                dict(nkb=nkb, row_stride=row_stride))
    return out


event_conv_dequant.launches = 0
event_conv_dequant.capture = None


def stacked_weights(w: torch.Tensor, bk: int, nkb: int) -> torch.Tensor:
    """(K, K, CI, CO) -> (k·k·nkb·bk, CO): block row ``tap·nkb + kb`` is
    W[dy, dx] rows [kb·bk, (kb+1)·bk) (CI zero-padded to nkb·bk)."""
    k, k2, ci, co = w.shape
    assert k == k2, w.shape
    wf = ev.pad_to_block_multiple(w.reshape(k * k, ci, co), bk, 1)
    assert wf.shape[1] == nkb * bk, (wf.shape, nkb, bk)
    return wf.reshape(k * k * nkb * bk, co).contiguous()


def strip_conv_inputs(stream, w: torch.Tensor, *, stride: int,
                      padding: int) -> tuple:
    """The kernel's operands for one strip conv layer: (a_vals, a_idx,
    tap, shift, src, cnt, ws) and its ``nkb``."""
    b, h, wd, ci = stream.logical_shape
    k = w.shape[0]
    assert ci == w.shape[2], (stream.logical_shape, w.shape)
    assert stream.blk_m == ev.STRIP_W, stream.blk_m
    bev = stream.events
    nkb = bev.num_k_blocks
    src, live, shift, tap = ev.device_plan(
        ev.strip_tap_map, (tuple(stream.logical_shape), k, padding, stride),
        str(bev.values.device))
    cnt = torch.where(live, bev.counts[src.long()], 0).to(torch.int32)
    ws = stacked_weights(w, stream.blk_k, nkb)
    return (bev.values, bev.block_idx, tap, shift, src, cnt, ws), nkb


def fused_event_conv2d(stream, w: torch.Tensor, *, stride: int = 1,
                       padding: int = 0) -> torch.Tensor:
    """Strip-tiled fused-tap conv, one launch.  Returns (B·OY·OX, CO)."""
    b, h, wd, _ = stream.logical_shape
    k, co = w.shape[0], w.shape[-1]
    args, nkb = strip_conv_inputs(stream, w, stride=stride, padding=padding)
    if stream.qparams is None:
        y = event_conv(*args, nkb=nkb, row_stride=stride)
    else:
        qp = stream.qparams
        y = event_conv_dequant(*args[:6], qp.scale, qp.zero_point, args[6],
                               nkb=nkb, row_stride=stride)
    oy = conv_out_size(h, k, stride, padding)
    ox = conv_out_size(wd, k, stride, padding)
    return y.reshape(-1, co)[:b * oy * ox]


def fused_conv_plan(logical_shape: tuple, k: int, padding: int,
                    nkb: int, capacity: int | None = None,
                    stride: int = 1) -> dict:
    """Static launch accounting of one strip conv layer against the per-tap
    path: ``launches_fused`` (1) and ``launches_per_tap`` (k·k);
    ``grid_fused`` (output strips, subtaps, event slots) the kernel walks;
    ``subtaps`` the compacted subtap count it launches (dead straddle parts
    dropped at plan time), ``subtaps_worst`` the uncompacted
    ``strip_parts(stride)·k·k``, ``compaction`` their ratio; the event
    grids (row groups × event slots) each path consumes and their ratio;
    the row groups the per-tap path gathers (the fused path none)."""
    b, h, wd, _ = logical_shape
    e = nkb if capacity is None else min(capacity, nkb)
    oh = conv_out_size(h, k, stride, padding)
    ow = conv_out_size(wd, k, stride, padding)
    g_pix = b * h * wd
    g_strip = g_pix // ev.STRIP_W
    g_out = b * oh * (ow // ev.STRIP_W)
    subtaps, subtaps_worst = ev.strip_subtap_counts(k, padding, stride)
    return dict(
        launches_fused=1, launches_per_tap=k * k,
        grid_fused=(g_out, subtaps, e),
        subtaps=subtaps, subtaps_worst=subtaps_worst,
        compaction=subtaps / subtaps_worst,
        event_grid_strip=g_strip * e, event_grid_pixel=g_pix * e,
        grid_reduction=float(g_pix) / float(g_strip),
        gathered_groups_per_tap=k * k * b * oh * ow,
        gathered_groups_fused=0)

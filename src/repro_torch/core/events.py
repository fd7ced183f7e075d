"""Event encoding — the paper's §4 compressed-data-storage scheme, in PyTorch.

Port of ``repro.core.events`` (DESIGN.md §2, §6, §7, §12).  A block event is
one live (blk_m, blk_k) tile of an (M, K) activation matrix plus its direct
K-block address; :class:`BlockEvents` holds the compacted, padded event
lists of every row group.

Two kinds of code live here:

  * tensor functions (encode, decode, gathers, re-tile) — plain PyTorch on
    whatever device their inputs lie on;
  * static plans (strip conv, pools, re-tile offsets) — shape-derived numpy
    computed on the host; :func:`device_plan` caches each per shape and
    device, so a plan is built and moved to the device once.

Every integer array equals the JAX package's array for array, and every
``*_ineligible_reason`` message is verbatim.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = [
    "STRIP_CO_MIN", "STRIP_STRIDES", "STRIP_W", "BlockEvents",
    "ScalarEvents", "block_occupancy", "count_nonzero_events",
    "decode_block_events", "device_plan", "encode_block_events",
    "encode_scalar_events",
    "gather_row_groups", "gather_row_strips", "live_block_mask",
    "pad_to_block_multiple",
    "remap_rows",
    "pool_strip_map", "pool_window_ineligible_reason", "pool_window_map",
    "retile_block_events", "retile_fc_addr_offsets",
    "retile_ineligible_reason", "scalar_event_rows", "strip_eligible",
    "strip_ineligible_reason", "strip_parts", "strip_shift_live",
    "strip_subtap_counts", "strip_tap_map",
]

#: Pixels per row strip of the strip-aligned conv encoding (DESIGN.md §6).
STRIP_W = 8

#: Output-channel granule of the strip path (see the JAX package's note:
#: strip == per-tap stays bitwise only for whole groups of 8 channels).
STRIP_CO_MIN = 8

#: Strides the strip plan covers, each validated bitwise strip == per-tap.
STRIP_STRIDES = (1, 2, 4)


# ---------------------------------------------------------------------------
# Scalar events (the paper's Algorithm 1 / 2 inputs) and event counting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScalarEvents:
    """Padded list of scalar events of one feature map or activation vector.

    values:  (capacity,)       event values (0 in padding slots)
    indices: (capacity,) int32 flat position of each event (0 in padding)
    count:   () int32          live events (<= capacity)
    """

    values: torch.Tensor
    indices: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.values.shape[0]


def encode_scalar_events(x: torch.Tensor, capacity: int | None = None,
                         threshold: float = 0.0) -> ScalarEvents:
    """Compact the |x| > threshold entries of ``x`` into (value, address)
    events in ascending address order (the paper's raster event stream);
    ``capacity`` defaults to x.numel() (lossless)."""
    flat = x.reshape(-1)
    capacity = flat.shape[0] if capacity is None else capacity
    live = flat.abs() > threshold
    count = live.sum(dtype=torch.int32)
    order = torch.argsort((~live).to(torch.int32), stable=True)
    idx = order[:capacity].to(torch.int32)
    slot_live = torch.arange(idx.shape[0], dtype=torch.int32,
                             device=x.device) < count
    vals = torch.where(slot_live, flat[idx.long()], _zero(flat))
    idx = torch.where(slot_live, idx, torch.zeros_like(idx))
    return ScalarEvents(values=vals, indices=idx, count=count)


def count_nonzero_events(x: torch.Tensor,
                         threshold: float = 0.0) -> torch.Tensor:
    """Scalar events a tensor would fire (|x| > threshold), a 0-d int64
    tensor on its device (cost-model instrumentation)."""
    return (x.abs() > threshold).sum(dtype=torch.int64)


def block_occupancy(x: torch.Tensor, blk_k: int,
                    threshold: float = 0.0) -> torch.Tensor:
    """Per-K-block liveness: any |x| > threshold inside the block.
    x (..., K) -> bool (..., K // blk_k); K a multiple of blk_k."""
    *lead, k = x.shape
    assert k % blk_k == 0, f"K={k} not a multiple of blk_k={blk_k}"
    return (x.reshape(*lead, k // blk_k, blk_k).abs() > threshold).any(-1)


# ---------------------------------------------------------------------------
# Block events
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockEvents:
    """Compacted K-block events of a row-grouped (M, K) activation matrix.

    values:    (G, E, blk_m, blk_k)  live activation tiles (padding = 0),
                                     f32 values or int8 codes
    block_idx: (G, E) int32          direct weight-tile address of each
                                     event; padding repeats the last live
                                     address (all-empty groups point at 0)
    counts:    (G,) int32            live events per row group
    num_k_blocks: int                K // blk_k
    """

    values: torch.Tensor
    block_idx: torch.Tensor
    counts: torch.Tensor
    num_k_blocks: int

    @property
    def capacity(self) -> int:
        return self.block_idx.shape[-1]


def _zero(values: torch.Tensor) -> torch.Tensor:
    """A 0-d zero of ``values``' dtype: ``torch.where(mask, int8, 0.0)``
    would promote int8 codes to f32, so padding is zeroed with this."""
    return torch.zeros((), dtype=values.dtype, device=values.device)


def pad_to_block_multiple(x: torch.Tensor, block: int,
                          axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``block``."""
    rem = (-x.shape[axis]) % block
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _compact(live: torch.Tensor, capacity: int):
    """Stable live-first compaction of a (G, S) liveness mask.

    Returns (order (G, capacity) int64 — live slots first in ascending
    order, padding slots repeating the last live one — slot_live, counts).
    """
    counts = live.sum(-1, dtype=torch.int32)
    order = torch.argsort((~live).to(torch.int32), dim=-1, stable=True)
    order = order[:, :capacity]
    slot = torch.arange(capacity, device=live.device, dtype=torch.int32)
    slot_live = slot[None, :] < counts[:, None]
    last_live = (counts.long() - 1).clamp(0, max(capacity - 1, 0))
    gathered_last = torch.gather(order, 1, last_live[:, None])
    order = torch.where(slot_live, order, gathered_last)
    return order, slot_live, counts


def encode_block_events(a: torch.Tensor, *, blk_m: int, blk_k: int,
                        capacity: int | None = None, threshold: float = 0.0,
                        live: torch.Tensor | None = None) -> BlockEvents:
    """Encode an activation matrix a (M, K) into block events.

    A (blk_m, blk_k) tile is an event iff any |value| exceeds
    ``threshold``; live tiles compact in ascending K-block order (a stable
    argsort), padding slots repeat the last live address with zero values.
    ``live`` (G, K // blk_k) may hand in the tile liveness a fire kernel
    already computed (its occupancy output) instead of re-scanning ``a``.
    """
    m, k = a.shape
    assert m % blk_m == 0 and k % blk_k == 0, (m, k, blk_m, blk_k)
    g, nkb = m // blk_m, k // blk_k
    capacity = nkb if capacity is None else min(capacity, nkb)
    tiles = a.reshape(g, blk_m, nkb, blk_k).permute(0, 2, 1, 3)
    if live is None:
        live = (tiles.abs() > threshold).flatten(2).any(-1)
    else:
        assert live.shape == (g, nkb), (live.shape, g, nkb)
        live = live.bool()
    order, slot_live, counts = _compact(live, capacity)
    rows = torch.arange(g, device=a.device)[:, None]
    vals = tiles[rows, order]                               # (G, E, bm, bk)
    vals = torch.where(slot_live[:, :, None, None], vals, _zero(vals))
    return BlockEvents(values=vals, block_idx=order.to(torch.int32),
                       counts=counts, num_k_blocks=nkb)


def decode_block_events(ev: BlockEvents, *, blk_m: int, blk_k: int,
                        m: int, k: int) -> torch.Tensor:
    """Inverse of :func:`encode_block_events`: scatter tiles to (M, K)."""
    g, e = ev.block_idx.shape
    nkb = ev.num_k_blocks
    assert m == g * blk_m and k == nkb * blk_k, (g, nkb, m, k)
    dense = ev.values.new_zeros((g, nkb, blk_m, blk_k))
    slot = torch.arange(e, device=ev.counts.device)
    slot_live = slot[None, :] < ev.counts[:, None]
    vals = torch.where(slot_live[:, :, None, None], ev.values,
                       _zero(ev.values))
    rows = torch.arange(g, device=dense.device)[:, None].expand(g, e)
    dense.index_put_((rows.reshape(-1), ev.block_idx.reshape(-1).long()),
                     vals.reshape(g * e, blk_m, blk_k), accumulate=True)
    return dense.permute(0, 2, 1, 3).reshape(m, k)


def gather_row_groups(bev: BlockEvents, idx: torch.Tensor,
                      live: torch.Tensor) -> BlockEvents:
    """Re-index row groups — the event-domain image of a row gather.

    idx (G',) source row group per output group; live (G',) bool, False
    for groups with no source (a conv tap in the zero-padding border) whose
    counts are zeroed.
    """
    idx = idx.long()
    counts = torch.where(live, bev.counts[idx], 0).to(torch.int32)
    return BlockEvents(values=bev.values[idx], block_idx=bev.block_idx[idx],
                       counts=counts, num_k_blocks=bev.num_k_blocks)


def remap_rows(values: torch.Tensor, shift: int,
               row_stride: int = 1) -> torch.Tensor:
    """The in-tile affine row map of the strip plans on (..., bm, bk) tiles:
    out row i <- src row ``row_stride*i + shift``, exact 0 where that row
    leaves the tile.  A gather and a mask — values move bit-identically."""
    bm = values.shape[-2]
    rows = row_stride * torch.arange(bm, device=values.device) + shift
    ok = ((rows >= 0) & (rows < bm))[:, None]
    return torch.where(ok, values[..., rows.clamp(0, bm - 1), :],
                       _zero(values))


def gather_row_strips(bev: BlockEvents, idx: torch.Tensor, live: torch.Tensor,
                      shift: int, row_stride: int = 1) -> BlockEvents:
    """Tap-shifted strip gather: :func:`gather_row_groups`, then
    :func:`remap_rows`.  A subtap that sources no row carries no events."""
    g = gather_row_groups(bev, idx, live)
    if row_stride == 1 and shift == 0:
        return g
    if not strip_shift_live(shift, row_stride):
        return dataclasses.replace(g, values=torch.zeros_like(g.values),
                                   counts=torch.zeros_like(g.counts))
    return dataclasses.replace(g, values=remap_rows(g.values, shift,
                                                    row_stride))


def scalar_event_rows(bev: BlockEvents) -> torch.Tensor:
    """Per-row non-zero activation counts, (G * blk_m,) f32, twin-free."""
    g, e, bm, bk = bev.values.shape
    slot = torch.arange(e, device=bev.counts.device)
    slot_live = slot[None, :] < bev.counts[:, None]
    nz = (bev.values != 0) & slot_live[:, :, None, None]
    return nz.sum(dim=(1, 3), dtype=torch.float32).reshape(g * bm)


def live_block_mask(bev: BlockEvents) -> torch.Tensor:
    """Per-K-block liveness of an event set, (G, num_k_blocks) bool.

    The compacted slots scattered back onto the block grid.  Padding slots
    repeat the last live block index, so they are masked out before the
    scatter: a dead block stays dead even when a padding slot points at
    it.  The skip mask of the fire-gated recurrent step (DESIGN.md §13).
    """
    g, e = bev.block_idx.shape
    mask = torch.zeros((g, bev.num_k_blocks), dtype=torch.int32,
                       device=bev.counts.device)
    if g == 0 or bev.num_k_blocks == 0:
        return mask > 0
    slot = torch.arange(e, device=bev.counts.device, dtype=torch.int32)
    slot_live = (slot[None, :] < bev.counts[:, None]).to(torch.int32)
    mask.scatter_add_(1, bev.block_idx.long(), slot_live)
    return mask > 0


# ---------------------------------------------------------------------------
# Static plans: host numpy, cached per shape, moved to a device once
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def device_plan(plan, args: tuple, device: str) -> tuple:
    """The arrays of ``plan(*args)`` as tensors on ``device``, built once
    per (plan, shape, device) — a plan is shape-derived, so every forward
    at one shape reuses the same device copies (never written to)."""
    out = plan(*args)
    if isinstance(out, np.ndarray):
        out = (out,)
    return tuple(torch.from_numpy(a).to(device) for a in out)


def strip_parts(stride: int) -> int:
    """Worst-case straddle parts per tap at ``stride``."""
    return ((STRIP_W - 1) * stride + STRIP_W - 1) // STRIP_W + 1


def strip_shift_live(shift: int, stride: int) -> bool:
    """True iff ``out row i <- src row stride*i + shift`` sources a row."""
    return any(0 <= stride * i + shift < STRIP_W for i in range(STRIP_W))


def strip_subtap_counts(k: int, padding: int, stride: int) -> tuple[int, int]:
    """(compacted, worst-case) subtap column counts of a strip conv plan."""
    parts = strip_parts(stride)
    live = 0
    for dx in range(k):
        r = (dx - padding) % STRIP_W
        live += sum(strip_shift_live(r - j * STRIP_W, stride)
                    for j in range(parts))
    return live * k, parts * k * k


def strip_ineligible_reason(width: int, k: int, stride: int, padding: int,
                            co: int | None = None) -> str | None:
    """Why a conv layer cannot consume a strip-aligned stream (None = it
    can).  Messages are verbatim those of the JAX package."""
    if stride not in STRIP_STRIDES:
        return (f"stride {stride} not in {set(STRIP_STRIDES)} (strip plans "
                f"gather up to (7*stride + 7)//8 + 1 interleaved straddle "
                f"parts per tap; only these strides are validated bitwise)")
    out_w = (width + 2 * padding - k) // stride + 1
    if width <= 0 or width % STRIP_W:
        return f"input width {width} not a multiple of STRIP_W={STRIP_W}"
    if out_w <= 0 or out_w % STRIP_W:
        return (f"output width {out_w} ((W + 2p - k)//stride + 1) not a "
                f"multiple of STRIP_W={STRIP_W}")
    if padding > k // 2:
        return (f"padding {padding} > k//2 = {k // 2}: the output map "
                f"outgrows the input and a tap shift can index outside the "
                f"planned straddle parts (strip plans pair each output "
                f"strip with its aligned input strips)")
    if padding > STRIP_W or k - 1 - padding > STRIP_W:
        return (f"tap x-offsets [-{padding}, {k - 1 - padding}] leave the "
                f"adjacent-strip window (|dx - p| <= {STRIP_W})")
    if co is not None and (co < STRIP_CO_MIN or co % STRIP_CO_MIN):
        return (f"output channels {co} not a multiple of "
                f"STRIP_CO_MIN={STRIP_CO_MIN} (bitwise contract needs an "
                f"M-invariant dot lowering — ragged lane remainders break it)")
    return None


def strip_eligible(width: int, k: int, stride: int, padding: int,
                   co: int | None = None) -> bool:
    return strip_ineligible_reason(width, k, stride, padding, co) is None


def strip_tap_map(logical_shape: tuple, k: int, padding: int,
                  stride: int = 1):
    """Compacted subtap gather plan of the fused strip conv (DESIGN.md §6).

    Returns ``src`` (G_out, T) int32 source strip group, ``live`` (G_out, T)
    bool, ``shift`` (T,) int32 row offset d (out row i <- src row
    stride*i + d) and ``tap`` (T,) int32 flat filter index.  Subtaps run
    tap-major, surviving straddle parts left to right; parts that source
    no row are dropped.
    """
    b, h, w, _ = logical_shape
    assert stride in STRIP_STRIDES, (stride, "strip_ineligible_reason gates")
    assert w % STRIP_W == 0, (logical_shape, "strip encoding needs W % 8 == 0")
    assert padding <= k // 2, (k, padding, "strip_ineligible_reason gates")
    oh = (h + 2 * padding - k) // stride + 1
    ow = (w + 2 * padding - k) // stride + 1
    assert ow > 0 and ow % STRIP_W == 0, (logical_shape, k, padding, stride)
    nsx_in = w // STRIP_W
    nsx_out = ow // STRIP_W
    g_out = b * oh * nsx_out
    gidx = np.arange(g_out, dtype=np.int64)
    sx = gidx % nsx_out
    oy = (gidx // nsx_out) % oh
    bb = gidx // (nsx_out * oh)
    parts = strip_parts(stride)
    t_n, t_worst = strip_subtap_counts(k, padding, stride)
    src = np.zeros((g_out, t_n), np.int32)
    live = np.zeros((g_out, t_n), bool)
    shift = np.zeros((t_n,), np.int32)
    tap = np.zeros((t_n,), np.int32)
    t = 0
    for dy in range(k):
        for dx in range(k):
            iy = oy * stride + dy - padding
            s = dx - padding
            base = stride * sx + (s // STRIP_W)
            r = s % STRIP_W
            for j in range(parts):
                d = r - j * STRIP_W
                if not strip_shift_live(d, stride):
                    continue
                tx = base + j
                ok = (iy >= 0) & (iy < h) & (tx >= 0) & (tx < nsx_in)
                src[:, t] = ((bb * h + np.clip(iy, 0, h - 1)) * nsx_in
                             + np.clip(tx, 0, nsx_in - 1)).astype(np.int32)
                live[:, t] = ok
                shift[t] = d
                tap[t] = dy * k + dx
                t += 1
    assert t == t_n <= t_worst, (t, t_n, t_worst)
    return src, live, shift, tap


def pool_window_map(logical_shape: tuple, k: int, stride: int, blk_m: int):
    """Per-output-pixel window plan of the event max-pool (DESIGN.md §7):
    ``src`` (P_out, T) row group, ``row`` (P_out, T) row in its tile,
    ``live`` (P_out, T); T = k·k taps in (dy, dx) raster order."""
    b, h, w, _ = logical_shape
    assert k >= 1 and stride >= 1, (k, stride)
    assert h >= k and w >= k, (logical_shape, k, "VALID window exceeds map")
    if blk_m == STRIP_W:
        assert w % STRIP_W == 0, (logical_shape,
                                  "strip encoding needs W % 8 == 0")
    oh = (h - k) // stride + 1
    ow = (w - k) // stride + 1
    p_out = b * oh * ow
    pidx = np.arange(p_out, dtype=np.int64)
    ox = pidx % ow
    oy = (pidx // ow) % oh
    bb = pidx // (ow * oh)
    t_n = k * k
    src = np.zeros((p_out, t_n), np.int32)
    row = np.zeros((p_out, t_n), np.int32)
    live = np.zeros((p_out, t_n), bool)
    t = 0
    for dy in range(k):
        for dx in range(k):
            iy = oy * stride + dy
            ix = ox * stride + dx
            q = (bb * h + iy) * w + ix
            src[:, t] = (q // blk_m).astype(np.int32)
            row[:, t] = (q % blk_m).astype(np.int32)
            live[:, t] = (iy < h) & (ix < w)
            t += 1
    return src, row, live


def pool_window_ineligible_reason(logical_shape: tuple, k: int, stride: int,
                                  blk_m: int) -> str | None:
    """Why the window-major strip pool cannot consume this stream."""
    if blk_m != STRIP_W:
        return f"stream not strip-aligned (blk_m={blk_m} != STRIP_W)"
    b, h, w, _ = logical_shape
    if w <= 0 or w % STRIP_W:
        return f"input width {w} not a multiple of STRIP_W={STRIP_W}"
    if h < k or w < k:
        return f"VALID {k}x{k} window exceeds the {h}x{w} map"
    ow = (w - k) // stride + 1
    if ow <= 0 or ow % STRIP_W:
        return (f"pooled width {ow} ((W - k)//stride + 1) not a multiple "
                f"of STRIP_W={STRIP_W}")
    return None


def pool_strip_map(logical_shape: tuple, k: int, stride: int):
    """Window-major plan of the strip event pool (DESIGN.md §7): ``src``
    (G_out, T), ``live`` (G_out, T), ``shift`` (T,), ``tap`` (T,) with
    T = k·k·parts, tap-major then parts left to right."""
    b, h, w, _ = logical_shape
    reason = pool_window_ineligible_reason(logical_shape, k, stride, STRIP_W)
    assert reason is None, (logical_shape, k, stride, reason)
    oh = (h - k) // stride + 1
    ow = (w - k) // stride + 1
    nsx_in = w // STRIP_W
    nsx_out = ow // STRIP_W
    g_out = b * oh * nsx_out
    parts = ((STRIP_W - 1) * stride + k - 1) // STRIP_W + 1
    t_n = k * k * parts
    gidx = np.arange(g_out, dtype=np.int64)
    sx = gidx % nsx_out
    oy = (gidx // nsx_out) % oh
    bb = gidx // (nsx_out * oh)
    src = np.zeros((g_out, t_n), np.int32)
    live = np.zeros((g_out, t_n), bool)
    shift = np.zeros((t_n,), np.int32)
    tap = np.zeros((t_n,), np.int32)
    t = 0
    for dy in range(k):
        for dx in range(k):
            iy = oy * stride + dy
            for j in range(parts):
                tx = stride * sx + dx // STRIP_W + j
                d = dx % STRIP_W - j * STRIP_W
                ok = any(0 <= stride * i + d < STRIP_W
                         for i in range(STRIP_W))
                src[:, t] = ((bb * h + iy) * nsx_in
                             + np.clip(tx, 0, nsx_in - 1)).astype(np.int32)
                live[:, t] = ok & (tx >= 0) & (tx < nsx_in)
                shift[t] = d
                tap[t] = dy * k + dx
                t += 1
    return src, live, shift, tap


# ---------------------------------------------------------------------------
# Conv -> FC re-tiling (DESIGN.md §12)
# ---------------------------------------------------------------------------

def retile_ineligible_reason(logical_shape: tuple | None, blk_m: int,
                             blk_k: int) -> str | None:
    """Why a conv stream cannot re-tile to the FC view (None = it can)."""
    if logical_shape is None or len(logical_shape) != 4:
        return ("stream has no NHWC logical shape (not a conv stream; "
                "nothing to re-tile)")
    c = logical_shape[-1]
    if c % blk_k:
        return (f"channel depth {c} not a multiple of blk_k={blk_k} (the "
                f"conv encoding's K-padding columns would interleave into "
                f"the flattened FC row)")
    if blk_m not in (1, STRIP_W):
        return (f"row granularity blk_m={blk_m} is neither pixel (1) nor "
                f"strip (STRIP_W={STRIP_W})")
    return None


def retile_fc_addr_offsets(logical_shape: tuple, num_k_blocks: int,
                           capacity: int):
    """Static per-slot FC address offsets: off[s] = (s // capacity)·nkb."""
    _, h, w, _ = logical_shape
    slots = h * w * capacity
    off = (np.arange(slots, dtype=np.int64) // capacity) * num_k_blocks
    return off.astype(np.int32)


def retile_block_events(bev: BlockEvents, logical_shape: tuple,
                        blk_m: int) -> BlockEvents:
    """Re-tile a (B·H·W, C) conv block stream to the (B, H·W·C) FC view.

    Equals ``encode_block_events`` of the flattened dense twin at
    (blk_m=1, blk_k) array for array: strips split into per-pixel events
    (rows move, values do not), per-slot FC addresses come from the static
    offset plan, live slots compact live-first by stable argsort, padding
    repeats the last live address.  Values move by gather only.
    """
    b, h, w, c = logical_shape
    g, e, bm, bk = bev.values.shape
    reason = retile_ineligible_reason(logical_shape, blk_m, bk)
    assert reason is None, reason
    assert bm == blk_m and g * blk_m == b * h * w, (bev.values.shape,
                                                   logical_shape, blk_m)
    nkb = bev.num_k_blocks
    vals, idx, counts = bev.values, bev.block_idx, bev.counts
    if blk_m != 1:
        vals = vals.permute(0, 2, 1, 3).reshape(g * bm, e, 1, bk)
        idx = idx.repeat_interleave(bm, dim=0)
        counts = counts.repeat_interleave(bm)
    slots = h * w * e
    (off,) = device_plan(retile_fc_addr_offsets,
                         (tuple(logical_shape), nkb, e), str(vals.device))
    addr = idx.reshape(b, slots) + off[None, :]
    slot = torch.arange(e, device=vals.device)
    in_count = (slot[None, :] < counts[:, None]).reshape(b, slots)
    live = in_count & (vals.reshape(b, slots, bk) != 0).any(-1)
    order, slot_live, counts_fc = _compact(live, slots)
    addr = torch.gather(addr, 1, order)
    rows = torch.arange(b, device=vals.device)[:, None]
    vals = vals.reshape(b, slots, 1, bk)[rows, order]
    vals = torch.where(slot_live[:, :, None, None], vals, _zero(vals))
    return BlockEvents(values=vals, block_idx=addr.to(torch.int32),
                       counts=counts_fc, num_k_blocks=h * w * nkb)

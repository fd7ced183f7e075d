"""EventStream — the inter-layer currency of the MNF pipeline (DESIGN.md §5),
port of ``repro.engine.stream``.

The ``BlockEvents`` of a fired (M, K) activation matrix plus the geometry
needed to consume them: conv feature maps ride the flattened (B·H·W, C)
view with their NHWC ``logical_shape``.  ``fired`` is the optional dense
twin, kept only where a consumer reads it for free.  ``qparams`` is set
when the event values are int8 codes (DESIGN.md §12).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import events as ev
from repro_torch.core.quantize import QParams, dequantize
from repro_torch.engine import trace

__all__ = ["EventStream"]


@dataclasses.dataclass(frozen=True)
class EventStream:
    """events: BlockEvents over the tile-padded matrix; fired: dense (M, K)
    twin or None; shape: logical (M, K); blk_m/blk_k: tile geometry;
    logical_shape: (B, H, W, C) for conv streams, None for FC streams;
    qparams: the quantization parameters of int8 event values (symmetric,
    zero point 0, so an absent event is an exact zero in both domains; the
    kept twin is the dequantized f32 map), None for f32 streams;
    signed: the fire rule can emit negative events."""

    events: ev.BlockEvents
    fired: torch.Tensor | None
    shape: tuple
    blk_m: int
    blk_k: int
    logical_shape: tuple | None = None
    qparams: QParams | None = None
    signed: bool = False

    # -- construction -------------------------------------------------------

    @classmethod
    def empty(cls, shape: tuple, *, blk_m: int, blk_k: int,
              capacity: int | None = None, fired: torch.Tensor | None = None,
              dtype=torch.float32, device=None,
              logical_shape: tuple | None = None) -> "EventStream":
        """An explicitly event-free stream for a degenerate (M, K) shape —
        built without the encode machinery so no kernel sees a 0-extent
        launch."""
        m, k = shape
        g = -(-m // blk_m) if m > 0 else 0
        nkb = -(-k // blk_k) if k > 0 else 0
        cap = nkb if capacity is None else min(capacity, nkb)
        cap = max(cap, 1) if nkb > 0 else 1
        if device is None and fired is not None:
            device = fired.device
        bev = ev.BlockEvents(
            values=torch.zeros((g, cap, blk_m, blk_k), dtype=dtype,
                               device=device),
            block_idx=torch.zeros((g, cap), dtype=torch.int32, device=device),
            counts=torch.zeros((g,), dtype=torch.int32, device=device),
            num_k_blocks=nkb)
        return cls(events=bev, fired=fired, shape=(m, k), blk_m=blk_m,
                   blk_k=blk_k, logical_shape=logical_shape)

    @classmethod
    def encode(cls, x: torch.Tensor, *, blk_m: int, blk_k: int,
               capacity: int | None = None, threshold: float = 0.0,
               keep_dense: bool = True) -> "EventStream":
        """Encode a dense (M, K) activation matrix (f32 values or int8
        codes; the events keep ``x``'s dtype)."""
        m, k = x.shape
        if m == 0 or k == 0:
            return cls.empty((m, k), blk_m=blk_m, blk_k=blk_k,
                             capacity=capacity, dtype=x.dtype,
                             device=x.device,
                             fired=x if keep_dense else None)
        xp = ev.pad_to_block_multiple(x, blk_m, 0)
        xp = ev.pad_to_block_multiple(xp, blk_k, 1)
        bev = ev.encode_block_events(xp, blk_m=blk_m, blk_k=blk_k,
                                     capacity=capacity, threshold=threshold)
        return cls(events=bev, fired=x if keep_dense else None,
                   shape=(m, k), blk_m=blk_m, blk_k=blk_k)

    @classmethod
    def encode_nhwc(cls, x: torch.Tensor, *, blk_k: int, blk_m: int = 1,
                    capacity: int | None = None, threshold: float = 0.0,
                    keep_dense: bool = True) -> "EventStream":
        """Encode a dense (B, H, W, C) map: pixel rows (blk_m 1) or 8-pixel
        strips (blk_m STRIP_W, W % 8 == 0)."""
        b, h, w, c = x.shape
        assert blk_m == 1 or (blk_m == ev.STRIP_W and w % ev.STRIP_W == 0), \
            (blk_m, tuple(x.shape), "strip encoding needs blk_m == STRIP_W "
             "and W % STRIP_W == 0")
        s = cls.encode(x.reshape(b * h * w, c), blk_m=blk_m,
                       blk_k=min(blk_k, max(c, 1)), capacity=capacity,
                       threshold=threshold, keep_dense=keep_dense)
        return dataclasses.replace(s, logical_shape=(b, h, w, c))

    # -- views --------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.events.values.device

    def per_row_scalar_events(self) -> torch.Tensor:
        """Non-zero activations per logical row, (M,) f32, twin-free."""
        return ev.scalar_event_rows(self.events)[:self.shape[0]]

    @property
    def num_events(self) -> torch.Tensor:
        """Total live block events (the quantity the cost model prices), a
        0-d int64 tensor on the stream's device."""
        return self.events.counts.sum()

    def occupancy(self) -> torch.Tensor:
        """Live fraction of the (row group x K-block) event grid, 0-d f32;
        0.0 for a degenerate stream (an empty grid), not 0/0."""
        denom = self.events.block_idx.shape[0] * self.events.num_k_blocks
        if denom == 0:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        return self.num_events / denom

    @property
    def num_scalar_events(self) -> torch.Tensor:
        """Total non-zero activations (the paper's event count), a 0-d f32
        tensor on the stream's device, twin-free."""
        return self.per_row_scalar_events().sum()

    def dense(self) -> torch.Tensor:
        """Dense (M, K) view: the kept twin, else a decode visible to
        ``trace_dispatch``."""
        if self.fired is not None:
            return self.fired
        trace.record(op="stream.dense", decode=True, shape=self.shape)
        m, k = self.shape
        g = self.events.block_idx.shape[0]
        y = ev.decode_block_events(self.events, blk_m=self.blk_m,
                                   blk_k=self.blk_k, m=g * self.blk_m,
                                   k=self.events.num_k_blocks * self.blk_k)
        if self.qparams is not None:
            y = dequantize(y, self.qparams)
        return y[:m, :k]

    def dense_nhwc(self) -> torch.Tensor:
        """Dense (B, H, W, C) view of a conv stream."""
        assert self.logical_shape is not None and \
            len(self.logical_shape) == 4, self.logical_shape
        return self.dense().reshape(self.logical_shape)

    # -- transforms ---------------------------------------------------------

    def retile_fc(self) -> "EventStream":
        """Re-tile a conv stream to the flattened (B, H·W·C) FC view by
        static address plan (DESIGN.md §12) — no decode; values (f32 or
        int8 codes) move by gather only, the twin and ``qparams`` ride
        along."""
        reason = ev.retile_ineligible_reason(self.logical_shape, self.blk_m,
                                             self.blk_k)
        assert reason is None, reason
        b, h, w, c = self.logical_shape
        bev = ev.retile_block_events(self.events, self.logical_shape,
                                     self.blk_m)
        fired = None if self.fired is None else self.fired.reshape(b, -1)
        return EventStream(events=bev, fired=fired, shape=(b, h * w * c),
                           blk_m=1, blk_k=self.blk_k, logical_shape=None,
                           qparams=self.qparams, signed=self.signed)

    def dequantize_events(self) -> "EventStream":
        """Dequantize int8 event values in place — still event-domain: a
        per-tile scalar multiply (zero stays zero, padding slots stay exact
        zeros), not a decode, so a consumer that wants f32 values (the
        pool's segment max) reads the floats the kept twin carries,
        bitwise.  No-op on f32 streams."""
        if self.qparams is None:
            return self
        vals = dequantize(self.events.values, self.qparams)
        bev = dataclasses.replace(self.events, values=vals)
        return dataclasses.replace(self, events=bev, qparams=None)

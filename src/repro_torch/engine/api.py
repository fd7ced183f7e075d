"""Engine front-door ops (DESIGN.md §3) — port of ``repro.engine.api``.

Every op takes an :class:`EngineConfig`, resolves the backend from the
device of its operands, and dispatches through the registry.  ``linear``,
``conv2d`` and ``maxpool2d`` also take an :class:`EventStream`, so
consecutive layers chain events with no decode and re-encode.  Zero-extent
operands short-circuit before any dispatch: no kernel sees a 0-extent
launch.  Every stream dispatch appends a trace record of the JAX package's
schema (``chained``, ``strip``, ``launches``, ``route``,
``fallback_decode``, ``est_*_cost`` ...).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import events as ev
from repro_torch.core import quantize as qz
from repro_torch.core.fire import FireConfig
from repro_torch.core.fire import fire as plain_fire
from repro_torch.core.mnf_conv import conv_out_size
from repro_torch.costmodel import crossover as xover
from repro_torch.device import default_device
from repro_torch.engine import trace
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.registry import dispatch, get_backend, list_backends
from repro_torch.engine.stream import EventStream
from repro_torch.kernels.event_matmul.ref import mask_dead_blocks
from repro_torch.kernels.mamba_step.ref import mamba_step_ref
from repro_torch.kernels.wkv6_step.ref import wkv6_step_ref

__all__ = ["matmul", "linear", "conv2d", "maxpool2d",
           "pool_ineligible_reason", "route_conv", "route_pool",
           "route_linear", "route_recurrent", "fire", "fire_conv",
           "fire_delta", "recurrent_ineligible_reason", "recurrent_step",
           "sparsify", "describe"]

_DEFAULT = EngineConfig()


def _resolve(cfg: EngineConfig, device) -> str:
    return cfg.resolve_backend(*([] if device is None else [device]))


# ---------------------------------------------------------------------------
# Boundary routing (DESIGN.md §11): one decision function per op kind, used
# by the dispatching op and by the model planner with the same inputs.
# ``device`` names where the stream lives (None: backend names only).
# ---------------------------------------------------------------------------

def route_conv(logical_shape: tuple, w_shape: tuple, cfg: EngineConfig, *,
               stride: int = 1, padding: int = 0, blk_m: int = 1,
               device=None) -> xover.RouteDecision:
    """Route a conv boundary consuming a stream of granularity ``blk_m``:
    strip streams can ride only the fused strip conv, pixel streams only
    the per-tap path."""
    name = _resolve(cfg, device)
    bsz, h, wd, ci = logical_shape
    kh, kw, _, co = w_shape
    if blk_m == ev.STRIP_W:
        event_route = "strip" if (
            ev.strip_eligible(wd, kh, stride, padding, co=co)
            and name in list_backends("conv2d_events_strip")) else None
    else:
        event_route = "pixel" if name in list_backends("conv2d_events") \
            else None
    oy = conv_out_size(h, kh, stride, padding)
    ox = conv_out_size(wd, kw, stride, padding)
    dec = xover.decide_route(
        cfg.route, "conv", occupancy=cfg.occupancy_hint,
        event_route=event_route,
        dense_macs=float(bsz * oy * ox * kh * kw * ci * co),
        avg_touched=(oy * ox * kh * kw) / max(bsz * h * wd, 1) * bsz,
        c_out=co, backend=name, shape_class=f"k{kh}s{stride}")
    if dec.is_event and dec.route != event_route:
        dec = dataclasses.replace(dec, route=event_route or "dense")
    return dec


def route_pool(logical_shape: tuple, k: int, stride: int,
               cfg: EngineConfig, *, blk_m: int = 1, eligible: bool = True,
               device=None) -> xover.RouteDecision:
    """Route a max-pool boundary: "window" (window-major strip grid) where
    the pooled width tiles into strips, else "pixel" (per-event segment
    max); ``eligible=False`` forces the visible dense fallback."""
    name = _resolve(cfg, device)
    b, h, w, c = logical_shape
    oh = max((h - k) // stride + 1, 0)
    ow = max((w - k) // stride + 1, 0)
    if not eligible:
        event_route = None
    elif (ev.pool_window_ineligible_reason(logical_shape, k, stride,
                                           blk_m) is None
          and name in list_backends("maxpool2d_events_window")
          and cfg.route != "pixel"):
        event_route = "window"
    else:
        event_route = "pixel"
    dec = xover.decide_route(
        cfg.route, "pool", occupancy=cfg.occupancy_hint,
        event_route=event_route, dense_macs=float(b * oh * ow * k * k * c),
        avg_touched=(oh * ow * k * k) / max(h * w, 1), c_out=c,
        backend=name, shape_class=f"k{k}s{stride}c{c}")
    if dec.is_event and dec.route != event_route:
        dec = dataclasses.replace(dec, route=event_route or "dense")
    return dec


def route_linear(m: int, k: int, n: int, cfg: EngineConfig, *,
                 eligible: bool = True, device=None) -> xover.RouteDecision:
    """Route an FC boundary consuming a fire stream (for a conv→FC seam,
    the flattened shape m = B, k = H·W·C)."""
    name = _resolve(cfg, device)
    event_route = "event" if (eligible and
                              name in list_backends("linear_events")) \
        else None
    dec = xover.decide_route(
        cfg.route, "linear", occupancy=cfg.occupancy_hint,
        event_route=event_route, dense_macs=float(m * k * n),
        avg_touched=1.0, c_out=n, backend=name,
        shape_class=xover.linear_shape_class(m, k, n))
    if dec.is_event and dec.route != event_route:
        dec = dataclasses.replace(dec, route=event_route or "dense")
    return dec


def route_recurrent(kind: str, g: int, d: int, n: int, cfg: EngineConfig, *,
                    eligible: bool = True,
                    device=None) -> xover.RouteDecision:
    """Route a fire-gated recurrent decode step: ``kind`` "wkv6" or
    "mamba", ``g`` the flattened rows, ``d`` the drive width, ``n`` the
    state's trailing width.  The dense step's work is decay + increment
    over the whole (G, D, N) state, 2·G·D·N MACs; ``eligible=False`` forces
    the visible dense fallback whatever the mode."""
    name = _resolve(cfg, device)
    event_route = "event" if (
        eligible and name in list_backends(f"recurrent_step_{kind}")) \
        else None
    dec = xover.decide_route(
        cfg.route, "recurrent", occupancy=cfg.occupancy_hint,
        event_route=event_route, dense_macs=float(2 * g * d * n),
        avg_touched=1.0, c_out=n, backend=name, shape_class=f"{kind}d{d}")
    if dec.is_event and dec.route != event_route:
        dec = dataclasses.replace(dec, route=event_route or "dense")
    return dec


def _route_fields(dec: xover.RouteDecision, shape_class: str) -> dict:
    return dict(route=dec.route, est_event_cost=dec.est_event_cost,
                est_dense_cost=dec.est_dense_cost, occupancy=dec.occupancy,
                route_source=dec.source, shape_class=shape_class)


def _is_conv_stream(x: EventStream) -> bool:
    return x.logical_shape is not None and len(x.logical_shape) == 4


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def matmul(a: torch.Tensor, w: torch.Tensor,
           cfg: EngineConfig = _DEFAULT) -> torch.Tensor:
    """y = a @ W.  a (M, K), w (K, N)."""
    return dispatch("matmul", cfg, a, w)(a, w, cfg)


def linear(x, w: torch.Tensor, b: torch.Tensor | None = None,
           cfg: EngineConfig = _DEFAULT) -> torch.Tensor:
    """y = x @ W (+ b); ``x`` dense (..., K) or an EventStream.  A conv
    stream re-tiles to the flattened (B, H·W·C) view first (DESIGN.md §12);
    a re-tile-ineligible one decodes visibly with the named rule."""
    if isinstance(x, EventStream):
        conv_stream = _is_conv_stream(x)
        if conv_stream and 0 in x.logical_shape:
            y = w.new_zeros((x.logical_shape[0], w.shape[-1]))
            return y if b is None else y + b
        if x.shape[0] == 0:
            y = w.new_zeros((0, w.shape[-1]))
            return y if b is None else y + b
        retile_reason = None
        retiled = False
        if conv_stream:
            retile_reason = ev.retile_ineligible_reason(
                x.logical_shape, x.blk_m, x.blk_k)
            if retile_reason is None:
                x = x.retile_fc()
                retiled = True
        if retile_reason is None:
            m, k = x.shape
        else:
            bsz, hh, ww, cc = x.logical_shape
            m, k = bsz, hh * ww * cc
        name = cfg.resolve_backend(x.device, w)
        dec = route_linear(m, k, w.shape[-1], cfg,
                           eligible=retile_reason is None, device=x.device)
        fields = _route_fields(dec,
                               xover.linear_shape_class(m, k, w.shape[-1]))
        if retiled:
            fields["retile"] = True
        if dec.is_event:
            trace.record(op="linear", backend=name, chained=True, **fields)
            return get_backend("linear_events", name)(x, w, b, cfg)
        if dec.source == "geometry":
            if retile_reason is not None:
                fields["reason"] = retile_reason
            trace.record(op="linear", backend=name, fallback_decode=True,
                         **fields)
        else:
            trace.record(op="linear", backend=name, routed_dense=True,
                         **fields)
        xd = x.dense_nhwc().reshape(m, k) if (conv_stream and not retiled) \
            else x.dense()
        return linear(xd, w, b, cfg)
    lead = x.shape[:-1]
    y = dispatch("linear", cfg, x, w)(x.reshape(-1, x.shape[-1]), w, b, cfg)
    return y.reshape(*lead, w.shape[-1])


def conv2d(x, w: torch.Tensor, b: torch.Tensor | None = None,
           cfg: EngineConfig = _DEFAULT, *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """2-D conv.  x (B, H, W, CI) dense or a conv EventStream, w (KH, KW,
    CI, CO).  A strip stream on a strip-eligible layer rides the fused
    strip conv (one launch per layer, DESIGN.md §6); a pixel stream the
    per-tap path; anything else decodes visibly."""
    if isinstance(x, EventStream):
        name = cfg.resolve_backend(x.device, w)
        conv_stream = _is_conv_stream(x)
        if conv_stream and x.shape[0] == 0:
            bsz, h, wd, _ = x.logical_shape
            y = w.new_zeros((bsz, conv_out_size(h, w.shape[0], stride,
                                                padding),
                             conv_out_size(wd, w.shape[1], stride, padding),
                             w.shape[-1]))
            return y if b is None else y + b
        k = w.shape[0]
        if conv_stream:
            dec = route_conv(x.logical_shape, tuple(w.shape), cfg,
                             stride=stride, padding=padding, blk_m=x.blk_m,
                             device=x.device)
            fields = _route_fields(dec, f"k{k}s{stride}")
            if dec.route == "strip":
                subtaps, worst = ev.strip_subtap_counts(k, padding, stride)
                trace.record(op="conv2d", backend=name, chained=True,
                             strip=True, launches=1, stride=stride,
                             subtaps=subtaps, subtaps_worst=worst,
                             compaction=subtaps / worst, **fields)
                return get_backend("conv2d_events_strip", name)(
                    x, w, b, cfg, stride, padding)
            if dec.route == "pixel":
                trace.record(op="conv2d", backend=name, chained=True,
                             launches=k * k, **fields)
                return get_backend("conv2d_events", name)(x, w, b, cfg,
                                                          stride, padding)
            if dec.source == "geometry":
                trace.record(op="conv2d", backend=name, fallback_decode=True,
                             strip=x.blk_m == ev.STRIP_W, **fields)
            else:
                trace.record(op="conv2d", backend=name, routed_dense=True,
                             **fields)
            x = x.dense_nhwc()
        else:
            dec = xover.decide_route(
                cfg.route, "conv", occupancy=cfg.occupancy_hint,
                event_route=None,
                dense_macs=float(x.shape[0] * x.shape[1] * w.shape[-1]),
                avg_touched=1.0, c_out=w.shape[-1], backend=name)
            trace.record(op="conv2d", backend=name, fallback_decode=True,
                         **_route_fields(dec, f"k{k}s{stride}"))
            x = x.dense()
    return dispatch("conv2d", cfg, x, w)(x, w, b, cfg, stride, padding)


def pool_ineligible_reason(x, k: int, stride: int | None = None,
                           cfg: EngineConfig = _DEFAULT) -> str | None:
    """Why ``maxpool2d`` cannot pool ``x`` (a stream or an NHWC shape) in
    the event domain (None = it can).  Messages as in the JAX package."""
    stride = k if stride is None else stride
    shape = x.logical_shape if isinstance(x, EventStream) else x
    if shape is None or len(shape) != 4:
        return "not a conv stream (no NHWC logical_shape)"
    b, h, w, c = shape
    if k < 1 or stride < 1:
        return f"degenerate window k={k}, stride={stride}"
    if h < k or w < k:
        return (f"VALID {k}x{k} window exceeds the {h}x{w} map "
                f"(no output pixels)")
    if cfg.magnitude:
        return ("magnitude fire can emit negative events; the segment max "
                "runs with identity 0 and needs a ReLU-family stream")
    if isinstance(x, EventStream) and x.signed:
        return ("stream carries signed event values (signed/magnitude "
                "fire); the segment max runs with identity 0 and needs a "
                "ReLU-family stream")
    name = _resolve(cfg, x.device if isinstance(x, EventStream) else None)
    if name not in list_backends("maxpool2d_events"):
        return f"backend {name!r} has no maxpool2d_events op"
    return None


def maxpool2d(x, k: int, stride: int | None = None,
              cfg: EngineConfig = _DEFAULT, *, keep_dense: bool = True):
    """VALID max-pool.  A conv stream pools in the event domain (segment
    max, bitwise the dense pool, DESIGN.md §7) and re-emits through the
    fire phase at ``cfg.blk_m`` granularity; a dense map returns the dense
    pooled map.  An int8 stream pools its dequantized values and re-encodes
    the pooled rows quantized under the incoming ``QParams`` — every pooled
    value is a dequantized code, so that recovers the codes exactly and
    pooling never recalibrates."""
    stride = k if stride is None else stride
    if isinstance(x, EventStream):
        qp_in = x.qparams
        x = x.dequantize_events()
        name = cfg.resolve_backend(x.device)
        reason = pool_ineligible_reason(x, k, stride, cfg)
        shape_ok = _is_conv_stream(x)
        if shape_ok:
            dec = route_pool(x.logical_shape, k, stride, cfg, blk_m=x.blk_m,
                             eligible=reason is None, device=x.device)
        else:
            dec = xover.decide_route(
                cfg.route, "pool", occupancy=cfg.occupancy_hint,
                event_route=None, dense_macs=float(x.shape[0] * x.shape[1]),
                avg_touched=1.0, c_out=x.shape[1], backend=name)
        fields = _route_fields(
            dec, f"k{k}s{stride}c{x.logical_shape[3]}" if shape_ok
            else f"k{k}s{stride}")
        if reason is None:
            b, h, w, c = x.logical_shape
            oh = (h - k) // stride + 1
            ow = (w - k) // stride + 1
            bm = cfg.blk_m if cfg.blk_m == 1 or (
                cfg.blk_m == ev.STRIP_W and ow % ev.STRIP_W == 0) else 1
            if x.shape[0] == 0:
                return EventStream.empty(
                    (b * oh * ow, c), blk_m=bm, blk_k=cfg.blk_k,
                    dtype=x.events.values.dtype, device=x.device,
                    logical_shape=(b, oh, ow, c))
            if dec.is_event:
                op_name = ("maxpool2d_events_window" if dec.route == "window"
                           else "maxpool2d_events")
                trace.record(op="maxpool2d", backend=name, chained=True,
                             pool_events=True, launches=1, **fields)
                rows = get_backend(op_name, name)(x, k, stride, cfg)
            else:
                trace.record(op="maxpool2d", backend=name, routed_dense=True,
                             **fields)
                rows = dispatch("maxpool2d", cfg, x.device)(
                    x.dense_nhwc(), k, stride, cfg).reshape(b * oh * ow, c)
            # Pooled values are already fired: fire at threshold 0 is the
            # identity re-emission at the consumer's granularity.
            if qp_in is None:
                return fire_conv(rows.reshape(b, oh, ow, c),
                                 cfg.replace(threshold=0.0,
                                             int8_events=False),
                                 keep_dense=keep_dense, blk_m=bm)
            q_rows = qz.quantize(rows, qp_in)
            s = EventStream.encode_nhwc(q_rows.reshape(b, oh, ow, c),
                                        blk_k=cfg.blk_k, blk_m=bm,
                                        capacity=cfg.capacity, threshold=0.0,
                                        keep_dense=False)
            return dataclasses.replace(
                s, fired=rows if keep_dense else None, qparams=qp_in)
        trace.record(op="maxpool2d", backend=name, fallback_decode=True,
                     reason=reason, **fields)
        x = x.dense_nhwc() if x.logical_shape is not None else x.dense()
    return dispatch("maxpool2d", cfg, x)(x, k, stride, cfg)


def _fire_int8(acc2: torch.Tensor, c2: EngineConfig, keep_dense: bool,
               logical_shape: tuple | None = None
               ) -> EventStream:
    """Int8 fire (DESIGN.md §12): threshold the accumulator, calibrate a
    symmetric QParams over the fired map (zero point 0: an absent event is
    an exact zero in both domains), quantize into it (the JAX package
    requantizes with unit input and weight scales, which multiplies by 1.0:
    the consumers dequantize at tile load, so accumulators carry real
    values), and encode the codes at threshold 0.  The kept
    twin is the dequantized map — exactly the fake-quant round trip's
    values, which makes the int8 chain bitwise its fake-quant twin.  Plain
    torch ops, as the JAX package lowers it: no fire kernel launches."""
    fired = plain_fire(acc2, FireConfig(threshold=c2.threshold,
                                        magnitude=c2.magnitude,
                                        signed=c2.signed))
    qp = qz.calibrate(fired, symmetric=True)
    q = qz.quantize(fired, qp)
    s = EventStream.encode(q, blk_m=c2.blk_m, blk_k=c2.blk_k,
                           capacity=c2.capacity, threshold=0.0,
                           keep_dense=False)
    return dataclasses.replace(
        s, fired=qz.dequantize(q, qp) if keep_dense else None, qparams=qp,
        logical_shape=logical_shape, signed=c2.magnitude or c2.signed)


def fire(acc: torch.Tensor, cfg: EngineConfig = _DEFAULT, *,
         keep_dense: bool = True) -> EventStream:
    """Fire phase: threshold ``acc`` (M, K) and emit the next layer's
    events; ``keep_dense=False`` drops the dense twin.  With
    ``cfg.int8_events`` the events carry int8 codes and their QParams."""
    c = cfg.for_width(*acc.shape)
    signed = cfg.magnitude or cfg.signed
    if 0 in acc.shape:
        s = EventStream.empty(tuple(acc.shape), blk_m=c.blk_m, blk_k=c.blk_k,
                              capacity=c.capacity, dtype=acc.dtype,
                              device=acc.device,
                              fired=acc if keep_dense else None)
        return dataclasses.replace(s, signed=signed)
    if cfg.int8_events:
        return _fire_int8(acc, c, keep_dense)
    fired, bev = dispatch("fire", cfg, acc)(acc, c)
    return EventStream(events=bev, fired=fired if keep_dense else None,
                       shape=tuple(acc.shape), blk_m=c.blk_m, blk_k=c.blk_k,
                       signed=signed)


def fire_conv(acc: torch.Tensor, cfg: EngineConfig = _DEFAULT, *,
              keep_dense: bool = True, blk_m: int = 1) -> EventStream:
    """Fire over a conv accumulator (B, OY, OX, CO) -> conv stream at pixel
    (blk_m 1) or strip (STRIP_W, OX % 8 == 0) granularity."""
    b, h, w, c = acc.shape
    assert blk_m == 1 or (blk_m == ev.STRIP_W and w % ev.STRIP_W == 0), \
        (blk_m, tuple(acc.shape), "strip streams need blk_m == STRIP_W and "
         "W % STRIP_W == 0")
    acc2 = acc.reshape(b * h * w, c)
    c2 = cfg.replace(blk_m=blk_m).for_width(*acc2.shape)
    signed = cfg.magnitude or cfg.signed
    if 0 in acc2.shape:
        s = EventStream.empty(tuple(acc2.shape), blk_m=c2.blk_m,
                              blk_k=c2.blk_k, capacity=c2.capacity,
                              dtype=acc.dtype, device=acc.device,
                              fired=acc2 if keep_dense else None,
                              logical_shape=(b, h, w, c))
        return dataclasses.replace(s, signed=signed)
    if cfg.int8_events:
        return _fire_int8(acc2, c2, keep_dense,
                          logical_shape=(b, h, w, c))
    fired, bev = dispatch("fire_conv", cfg, acc2)(acc2, c2)
    return EventStream(events=bev, fired=fired if keep_dense else None,
                       shape=tuple(acc2.shape), blk_m=c2.blk_m,
                       blk_k=c2.blk_k, logical_shape=(b, h, w, c),
                       signed=signed)


# ---------------------------------------------------------------------------
# Fire-gated recurrent decode (DESIGN.md §13): the per-token increment
# drive (wkv6's key vector) is thresholded by signed fire and the state
# update skips dead channel-blocks; the decay applies everywhere.  At
# threshold 0 the gated step equals the dense step.
# ---------------------------------------------------------------------------

def recurrent_ineligible_reason(stream: EventStream, kind: str = "wkv6",
                                cfg: EngineConfig = _DEFAULT) -> str | None:
    """Why ``recurrent_step`` cannot consume ``stream`` in the event domain
    (None = it can).  Messages as in the JAX package."""
    if stream.logical_shape is not None and len(stream.logical_shape) == 4:
        return ("conv stream (NHWC logical_shape) — the recurrent step "
                "consumes per-token (G, D) row streams")
    if stream.blk_m != 1:
        return (f"recurrent drives are one row per (batch x head): blk_m "
                f"must be 1, stream has blk_m={stream.blk_m}")
    if not stream.signed:
        return ("recurrent deltas are signed; this stream was fired "
                "unsigned (ReLU fire), so negative deltas were already "
                "dropped")
    if stream.qparams is not None:
        return ("int8 event values are not supported by the recurrent "
                "step (state updates accumulate in f32)")
    name = _resolve(cfg, stream.device)
    if name not in list_backends(f"recurrent_step_{kind}"):
        return f"backend {name!r} has no recurrent_step_{kind} op"
    return None


def fire_delta(drive: torch.Tensor, cfg: EngineConfig = _DEFAULT, *,
               keep_dense: bool = True) -> EventStream:
    """Signed fire over a per-token increment drive (G, D) -> row stream:
    gates on |delta| > threshold and keeps the sign, at the recurrent tile
    geometry (``EngineConfig.for_recurrent``), flagged ``signed``.  Plain
    torch ops (the JAX package's jnp fire and encode): no B1 launch."""
    c = cfg.for_recurrent(drive.shape[-1]).for_width(*drive.shape)
    if 0 in drive.shape:
        s = EventStream.empty(tuple(drive.shape), blk_m=1, blk_k=c.blk_k,
                              capacity=c.capacity, dtype=drive.dtype,
                              device=drive.device,
                              fired=drive if keep_dense else None)
        return dataclasses.replace(s, signed=True)
    fired = plain_fire(drive, FireConfig(threshold=c.threshold, signed=True))
    s = EventStream.encode(fired, blk_m=1, blk_k=c.blk_k,
                           capacity=c.capacity, threshold=0.0,
                           keep_dense=keep_dense)
    return dataclasses.replace(s, signed=True)


def _recurrent_dense_step(kind: str, drive: torch.Tensor,
                          state: torch.Tensor, ops: dict):
    """The dense oracle of one recurrent step (the fallback path: the
    arithmetic the event backends run, so the route never changes bits at
    threshold 0 on the CPU)."""
    if kind == "wkv6":
        return wkv6_step_ref(ops["r"], drive, ops["v"], ops["w"], ops["u"],
                             state)
    return mamba_step_ref(drive, ops["da"], ops["bmat"], ops["cmat"], state)


def recurrent_step(kind: str, stream: EventStream, state: torch.Tensor,
                   cfg: EngineConfig = _DEFAULT, **ops):
    """One fire-gated recurrent decode step (DESIGN.md §13).  kind "wkv6":
    ops r, v, w, u (G, D), state (G, D, D); returns (o (G, D), S').  kind
    "mamba": ops da (B, DI, N), bmat, cmat (B, N), state (B, DI, N);
    returns the state readout y (B, DI) (the skip and gate terms are the
    model's) and h'.

    An event-eligible stream dispatches to the backend's gated step, which
    skips the increment on dead channel-blocks; an ineligible one falls
    back to the dense oracle on the stream's dense view, visibly, with the
    named rule on the trace record.  Zero-extent steps short-circuit to the
    oracle before any dispatch: no kernel sees a 0-extent launch."""
    assert kind in ("wkv6", "mamba"), kind
    g, d = stream.shape
    if g == 0 or d == 0:
        drive = stream.fired if stream.fired is not None \
            else torch.zeros(stream.shape, device=state.device)
        return _recurrent_dense_step(kind, drive, state, ops)
    name = cfg.resolve_backend(stream.device, state)
    reason = recurrent_ineligible_reason(stream, kind, cfg)
    dec = route_recurrent(kind, g, d, state.shape[-1], cfg,
                          eligible=reason is None, device=stream.device)
    fields = _route_fields(dec, f"{kind}d{d}")
    if dec.is_event:
        trace.record(op="recurrent_step", kind=kind, backend=name,
                     chained=True, **fields)
        return get_backend(f"recurrent_step_{kind}", name)(stream, state,
                                                           ops, cfg)
    if dec.source == "geometry":
        if reason is not None:
            fields["reason"] = reason
        trace.record(op="recurrent_step", kind=kind, backend=name,
                     fallback_decode=True, **fields)
    else:
        trace.record(op="recurrent_step", kind=kind, backend=name,
                     routed_dense=True, **fields)
    return _recurrent_dense_step(kind, stream.dense(), state, ops)


def sparsify(h: torch.Tensor, cfg: EngineConfig = _DEFAULT) -> torch.Tensor:
    """Shape-preserving fire + dead-tile masking on (..., K) activations —
    the MNF multiply phase's semantics inside LM blocks
    (``models.layers.mnf_sparsify``): the identity at threshold 0 on a
    ReLU-family activation; at threshold > 0 whole event-free (blk_m,
    blk_k) tiles are zeroed, as the event matmul would skip them."""
    fired = plain_fire(h, FireConfig(threshold=cfg.threshold,
                                     magnitude=cfg.magnitude))
    if cfg.threshold <= 0.0:
        return fired
    shp = h.shape
    h2 = fired.reshape(-1, shp[-1])
    pad_m = (-h2.shape[0]) % cfg.blk_m
    h2 = ev.pad_to_block_multiple(h2, cfg.blk_m, 0)
    h2 = ev.pad_to_block_multiple(h2, cfg.blk_k, 1)
    h2 = mask_dead_blocks(h2, blk_m=cfg.blk_m, blk_k=cfg.blk_k,
                          threshold=0.0)
    return h2[:h2.shape[0] - pad_m, :shp[-1]].reshape(shp)


def describe(cfg: EngineConfig = _DEFAULT, device=None) -> dict:
    """The resolved engine configuration, as serve and dry-run report it:
    the JAX package's keys less ``interpret`` and ``blk_n``, which the
    port has no counterpart for.  ``device`` is the device type the entry
    points run on — ``default_device()`` unless the caller passes one —
    and the backend is the one that device's operands resolve."""
    dev = default_device() if device is None else torch.device(device)
    return dict(backend=cfg.resolve_backend(dev), blk_m=cfg.blk_m,
                blk_k=cfg.blk_k, capacity=cfg.capacity,
                threshold=cfg.threshold, magnitude=cfg.magnitude,
                device=dev.type)

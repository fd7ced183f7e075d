"""The paper's evaluation workloads — AlexNet and VGG16 with MNF inference —
port of ``repro.models.cnn``.

Two execution paths over identical params, both dispatched through
``repro_torch.engine``:

  * dense (``mnf=False``) — the engine's dense backend + ReLU, the oracle;
  * mnf — event-resident (``chain=True``): one EventStream threads the
    network.  Each conv fire emits strip-aligned rows when the consumer can
    ride the fused strip conv or the window-major pool, pixel rows
    otherwise; pools run in the event domain; the conv→FC seam re-tiles by
    static address plan; FC layers chain streams to the logits — zero
    densify points (DESIGN.md §5–§7, §12).  ``chain=False`` is the
    per-layer round-trip twin (dense at every boundary, same compute
    geometry), bitwise equal to the chained path.

``FireConfig(quantize_to_int8=True)`` or ``EngineConfig(int8_events=True)``
makes every fire emit int8 event values; the round-trip twin is then the
fake-quant forward, and the chain stays bitwise equal to it.

The forward runs on the card unless the caller passes ``device="cpu"``.

``run_with_stats`` is the forward with the per-layer event accounting of
the paper's cost model (events in, event and dense MACs, fired density).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import engine
from repro_torch.core.fire import FireConfig, fire
from repro_torch.core.mnf_conv import conv_out_size
from repro_torch.device import default_device
from repro_torch.launch import graphs
from repro_torch.models.layers import max_pool_nhwc

__all__ = ["ConvSpec", "FCSpec", "PoolSpec", "CNNSpec", "ALEXNET", "VGG16",
           "ALEXNET_DS", "ALEXNET_FF", "VGG16_DS", "MINI", "MINI_S4",
           "Pipeline", "conv_downsampled", "init_cnn_params",
           "params_from_numpy", "cnn_forward", "chain_boundary_summary",
           "fc_in_events", "layer_dense_macs", "make_cnn_forward",
           "make_cnn_pipeline", "run_with_stats"]


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    out_ch: int
    k: int
    stride: int = 1
    padding: int = 0


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    k: int = 2
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class FCSpec:
    out: int


@dataclasses.dataclass(frozen=True)
class CNNSpec:
    name: str
    input_size: int
    in_ch: int
    layers: tuple
    num_classes: int = 1000

    def scaled(self, input_size: int) -> "CNNSpec":
        """Same topology at another input resolution."""
        return dataclasses.replace(self, input_size=input_size)


ALEXNET = CNNSpec(
    "alexnet", 224, 3,
    (ConvSpec(96, 11, 4, 2), PoolSpec(3, 2),
     ConvSpec(256, 5, 1, 2), PoolSpec(3, 2),
     ConvSpec(384, 3, 1, 1), ConvSpec(384, 3, 1, 1), ConvSpec(256, 3, 1, 1),
     PoolSpec(3, 2),
     FCSpec(4096), FCSpec(4096), FCSpec(1000)))

VGG16 = CNNSpec(
    "vgg16", 224, 3,
    (ConvSpec(64, 3, 1, 1), ConvSpec(64, 3, 1, 1), PoolSpec(),
     ConvSpec(128, 3, 1, 1), ConvSpec(128, 3, 1, 1), PoolSpec(),
     ConvSpec(256, 3, 1, 1), ConvSpec(256, 3, 1, 1), ConvSpec(256, 3, 1, 1),
     PoolSpec(),
     ConvSpec(512, 3, 1, 1), ConvSpec(512, 3, 1, 1), ConvSpec(512, 3, 1, 1),
     PoolSpec(),
     ConvSpec(512, 3, 1, 1), ConvSpec(512, 3, 1, 1), ConvSpec(512, 3, 1, 1),
     PoolSpec(),
     FCSpec(4096), FCSpec(4096), FCSpec(1000)))


def conv_downsampled(spec: CNNSpec, *, k: int = 3) -> CNNSpec:
    """All-conv variant: every pool becomes a stride-2 k×k conv (padding
    k//2, channel-preserving)."""
    layers = []
    c = spec.in_ch
    for layer in spec.layers:
        if isinstance(layer, PoolSpec):
            layers.append(ConvSpec(c, k, 2, k // 2))
        else:
            layers.append(layer)
            if isinstance(layer, ConvSpec):
                c = layer.out_ch
    return dataclasses.replace(spec, name=spec.name + "_ds",
                               layers=tuple(layers))


ALEXNET_DS = conv_downsampled(ALEXNET)
VGG16_DS = conv_downsampled(VGG16)

#: Fully fused AlexNet: conv1 padding 4 and input 256, so every layer width
#: tiles into 8-pixel strips (see the JAX package's note on ALEXNET_FF).
ALEXNET_FF = CNNSpec(
    "alexnet_ff", 256, 3,
    (ConvSpec(96, 11, 4, 4), ConvSpec(96, 3, 2, 1),
     ConvSpec(256, 5, 1, 2), ConvSpec(256, 3, 2, 1),
     ConvSpec(384, 3, 1, 1), ConvSpec(384, 3, 1, 1), ConvSpec(256, 3, 1, 1),
     ConvSpec(256, 3, 2, 1),
     FCSpec(4096), FCSpec(4096), FCSpec(1000)))

#: Seconds-scale net with every chain seam: conv→conv, conv→pool→conv,
#: conv→FC.
MINI = CNNSpec("mini", 8, 3,
               (ConvSpec(8, 3, 1, 1), ConvSpec(8, 3, 1, 1), PoolSpec(),
                ConvSpec(8, 3, 1, 1), FCSpec(10)), num_classes=10)

#: Stride-4 smoke net: a strip-eligible k3s4 conv between stride-1 convs.
MINI_S4 = CNNSpec("mini_s4", 32, 3,
                  (ConvSpec(8, 3, 1, 1), ConvSpec(8, 3, 4, 1),
                   ConvSpec(8, 3, 1, 1), FCSpec(10)), num_classes=10)


def _trace_shapes(spec: CNNSpec):
    """(H, W, C) entering each layer."""
    h = w = spec.input_size
    c = spec.in_ch
    shapes = []
    for layer in spec.layers:
        shapes.append((h, w, c))
        if isinstance(layer, ConvSpec):
            h = conv_out_size(h, layer.k, layer.stride, layer.padding)
            w = conv_out_size(w, layer.k, layer.stride, layer.padding)
            c = layer.out_ch
        elif isinstance(layer, PoolSpec):
            h = (h - layer.k) // layer.stride + 1
            w = (w - layer.k) // layer.stride + 1
        elif isinstance(layer, FCSpec):
            h, w, c = 1, 1, layer.out
    return shapes


def init_cnn_params(spec: CNNSpec, generator: torch.Generator, *,
                    weight_sparsity: float = 0.0) -> list:
    """He-initialized weights (HWIO convs, (K, N) FCs, None for pools) drawn
    from ``generator`` on its device; optional unstructured pruning."""
    dev = generator.device
    params = []
    for layer, (h, w, c) in zip(spec.layers, _trace_shapes(spec)):
        if isinstance(layer, ConvSpec):
            shape = (layer.k, layer.k, c, layer.out_ch)
            fan_in = layer.k * layer.k * c
        elif isinstance(layer, FCSpec):
            shape = (h * w * c, layer.out)
            fan_in = h * w * c
        else:
            params.append(None)
            continue
        wgt = torch.randn(shape, generator=generator, device=dev) \
            * (2.0 / fan_in) ** 0.5
        if weight_sparsity > 0.0:
            keep = torch.rand(shape, generator=generator, device=dev)
            wgt = torch.where(keep >= weight_sparsity, wgt, 0.0)
        params.append(wgt)
    return params


def params_from_numpy(params: list, device=None) -> list:
    """The JAX package's ``init_cnn_params`` list (arrays, None for pools)
    as the port's params, same layout — both packages then compute the
    same function."""
    return [None if p is None
            else torch.from_numpy(np.array(p, np.float32)).to(device or "cpu")
            for p in params]


def _touched_outputs(h: int, w: int, k: int, stride: int,
                     padding: int) -> np.ndarray:
    """(H, W) map: output positions each input pixel contributes to."""
    oy = conv_out_size(h, k, stride, padding)
    ox = conv_out_size(w, k, stride, padding)

    def jumps(i, osz):
        lo = np.maximum(0, -(-(i + padding - k + 1) // stride))
        hi = np.minimum(osz - 1, (i + padding) // stride)
        return np.maximum(hi - lo + 1, 0)

    return jumps(np.arange(h)[:, None], oy) * jumps(np.arange(w)[None, :],
                                                    ox)


def layer_dense_macs(spec: CNNSpec) -> list:
    """Per-compute-layer dense MAC counts (what a dense accelerator does)."""
    out = []
    for layer, (h, w, c) in zip(spec.layers, _trace_shapes(spec)):
        if isinstance(layer, ConvSpec):
            oy = conv_out_size(h, layer.k, layer.stride, layer.padding)
            ox = conv_out_size(w, layer.k, layer.stride, layer.padding)
            out.append(oy * ox * layer.k * layer.k * c * layer.out_ch)
        elif isinstance(layer, FCSpec):
            out.append(h * w * c * layer.out)
    return out


def _pixel_events(x):
    """(B, H, W) fired activations per pixel, f64, and the NHWC shape:
    from a stream's compacted event values (twin-free), or the non-zeros
    of a dense map."""
    if isinstance(x, engine.EventStream):
        b, h, w, c = x.logical_shape
        return (x.per_row_scalar_events().double().reshape(b, h, w),
                (b, h, w, c))
    return (x.abs() > 0).sum(-1, dtype=torch.float64), tuple(x.shape)


def fc_in_events(x, threshold: float = 0.0) -> torch.Tensor:
    """Events entering an FC boundary (Algorithm 2 charges ``in_events *
    out`` MACs), a 0-d f64 tensor on ``x``'s device: a stream's non-zero
    event values (twin-free; int8 streams count quantized events), a
    dense input's activations above the fire ``threshold``.  Summed in
    f64, so the count is exact where the JAX package's f32 sum is (below
    2^24) and beyond."""
    if isinstance(x, engine.EventStream):
        return x.per_row_scalar_events().double().sum()
    return (x.abs() > threshold).sum(dtype=torch.float64)


def _density(x) -> torch.Tensor:
    """Fired fraction of an activation, 0-d f32 (a stream: its twin-free
    event count); 0 for an empty one, not 0/0."""
    if isinstance(x, engine.EventStream):
        m, k = x.shape
        if m * k == 0:
            return torch.zeros((), dtype=torch.float32, device=x.device)
        return x.num_scalar_events / (m * k)
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return (x.abs() > 0).sum(dtype=torch.float32) / x.numel()


def _layer_cfg(base: engine.EngineConfig | None, *, mnf: bool,
               fire_cfg: FireConfig) -> engine.EngineConfig:
    cfg = base or engine.EngineConfig()
    if not mnf:
        cfg = cfg.replace(backend="dense")
    return cfg.replace(threshold=fire_cfg.threshold,
                       magnitude=fire_cfg.magnitude,
                       int8_events=cfg.int8_events
                       or fire_cfg.quantize_to_int8)


def _next_conv_blk_m(nxt, out_shape: tuple) -> int:
    """Granularity a fired layer emits, chosen from its consumer: strips
    for a strip-eligible conv or a window-eligible pool, pixels else."""
    out_w = out_shape[2]
    if isinstance(nxt, ConvSpec) and engine.strip_eligible(
            out_w, nxt.k, nxt.stride, nxt.padding, co=nxt.out_ch):
        return engine.STRIP_W
    if isinstance(nxt, PoolSpec) and engine.pool_window_ineligible_reason(
            tuple(out_shape), nxt.k, nxt.stride, engine.STRIP_W) is None:
        return engine.STRIP_W
    return 1


def _input_stream_blk_m(layer: ConvSpec, x_shape: tuple,
                        cfg: engine.EngineConfig, device) -> int:
    """STRIP_W when the chained path strip-encodes a dense conv input (the
    chain head) because the conv is strip-eligible and routes to the event
    path; 0 = stay dense."""
    b, h, w, c = x_shape
    if not engine.strip_eligible(w, layer.k, layer.stride, layer.padding,
                                 co=layer.out_ch):
        return 0
    dec = engine.route_conv((b, h, w, c),
                            (layer.k, layer.k, c, layer.out_ch), cfg,
                            stride=layer.stride, padding=layer.padding,
                            blk_m=engine.STRIP_W, device=device)
    return engine.STRIP_W if dec.route == "strip" else 0


def _next_boundary_route(nxt, out_shape: tuple, cfg: engine.EngineConfig,
                         blk_m: int, device):
    """The route the next boundary will take — same call, same inputs as
    the dispatch, so planner and dispatch cannot disagree."""
    if isinstance(nxt, ConvSpec):
        return engine.route_conv(
            out_shape, (nxt.k, nxt.k, out_shape[3], nxt.out_ch), cfg,
            stride=nxt.stride, padding=nxt.padding, blk_m=blk_m,
            device=device)
    if isinstance(nxt, FCSpec):
        b, oh, ow, c = out_shape
        return engine.route_linear(b, oh * ow * c, nxt.out, cfg,
                                   device=device)
    return engine.route_pool(out_shape, nxt.k, nxt.stride, cfg, blk_m=blk_m,
                             device=device)


def _fc_chains(nxt, out_shape: tuple, cfg: engine.EngineConfig,
               blk_m: int) -> bool:
    """Whether a stream emitted at ``blk_m`` chains into a next-layer FC
    through the re-tiler."""
    if not isinstance(nxt, FCSpec):
        return False
    blk_k = min(cfg.blk_k, max(out_shape[-1], 1))
    return engine.retile_ineligible_reason(tuple(out_shape), blk_m,
                                           blk_k) is None


def chain_boundary_summary(spec: CNNSpec, *, batch: int = 1,
                           fire_cfg: FireConfig = FireConfig(),
                           engine_cfg: engine.EngineConfig | None = None,
                           device=None) -> dict:
    """Shape-derived per-boundary accounting of the chained pipeline:
    compute layers by kind, pools on the event path (``pool_events``),
    conv→FC re-tiles, chain-head input encodes, and the densify points
    left (``densify`` — 0 when every boundary is eligible), plus each
    stream boundary's routing decision in chain order."""
    cfg = _layer_cfg(engine_cfg, mnf=True, fire_cfg=fire_cfg)
    conv_base = cfg.replace(blk_m=1, blk_k=min(8, cfg.blk_k))
    shapes = _trace_shapes(spec)
    out = dict(conv=0, fc=0, pool=0, pool_events=0, densify=0,
               input_encode=0, retile=0, routes=[])
    conv_stream_in = fc_stream_in = False
    blk_m = 1
    for i, layer in enumerate(spec.layers):
        h, w, c = shapes[i]
        nxt = spec.layers[i + 1] if i + 1 < len(spec.layers) else None
        if isinstance(layer, ConvSpec):
            out["conv"] += 1
            if not conv_stream_in:
                bm_in = _input_stream_blk_m(layer, (batch, h, w, c),
                                            conv_base, device)
                if bm_in:
                    out["input_encode"] += 1
                    conv_stream_in = True
                    blk_m = bm_in
            if conv_stream_in:
                dec = engine.route_conv(
                    (batch, h, w, c), (layer.k, layer.k, c, layer.out_ch),
                    conv_base, stride=layer.stride, padding=layer.padding,
                    blk_m=blk_m, device=device)
                out["routes"].append(dict(
                    op="conv2d", route=dec.route, occupancy=dec.occupancy,
                    est_event_cost=dec.est_event_cost,
                    est_dense_cost=dec.est_dense_cost, source=dec.source,
                    shape_class=f"k{layer.k}s{layer.stride}"))
            oy = conv_out_size(h, layer.k, layer.stride, layer.padding)
            ox = conv_out_size(w, layer.k, layer.stride, layer.padding)
            blk_m = _next_conv_blk_m(nxt, (batch, oy, ox, layer.out_ch))
            conv_stream_in = True
        elif isinstance(layer, FCSpec):
            out["fc"] += 1
            if conv_stream_in or fc_stream_in:
                kf = h * w * c
                reason = None
                if conv_stream_in:
                    reason = engine.retile_ineligible_reason(
                        (batch, h, w, c), blk_m,
                        min(conv_base.blk_k, max(c, 1)))
                dec = engine.route_linear(batch, kf, layer.out, cfg,
                                          eligible=reason is None,
                                          device=device)
                rec = dict(op="linear", route=dec.route,
                           occupancy=dec.occupancy,
                           est_event_cost=dec.est_event_cost,
                           est_dense_cost=dec.est_dense_cost,
                           source=dec.source,
                           shape_class=engine.linear_shape_class(
                               batch, kf, layer.out))
                if conv_stream_in and reason is None:
                    rec["retile"] = True
                    out["retile"] += 1
                if reason is not None:
                    rec["reason"] = reason
                    out["densify"] += 1
                out["routes"].append(rec)
            conv_stream_in = False
            fc_stream_in = layer is not spec.layers[-1]
        elif isinstance(layer, PoolSpec):
            out["pool"] += 1
            if conv_stream_in and engine.pool_ineligible_reason(
                    (batch, h, w, c), layer.k, layer.stride,
                    conv_base) is None:
                out["pool_events"] += 1
                dec = engine.route_pool((batch, h, w, c), layer.k,
                                        layer.stride, conv_base, blk_m=blk_m,
                                        device=device)
                out["routes"].append(dict(
                    op="maxpool2d", route=dec.route, occupancy=dec.occupancy,
                    est_event_cost=dec.est_event_cost,
                    est_dense_cost=dec.est_dense_cost, source=dec.source,
                    shape_class=f"k{layer.k}s{layer.stride}c{c}"))
                oh = (h - layer.k) // layer.stride + 1
                ow = (w - layer.k) // layer.stride + 1
                blk_m = _next_conv_blk_m(nxt, (batch, oh, ow, c))
            else:
                out["densify"] += 1
                conv_stream_in = False
    return out


def _forward(params, x, spec: CNNSpec, *, fire_cfg: FireConfig,
             cfg: engine.EngineConfig, chain: bool,
             stats: list | None = None):
    """The one forward body.  ``chain=True`` threads an EventStream through
    conv→fire→conv→…→FC; ``chain=False`` is the round-trip twin.  The conv
    dispatch config stays pixel-granular (blk_m 1, blk_k ≤ 8) so the twin
    multiplies the same tiles in the same order as the chained path.
    ``stats`` (a list to append to) asks for each compute layer's event
    accounting as device tensors (``event_macs``, ``in_events``,
    ``out_density``), read from the compacted event values on the chained
    path; with None the forward runs nothing for it."""
    layers = spec.layers
    dev = x.device
    conv_base = cfg.replace(blk_m=1, blk_k=min(8, cfg.blk_k))
    for i, (layer, wgt) in enumerate(zip(layers, params)):
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if isinstance(layer, ConvSpec):
            if chain and not isinstance(x, engine.EventStream):
                bm_in = _input_stream_blk_m(layer, tuple(x.shape), conv_base,
                                            dev)
                if bm_in:
                    x = engine.EventStream.encode_nhwc(
                        x, blk_k=min(conv_base.blk_k, max(x.shape[-1], 1)),
                        blk_m=bm_in, keep_dense=False)
            ci = x.logical_shape[-1] if isinstance(x, engine.EventStream) \
                else x.shape[-1]
            ccfg = conv_base.replace(threshold=0.0).for_conv(ci)
            if stats is not None:
                nzmap, (_, h, w, _) = _pixel_events(x)
                touched = torch.from_numpy(_touched_outputs(
                    h, w, layer.k, layer.stride, layer.padding)).to(nzmap)
                stats.append(dict(
                    event_macs=(nzmap * touched).sum() * layer.out_ch,
                    in_events=nzmap.sum()))
            acc = engine.conv2d(x, wgt, cfg=ccfg, stride=layer.stride,
                                padding=layer.padding)
            if chain:
                shape = tuple(acc.shape)
                pool_chains = (isinstance(nxt, PoolSpec)
                               and engine.pool_ineligible_reason(
                                   shape, nxt.k, nxt.stride, conv_base)
                               is None)
                bm_next = _next_conv_blk_m(nxt, shape)
                keep = not (isinstance(nxt, ConvSpec) or pool_chains
                            or _fc_chains(nxt, shape, conv_base, bm_next))
                if not keep and conv_base.route != "auto":
                    keep = not _next_boundary_route(nxt, shape, conv_base,
                                                    bm_next, dev).is_event
                x = engine.fire_conv(acc, conv_base, keep_dense=keep,
                                     blk_m=bm_next)
            else:
                x = fire(acc, fire_cfg)
            if stats is not None:
                stats[-1]["out_density"] = _density(x)
        elif isinstance(layer, PoolSpec):
            if chain and isinstance(x, engine.EventStream) \
                    and engine.pool_ineligible_reason(
                        x, layer.k, layer.stride, conv_base) is None:
                b, h, w, c = x.logical_shape
                pooled_shape = (b, (h - layer.k) // layer.stride + 1,
                                (w - layer.k) // layer.stride + 1, c)
                pcfg = conv_base.for_conv(c).replace(
                    blk_m=_next_conv_blk_m(nxt, pooled_shape))
                keep_pool = not (isinstance(nxt, ConvSpec)
                                 or _fc_chains(nxt, pooled_shape, conv_base,
                                               pcfg.blk_m))
                if not keep_pool and conv_base.route != "auto":
                    keep_pool = not _next_boundary_route(
                        nxt, pooled_shape, conv_base, pcfg.blk_m,
                        dev).is_event
                x = engine.maxpool2d(x, layer.k, layer.stride, cfg=pcfg,
                                     keep_dense=keep_pool)
            else:
                dense = x.dense_nhwc() if isinstance(x, engine.EventStream) \
                    else x
                pooled = max_pool_nhwc(dense, layer.k, layer.stride)
                if chain and isinstance(nxt, ConvSpec):
                    x = engine.EventStream.encode_nhwc(
                        pooled, blk_k=conv_base.blk_k,
                        blk_m=_next_conv_blk_m(nxt, tuple(pooled.shape)),
                        keep_dense=False)
                else:
                    x = pooled
        elif isinstance(layer, FCSpec):
            # Conv-derived inputs dispatch under the re-tiled geometry
            # (blk_m 1, the conv chain's blk_k), so the twin's encode of
            # the flattened map gives exactly the re-tiler's BlockEvents.
            if isinstance(x, engine.EventStream) \
                    and x.logical_shape is not None:
                fcfg = cfg.replace(threshold=0.0, blk_m=1, blk_k=x.blk_k)
            elif not isinstance(x, engine.EventStream) and x.ndim == 4:
                fcfg = cfg.replace(
                    threshold=0.0, blk_m=1,
                    blk_k=min(conv_base.blk_k, max(x.shape[-1], 1)))
            else:
                fcfg = cfg.replace(threshold=0.0)
            flat = x if isinstance(x, engine.EventStream) \
                else x.reshape(x.shape[0], -1)
            if stats is not None:
                in_ev = fc_in_events(flat, fire_cfg.threshold)
                stats.append(dict(event_macs=in_ev * layer.out,
                                  in_events=in_ev))
            acc = engine.linear(flat, wgt, cfg=fcfg)
            if layer is layers[-1]:
                x = acc
            elif chain:
                x = engine.fire(acc, cfg, keep_dense=False)
            else:
                x = fire(acc, fire_cfg)
            if stats is not None:
                stats[-1]["out_density"] = _density(x)
    if isinstance(x, engine.EventStream):
        return x.dense_nhwc() if x.logical_shape is not None else x.dense()
    return x


def make_cnn_forward(spec: CNNSpec, *, mnf: bool = True,
                     fire_cfg: FireConfig = FireConfig(),
                     engine_cfg: engine.EngineConfig | None = None,
                     chain: bool | None = None):
    """The whole-network closure ``fwd(params, x) -> logits`` on tensors
    already on their device: the seam a pipeline captures
    (:func:`make_cnn_pipeline`) and :func:`cnn_forward` runs."""
    cfg = _layer_cfg(engine_cfg, mnf=mnf, fire_cfg=fire_cfg)
    chain = mnf if chain is None else chain and mnf

    def fwd(params, x):
        return _forward(params, x, spec, fire_cfg=fire_cfg, cfg=cfg,
                        chain=chain)

    return fwd


class Pipeline:
    """``fn(params, x) -> logits`` for one input shape: on the card, one
    CUDA graph of ``fwd`` (``launch.graphs``), captured at the first call;
    each call copies ``x`` into the graph's static input (the caller never
    reuses it in place, as JAX's donated image; from pinned host memory
    the copy is asynchronous, so the caller keeps ``x`` unchanged until it
    has read the logits) and replays, and the logits it returns are the
    graph's, rewritten by the next call.  On the CPU (``device="cpu"``)
    the eager ``fwd``.  Either way the pipeline is bound to the parameter
    tensors of its first call: a call with others raises, so it never
    replays stale weights.  ``captures`` counts the graphs it captured (on
    the CPU its first calls): one, after the first call, for good."""

    def __init__(self, fwd, shape: tuple, device):
        self.fwd, self.shape = fwd, tuple(shape)
        self.device = torch.device(device)
        self.graph: graphs.Graph | None = None
        self.params = None
        self.captures = 0

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self.shape:
            raise ValueError(f"input {tuple(x.shape)}: this pipeline takes "
                             f"{self.shape}")
        if self.params is not None and params is not self.params \
                and not graphs.same_tensors(self.params, params):
            raise ValueError("this pipeline reads the parameter tensors of "
                             "its first call; make a new one for others")
        if self.device.type == "cpu":
            if self.params is None:
                self.params = params
                self.captures += 1
            return self.fwd(params, x)
        if self.graph is None:
            self.graph = graphs.capture(
                self.fwd, params,
                torch.zeros(self.shape, dtype=torch.float32,
                            device=self.device))
            self.params = params
            self.captures += 1
        self.graph.static[1].copy_(x, non_blocking=True)
        return self.graph.replay()


def make_cnn_pipeline(spec: CNNSpec, *, batch: int, mnf: bool = True,
                      fire_cfg: FireConfig = FireConfig(),
                      engine_cfg: engine.EngineConfig | None = None,
                      chain: bool | None = None, device=None) -> Pipeline:
    """One compiled forward per (network, batch, event type):
    ``fn(params, x) -> logits`` for x (batch, H, W, C), a CUDA graph of
    :func:`make_cnn_forward` on the card (:class:`Pipeline`) — the JAX
    package's single ``jax.jit`` of the whole pipeline.  Runs on the card
    (``default_device()``) unless ``device`` says otherwise."""
    dev = default_device() if device is None else torch.device(device)
    fwd = make_cnn_forward(spec, mnf=mnf, fire_cfg=fire_cfg,
                           engine_cfg=engine_cfg, chain=chain)
    return Pipeline(fwd, (batch, spec.input_size, spec.input_size,
                          spec.in_ch), dev)


def cnn_forward(params, x, spec: CNNSpec, *, mnf: bool = True,
                fire_cfg: FireConfig = FireConfig(),
                engine_cfg: engine.EngineConfig | None = None,
                chain: bool | None = None, device=None) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, classes).  ``mnf=False`` is the dense
    oracle; ``chain=False`` the per-layer round-trip twin.  Runs on the
    card (``default_device()``) unless ``device`` says otherwise; inputs
    and params move there."""
    dev = default_device() if device is None else torch.device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    params = [None if p is None else p.to(dev) for p in params]
    fwd = make_cnn_forward(spec, mnf=mnf, fire_cfg=fire_cfg,
                           engine_cfg=engine_cfg, chain=chain)
    return fwd(params, x)


def _static_layer_stats(spec: CNNSpec, batch: int) -> list:
    """Shape-derived stats fields of each compute layer: kind, ``c_out``,
    ``dense_macs`` (:func:`layer_dense_macs` times the batch) and
    ``in_elems``."""
    macs = iter(layer_dense_macs(spec))
    out = []
    for layer, (h, w, c) in zip(spec.layers, _trace_shapes(spec)):
        if isinstance(layer, (ConvSpec, FCSpec)):
            out.append(dict(
                kind="conv" if isinstance(layer, ConvSpec) else "fc",
                c_out=layer.out_ch if isinstance(layer, ConvSpec)
                else layer.out,
                dense_macs=float(batch * next(macs)),
                in_elems=float(batch * h * w * c)))
    return out


def _read_stats(static: list, traced: list) -> list:
    """Join the static fields with the traced device counts, read to the
    host in one copy (each value a Python float)."""
    keys = [sorted(tr) for tr in traced]
    flat = [tr[k].double() for tr, ks in zip(traced, keys) for k in ks]
    vals = iter(torch.stack(flat).tolist() if flat else [])
    out = []
    for st, ks in zip(static, keys):
        d = dict(st)
        d.update({k: next(vals) for k in ks})
        out.append(d)
    return out


def run_with_stats(params, x, spec: CNNSpec,
                   fire_cfg: FireConfig = FireConfig(),
                   engine_cfg: engine.EngineConfig | None = None, *,
                   device=None):
    """The chained MNF forward plus per-layer event accounting: (logits,
    stats list).  One eager forward (the logits are ``cnn_forward``'s,
    bitwise), its counts kept on the device and read in one copy at the
    end.  Each compute layer's stats: ``dense_macs`` (the dense
    dataflow's MACs), ``event_macs`` (the MACs the multiply phase
    performs, Algorithm 1's walk), ``in_events`` (events fired into the
    layer), ``in_elems`` (dense input elements), ``out_density`` (the
    fraction of outputs that fire), ``avg_touched`` (event MACs per input
    event and output channel).  Runs on the card unless ``device`` says
    otherwise."""
    dev = default_device() if device is None else torch.device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    params = [None if p is None else p.to(dev) for p in params]
    cfg = _layer_cfg(engine_cfg, mnf=True, fire_cfg=fire_cfg)
    traced: list = []
    logits = _forward(params, x, spec, fire_cfg=fire_cfg, cfg=cfg,
                      chain=True, stats=traced)
    stats = _read_stats(_static_layer_stats(spec, x.shape[0]), traced)
    for d in stats:
        d["avg_touched"] = (
            d["event_macs"] / max(d["in_events"] * d["c_out"], 1.0)
            if d["kind"] == "conv" else 1.0)
    return logits, stats

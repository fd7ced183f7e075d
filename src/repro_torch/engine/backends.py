"""Built-in engine backends (DESIGN.md §4), port of ``repro.engine.backends``.

One uniform signature per op:

  matmul               fn(a, w, cfg)                      a: (M, K)
  linear               fn(x, w, b, cfg)                   x: (M, K)
  linear_events        fn(stream, w, b, cfg)
  conv2d               fn(x, w, b, cfg, stride, padding)  x: (B, H, W, CI)
  conv2d_events        fn(stream, w, b, cfg, stride, padding)  pixel stream
  conv2d_events_strip  fn(stream, w, b, cfg, stride, padding)  strip stream
  maxpool2d            fn(x, k, stride, cfg)              dense NHWC
  maxpool2d_events     fn(stream, k, stride, cfg) -> (B·OH·OW, C) rows
  maxpool2d_events_window   the same, window-major strip grid
  fire / fire_conv     fn(acc, cfg) -> (fired, BlockEvents)
  recurrent_step_wkv6  fn(stream, state, ops, cfg) -> (o, S')  row stream
  recurrent_step_mamba fn(stream, state, ops, cfg) -> (y, h')  row stream

"dense" is the oracle, and "scalar" the paper's own dataflow as a second
one: Algorithm 2 (``scalar_event_linear``) row by row and Algorithm 1
(``scalar_event_conv2d``) image by image, the dense pool and the plain
fire — plain torch ops on either device, as the JAX package's are plain
``jnp``.  Neither registers an ``*_events`` op: a stream handed to them
decodes, visibly.  "block" and "cuda" are one block-event dataflow
registered under both names: every callable goes through the kernels'
wrappers (``kernels/*/ops.py``), which launch the hand-written kernel on a
CUDA tensor and take the plain version (``ref.py``) on a CPU tensor.  Every
event multiply gets the stream's ``qparams``: int8 codes go to the
dequantize-at-load kernels (B5, B6).
"dense" and "scalar" register no ``recurrent_step_wkv6`` or
``recurrent_step_mamba``: the API falls back to the dense step, visibly.
``EngineConfig.resolve_backend`` holds "block" to CPU operands and "cuda"
to CUDA operands, so the name says which of the two ran.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.fire import FireConfig
from repro_torch.core.fire import fire as plain_fire
from repro_torch.core.mnf_conv import (conv_out_size, dense_conv2d,
                                       scalar_event_conv2d, tap_event_conv2d)
from repro_torch.core.mnf_linear import (block_event_linear,
                                         block_event_linear_from_events,
                                         dense_linear, scalar_event_linear)
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.registry import get_backend, register_backend
from repro_torch.engine.stream import EventStream
from repro_torch.kernels.event_conv.ops import fused_event_conv2d
from repro_torch.kernels.event_matmul.ops import event_matmul
from repro_torch.kernels.event_pool.ops import (event_max_pool2d,
                                                event_max_pool2d_window)
from repro_torch.kernels.fire_compact.ops import fire_and_encode
from repro_torch.kernels.mamba_step.ops import mamba_step_events
from repro_torch.kernels.wkv6_step.ops import wkv6_step_events
from repro_torch.models.layers import max_pool_nhwc

__all__ = []  # registration side effects only


def _bias(y: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return y if b is None else y + b


# -- matmul / linear ---------------------------------------------------------

@register_backend("matmul", "dense")
def _matmul_dense(a, w, cfg: EngineConfig):
    return dense_linear(a, w)


@register_backend("matmul", "scalar")
def _matmul_scalar(a, w, cfg: EngineConfig):
    """Algorithm 2 on each row (the JAX package vmaps it over the rows)."""
    return torch.stack([scalar_event_linear(row, w) for row in a])


def _matmul_events(a, w, cfg: EngineConfig):
    c = cfg.for_width(*a.shape)
    return block_event_linear(a, w, blk_m=c.blk_m, blk_k=c.blk_k,
                              capacity=c.capacity, threshold=c.threshold,
                              matmul=event_matmul)


def _linear(x, w, b, cfg: EngineConfig, *, name: str):
    return _bias(get_backend("matmul", name)(x, w, cfg), b)


def _linear_events(stream, w, b, cfg: EngineConfig):
    m, k = stream.shape
    assert w.shape[0] == k, (tuple(w.shape), stream.shape)
    y = block_event_linear_from_events(stream.events, w, matmul=event_matmul,
                                       qparams=stream.qparams)
    return _bias(y[:m], b)


# -- conv2d -------------------------------------------------------------------

@register_backend("conv2d", "dense")
def _conv2d_dense(x, w, b, cfg: EngineConfig, stride, padding):
    return dense_conv2d(x, w, stride=stride, padding=padding, b=b)


@register_backend("conv2d", "scalar")
def _conv2d_scalar(x, w, b, cfg: EngineConfig, stride, padding):
    """Algorithm 1 on each image."""
    return _bias(torch.stack([scalar_event_conv2d(img, w, stride=stride,
                                                  padding=padding)
                              for img in x]), b)


def _conv2d_events_dense_input(x, w, b, cfg: EngineConfig, stride, padding):
    """Dense input: per tap, encode the shifted slice and run the event
    multiply — the round-trip twin's path."""
    c = cfg.for_conv(x.shape[-1])
    mm = functools.partial(block_event_linear, blk_m=c.blk_m, blk_k=c.blk_k,
                           capacity=c.capacity, threshold=c.threshold,
                           matmul=event_matmul)
    return _bias(tap_event_conv2d(x, w, stride=stride, padding=padding,
                                  matmul=mm), b)


def tap_row_map(logical_shape: tuple, k: int, stride: int, padding: int):
    """Per-tap row-group gather plan of the per-tap conv path: ``idx`` and
    ``live`` (k·k, B·OY·OX) — tap (dy, dx) of output pixel (b, oy, ox)
    reads input pixel (oy·s + dy − p, ox·s + dx − p), dead in the zero
    padding border."""
    bsz, h, wd, _ = logical_shape
    oy = conv_out_size(h, k, stride, padding)
    ox = conv_out_size(wd, k, stride, padding)
    bi = np.arange(bsz)[:, None, None]
    oyi = np.arange(oy)[None, :, None]
    oxi = np.arange(ox)[None, None, :]
    idx = np.zeros((k * k, bsz * oy * ox), np.int64)
    live = np.zeros((k * k, bsz * oy * ox), bool)
    for dy in range(k):
        for dx in range(k):
            iy = oyi * stride + dy - padding
            ix = oxi * stride + dx - padding
            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
            q = (bi * h + np.clip(iy, 0, h - 1)) * wd + np.clip(ix, 0, wd - 1)
            idx[dy * k + dx] = np.broadcast_to(q, (bsz, oy, ox)).reshape(-1)
            live[dy * k + dx] = np.broadcast_to(ok, (bsz, oy, ox)).reshape(-1)
    return idx, live


def _conv2d_events(stream, w, b, cfg: EngineConfig, stride, padding):
    """Per-tap path on a pixel stream: Σ_taps multiply(gathered events, W_tap)
    — layer L's fired events feed layer L+1's taps, no dense map."""
    assert stream.blk_m == 1, \
        "conv streams are pixel-granular (emit with engine.fire_conv)"
    bsz, h, wd, ci = stream.logical_shape
    k, _, ci2, co = w.shape
    assert ci == ci2, (stream.logical_shape, tuple(w.shape))
    oy = conv_out_size(h, k, stride, padding)
    ox = conv_out_size(wd, k, stride, padding)
    idx, live = ev.device_plan(tap_row_map,
                               (tuple(stream.logical_shape), k, stride,
                                padding), str(stream.device))
    acc = w.new_zeros((bsz * oy * ox, co))  # f32 for int8 codes too
    for t in range(k * k):
        tap = ev.gather_row_groups(stream.events, idx[t], live[t])
        acc = acc + block_event_linear_from_events(
            tap, w[t // k, t % k], matmul=event_matmul,
            qparams=stream.qparams)
    return _bias(acc.reshape(bsz, oy, ox, co), b)


def _conv2d_events_strip(stream, w, b, cfg: EngineConfig, stride, padding):
    assert stride in ev.STRIP_STRIDES, \
        "strip path covers stride in STRIP_STRIDES (engine.conv2d gates)"
    bsz, h, wd, _ = stream.logical_shape
    k, co = w.shape[0], w.shape[-1]
    y = fused_event_conv2d(stream, w, stride=stride, padding=padding)
    return _bias(y.reshape(bsz, conv_out_size(h, k, stride, padding),
                           conv_out_size(wd, k, stride, padding), co), b)


# -- maxpool2d ----------------------------------------------------------------

def _maxpool_dense(x, k, stride, cfg: EngineConfig):
    assert x.ndim == 4, (tuple(x.shape), "maxpool2d wants an NHWC map")
    return max_pool_nhwc(x, k, stride)


def _maxpool2d_events(stream, k, stride, cfg: EngineConfig):
    return event_max_pool2d(stream, k, stride)


def _maxpool2d_events_window(stream, k, stride, cfg: EngineConfig):
    return event_max_pool2d_window(stream, k, stride)


# -- fire ---------------------------------------------------------------------

def _fire_dense(acc, cfg: EngineConfig):
    """The oracle's fire: threshold, then encode by re-scanning the tiles."""
    c = cfg.for_width(*acc.shape)
    fired = plain_fire(acc, FireConfig(threshold=c.threshold,
                                       magnitude=c.magnitude,
                                       signed=c.signed))
    bev = EventStream.encode(fired, blk_m=c.blk_m, blk_k=c.blk_k,
                             capacity=c.capacity, threshold=0.0,
                             keep_dense=False).events
    return fired, bev


def _fire_events(acc, cfg: EngineConfig):
    """B1's fire, whose occupancy feeds the encode."""
    c = cfg.for_width(*acc.shape)
    return fire_and_encode(acc, blk_m=c.blk_m, blk_k=c.blk_k,
                           threshold=c.threshold,
                           magnitude=c.magnitude or c.signed,
                           capacity=c.capacity)


# -- recurrent_step -----------------------------------------------------------

def _recurrent_wkv6(stream, state, ops, cfg: EngineConfig):
    """B7: the gated WKV6 step on the fired key's events."""
    return wkv6_step_events(stream.events, ops["r"], ops["v"], ops["w"],
                            ops["u"], state, blk_k=stream.blk_k)


def _recurrent_mamba(stream, state, ops, cfg: EngineConfig):
    """B8: the gated Mamba step on the fired gate's events."""
    return mamba_step_events(stream.events, ops["da"], ops["bmat"],
                             ops["cmat"], state, blk_k=stream.blk_k)


# -- registration -------------------------------------------------------------

for _name in ("dense", "scalar"):
    register_backend("linear", _name,
                     functools.partial(_linear, name=_name))
    register_backend("maxpool2d", _name, _maxpool_dense)
    for _op in ("fire", "fire_conv"):
        register_backend(_op, _name, _fire_dense)

for _name in ("block", "cuda"):
    for _op, _fn in (("matmul", _matmul_events),
                     ("linear", functools.partial(_linear, name=_name)),
                     ("linear_events", _linear_events),
                     ("conv2d", _conv2d_events_dense_input),
                     ("conv2d_events", _conv2d_events),
                     ("conv2d_events_strip", _conv2d_events_strip),
                     ("maxpool2d", _maxpool_dense),
                     ("maxpool2d_events", _maxpool2d_events),
                     ("maxpool2d_events_window", _maxpool2d_events_window),
                     ("fire", _fire_events), ("fire_conv", _fire_events),
                     ("recurrent_step_wkv6", _recurrent_wkv6),
                     ("recurrent_step_mamba", _recurrent_mamba)):
        register_backend(_op, _name, _fn)

"""Event-driven convolution — port of ``repro.core.mnf_conv``.

  * ``dense_conv2d``     — the oracle (``F.conv2d``), NHWC input, HWIO
    weights, as in the JAX package.
  * ``scalar_event_conv2d`` — Algorithm 1 verbatim: each non-zero input
    pixel fires an event carrying (value, channel, start_weight,
    start_neuron, x_jump, y_jump) (:func:`event_params_for_pixel`, the
    paper's §4.1.1), and the PE walks the filter over the event's
    receptive outputs, stepping the weight address down by ``stride`` and
    the neuron address up by one — direct address arithmetic.  The JAX
    package walks event by event (``fori_loop``); here every event's k x k
    walk is formed at once and scattered with ``index_add_``, so the order
    of the sums differs.
  * ``tap_event_conv2d`` — the conv as k·k shifted channel matmuls, each
    through the block-event multiply phase.  This is the dense-input path
    the round-trip twin runs; its per-tap ``acc = acc + tap`` order is the
    order the fused strip kernel reproduces bit for bit.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import events as ev
from repro_torch.core.fire import FireConfig, fire
from repro_torch.core.mnf_linear import block_event_linear

__all__ = ["conv_out_size", "dense_conv2d", "event_params_for_pixel",
           "scalar_event_conv2d", "tap_event_conv2d", "mnf_conv2d"]


def conv_out_size(in_size: int, k: int, stride: int, padding: int) -> int:
    return (in_size + 2 * padding - k) // stride + 1


def dense_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: int = 0, b: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Oracle conv.  x (B, H, W, CI), w (KH, KW, CI, CO) -> (B, OY, OX, CO).

    Full f32 needs ``torch.backends.cudnn.allow_tf32 = False`` on a card
    (cuDNN convolutions default to TF32)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding).permute(0, 2, 3, 1)
    y = y.contiguous()
    return y if b is None else y + b


def event_params_for_pixel(iy, ix, *, k: int, stride: int, padding: int,
                           oy_size: int, ox_size: int):
    """The paper's §4.1.1 event fields of input pixel (iy, ix) (ints or
    integer tensors): (start_weight, start_neuron, x_jump, y_jump, oy0,
    ox0, dy0, dx0) as int32 tensors.  The touched outputs are oy in
    [max(0, ceil((iy + p - k + 1) / s)), min(OY - 1, floor((iy + p) / s))]
    (ox alike); ``start_weight`` is the flat filter index at the first
    touched output (the largest filter offset).  The jumps count moves
    (the walk visits jump + 1 positions); an all-clipped pixel has a
    negative jump (no work).  Floor division throughout, as the JAX
    package's ``//``: the ceiling is ``-(-a // s)``."""
    iy = torch.as_tensor(iy, dtype=torch.int32)
    ix = torch.as_tensor(ix, dtype=torch.int32)
    oy0 = torch.clamp(-(-(iy + padding - k + 1) // stride), min=0)
    oy1 = torch.clamp((iy + padding) // stride, max=oy_size - 1)
    ox0 = torch.clamp(-(-(ix + padding - k + 1) // stride), min=0)
    ox1 = torch.clamp((ix + padding) // stride, max=ox_size - 1)
    y_jump = oy1 - oy0
    x_jump = ox1 - ox0
    dy0 = iy + padding - oy0 * stride    # largest filter row offset touched
    dx0 = ix + padding - ox0 * stride
    start_weight = dy0 * k + dx0
    start_neuron = oy0 * ox_size + ox0
    return start_weight, start_neuron, x_jump, y_jump, oy0, ox0, dy0, dx0


def scalar_event_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                        padding: int = 0) -> torch.Tensor:
    """Algorithm 1, one image.  x (H, W, CI), w (K, K, CI, CO) -> (OY, OX,
    CO).

    The events are ``encode_scalar_events(x)`` (capacity H·W·CI), each
    address decoded into (iy, ix, channel).  Walk step (yy, xx) of an
    event reads filter tap ``start_weight - k·yy·s - xx·s`` of its
    channel and adds value x tap into output neuron ``start_neuron +
    OX·yy + xx``, live while yy <= y_jump and xx <= x_jump — the JAX
    package's fixed k x k walk with liveness masks, its addresses taken
    modulo the filter and the map as there."""
    h, wd, ci = x.shape
    k, kw, ci2, co = w.shape
    assert k == kw and ci == ci2, "square filters, matching channels"
    s, p = stride, padding
    oy_size = conv_out_size(h, k, s, p)
    ox_size = conv_out_size(wd, k, s, p)
    evs = ev.encode_scalar_events(x)          # flat over (H, W, CI)
    flat = evs.indices
    ch = flat % ci
    ixx = (flat // ci) % wd
    iyy = flat // (ci * wd)
    start_w, start_n, x_jump, y_jump, *_ = event_params_for_pixel(
        iyy, ixx, k=k, stride=s, padding=p, oy_size=oy_size,
        ox_size=ox_size)
    yy = torch.arange(k, dtype=torch.int32, device=x.device)[:, None, None]
    xx = torch.arange(k, dtype=torch.int32, device=x.device)[None, :, None]
    waddr = start_w - k * yy * s - xx * s                     # (k, k, E)
    naddr = start_n + ox_size * yy + xx
    live = (yy <= y_jump) & (xx <= x_jump)
    dt = torch.promote_types(x.dtype, w.dtype)
    value = torch.where(live, evs.values.to(dt), torch.zeros((), dtype=dt,
                                                             device=x.device))
    taps = w.reshape(k * k, ci, co).to(dt)[(waddr % (k * k)).long(),
                                           ch.long()]         # (k, k, E, CO)
    acc = torch.zeros((oy_size * ox_size, co), dtype=dt, device=x.device)
    acc.index_add_(0, (naddr % (oy_size * ox_size)).reshape(-1).long(),
                   (value[..., None] * taps).reshape(-1, co))
    return acc.reshape(oy_size, ox_size, co)


def tap_event_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     padding: int = 0, blk_m: int = 8, blk_k: int = 8,
                     capacity: int | None = None, threshold: float = 0.0,
                     matmul=None) -> torch.Tensor:
    """Σ_{dy,dx} shift(x) @ W[dy,dx] through block events.

    ``matmul(a, w_tap)`` overrides the per-tap multiply (default: encode +
    the plain event multiply)."""
    bsz, h, wd, ci = x.shape
    k = w.shape[0]
    s, p = stride, padding
    oy, ox = conv_out_size(h, k, s, p), conv_out_size(wd, k, s, p)
    if matmul is None:
        matmul = functools.partial(block_event_linear, blk_m=blk_m,
                                   blk_k=blk_k, capacity=capacity,
                                   threshold=threshold)
    xp = F.pad(x, (0, 0, p, p, p, p))
    acc = x.new_zeros((bsz * oy * ox, w.shape[-1]))
    for dy in range(k):
        for dx in range(k):
            xs = xp[:, dy:dy + (oy - 1) * s + 1:s, dx:dx + (ox - 1) * s + 1:s]
            a = xs.reshape(bsz * oy * ox, ci)
            acc = acc + matmul(a, w[dy, dx])
    return acc.reshape(bsz, oy, ox, -1)


def mnf_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               padding: int = 0, fire_cfg: FireConfig = FireConfig(),
               blk_m: int = 8, blk_k: int = 8) -> torch.Tensor:
    """Full MNF conv layer: the engine's multiply phase, then the fire
    phase.

    Deprecation shim, as in the JAX package — new code calls
    ``repro_torch.engine.conv2d`` with an ``EngineConfig``.  The backend is
    "auto", as in :func:`~repro_torch.core.mnf_linear.mnf_linear`."""
    from repro_torch import engine
    cfg = engine.EngineConfig(blk_m=blk_m, blk_k=blk_k)
    acc = engine.conv2d(x, w, cfg=cfg, stride=stride, padding=padding)
    return fire(acc, fire_cfg)

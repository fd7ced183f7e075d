"""Event-driven convolution — port of ``repro.core.mnf_conv``.

  * ``dense_conv2d``     — the oracle (``F.conv2d``), NHWC input, HWIO
    weights, as in the JAX package.
  * ``tap_event_conv2d`` — the conv as k·k shifted channel matmuls, each
    through the block-event multiply phase.  This is the dense-input path
    the round-trip twin runs; its per-tap ``acc = acc + tap`` order is the
    order the fused strip kernel reproduces bit for bit.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.mnf_linear import block_event_linear

__all__ = ["conv_out_size", "dense_conv2d", "tap_event_conv2d"]


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

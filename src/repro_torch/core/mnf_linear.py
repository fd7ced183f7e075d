"""Event-driven fully-connected layer — paper Algorithm 2, port of
``repro.core.mnf_linear``.

  * ``dense_linear``  — the oracle, y = x @ W (+ b).
  * ``block_event_linear`` / ``block_event_linear_from_events`` — compacted
    K-block events times the weight row-blocks they address, through the
    plain tile dot (``kernels/event_matmul/ref.py``) or any multiply with
    its signature (the ``cuda`` backend hands in the kernel's wrapper).
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels.event_matmul.ref import event_matmul_ref

__all__ = ["dense_linear", "block_event_linear",
           "block_event_linear_from_events"]


def dense_linear(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle: y = x @ W (+ b).  x (..., K), w (K, N)."""
    y = torch.matmul(x, w)
    return y if b is None else y + b


def block_event_linear_from_events(bev: ev.BlockEvents, w: torch.Tensor,
                                   matmul=event_matmul_ref, *,
                                   qparams=None) -> torch.Tensor:
    """Multiply phase on pre-encoded events.  Returns (G * blk_m, N);
    callers slice off row padding.  ``matmul(a_vals, a_idx, counts, w,
    qparams=)`` is the event multiply (plain version by default).  With
    ``qparams`` the values are int8 codes, dequantized at tile load —
    before the slot mask, so padding slots stay exact f32 zeros whatever
    the zero point — and contracted in f32 (DESIGN.md §12)."""
    g, e, bm, bk = bev.values.shape
    wp = ev.pad_to_block_multiple(w, bk, 0)
    assert wp.shape[0] == bev.num_k_blocks * bk, (w.shape, bev.num_k_blocks,
                                                  bk)
    y = matmul(bev.values, bev.block_idx, bev.counts, wp.contiguous(),
               qparams=qparams)
    return y.reshape(g * bm, w.shape[1])


def block_event_linear(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor | None = None, *, blk_m: int = 8,
                       blk_k: int = 128, capacity: int | None = None,
                       threshold: float = 0.0,
                       matmul=event_matmul_ref) -> torch.Tensor:
    """Encode x (M, K) into block events and run the multiply phase."""
    m, k = x.shape
    assert k == w.shape[0], (x.shape, w.shape)
    xp = ev.pad_to_block_multiple(x, blk_m, 0)
    xp = ev.pad_to_block_multiple(xp, blk_k, 1)
    bev = ev.encode_block_events(xp, blk_m=blk_m, blk_k=blk_k,
                                 capacity=capacity, threshold=threshold)
    y = block_event_linear_from_events(bev, w, matmul)[:m]
    return y if b is None else y + b

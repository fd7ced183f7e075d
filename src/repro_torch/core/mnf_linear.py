"""Event-driven fully-connected layer — paper Algorithm 2, port of
``repro.core.mnf_linear``.

  * ``dense_linear``  — the oracle, y = x @ W (+ b).
  * ``scalar_event_linear`` — Algorithm 2 verbatim: each non-zero input
    neuron fires one (value, address) event, and the multiply phase reads
    weight row ``address`` and accumulates value x W[address, :] into every
    output neuron.  The JAX package walks the events one at a time
    (``fori_loop``); here every event's product is formed at once and
    summed over the events, so the order of the sums differs.
  * ``block_event_linear`` / ``block_event_linear_from_events`` — compacted
    K-block events times the weight row-blocks they address, through the
    plain tile dot (``kernels/event_matmul/ref.py``) or any multiply with
    its signature (the ``cuda`` backend hands in the kernel's wrapper).
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core.fire import FireConfig, fire
from repro_torch.kernels.event_matmul.ref import event_matmul_ref

__all__ = ["dense_linear", "scalar_event_linear", "block_event_linear",
           "block_event_linear_from_events", "mnf_linear"]


def dense_linear(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle: y = x @ W (+ b).  x (..., K), w (K, N)."""
    y = torch.matmul(x, w)
    return y if b is None else y + b


def scalar_event_linear(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor | None = None) -> torch.Tensor:
    """Algorithm 2 for a single input vector x (K,), w (K, N) -> (N,).

    The events are ``encode_scalar_events(x)`` (capacity K): each live
    slot carries a value and the neuron address that names its weight
    row (the direct start_weight address); a padding slot carries value 0
    at address 0, an idle PE's no-op, as in the JAX package."""
    assert x.ndim == 1, "scalar-event path is per-activation-vector"
    evs = ev.encode_scalar_events(x)                      # capacity = K
    dt = torch.promote_types(x.dtype, w.dtype)
    rows = w[evs.indices.long()].to(dt)                   # (K, N) weight rows
    acc = (evs.values.to(dt)[:, None] * rows).sum(0)
    return acc if b is None else acc + b


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


def mnf_linear(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None, *,
               fire_cfg: FireConfig = FireConfig(), blk_m: int = 8,
               blk_k: int = 128, capacity: int | None = None
               ) -> torch.Tensor:
    """Full MNF FC layer: the engine's multiply phase, then the fire phase.

    Deprecation shim, as in the JAX package — new code calls
    ``repro_torch.engine.linear`` and ``engine.fire`` with one
    ``EngineConfig``.  The backend is "auto": the block-event dataflow,
    through the kernels on CUDA tensors and their plain versions on CPU
    tensors."""
    from repro_torch import engine
    cfg = engine.EngineConfig(blk_m=blk_m, blk_k=blk_k, capacity=capacity)
    return fire(engine.linear(x, w, b, cfg), fire_cfg)

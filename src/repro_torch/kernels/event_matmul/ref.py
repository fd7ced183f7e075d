"""Plain PyTorch version of the block-event multiply phase (B2, and B5).

``event_matmul_ref`` computes what ``kernel.py`` computes, on any device
(``event_matmul_int8_ref`` the same on int8 codes, B5):

    y[g] = sum_{e < counts[g]} a_vals[g, e] @ W[a_idx[g, e]*bk : +bk, :]

through :func:`tile_dot`, the inner tile dot every bitwise contract of the
port rests on.  It walks e ascending and the bk axis ascending, one
multiply and one add per step, never ``torch.matmul`` (whose CPU lowering
picks an M-dependent reduction order).  A row that is all zero in a tile
adds exact zeros, so a strip tile (8 rows, the union of their live
K-blocks) gives each row the same sum as that row's own pixel events —
strip == per-tap and chained == round-trip hold by construction.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import QParams, dequantize

__all__ = ["event_matmul_int8_ref", "event_matmul_ref", "mask_dead_blocks",
           "tile_dot"]


def mask_dead_blocks(a: torch.Tensor, *, blk_m: int, blk_k: int,
                     threshold: float = 0.0) -> torch.Tensor:
    """Zero the (blk_m, blk_k) tiles of a (M, K) matrix that hold no event
    (no |value| > threshold) — the dense image of what the multiply
    skips."""
    m, k = a.shape
    assert m % blk_m == 0 and k % blk_k == 0, (m, k, blk_m, blk_k)
    tiles = a.reshape(m // blk_m, blk_m, k // blk_k, blk_k)
    live = (tiles.abs() > threshold).any(dim=3, keepdim=True) \
        .any(dim=1, keepdim=True)
    return torch.where(live, tiles, torch.zeros((), dtype=a.dtype,
                                                device=a.device)
                       ).reshape(m, k)


def tile_dot(acc: torch.Tensor, a: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """acc (G, bm, N) + a (G, bm, bk) @ w (G, bk, N), summed over bk in
    ascending order (fixed order, independent of G and bm)."""
    for j in range(a.shape[-1]):
        acc = acc + a[:, :, j:j + 1] * w[:, j:j + 1, :]
    return acc


def event_matmul_ref(a_vals: torch.Tensor, a_idx: torch.Tensor,
                     counts: torch.Tensor, w: torch.Tensor, *,
                     qparams: QParams | None = None) -> torch.Tensor:
    """Plain multiply phase.  a_vals (G, E, bm, bk) f32, a_idx (G, E) int32,
    counts (G,) int32, w (K, N) with K a multiple of bk -> (G, bm, N).
    With ``qparams`` the values are int8 codes: B5's plain version."""
    if qparams is not None:
        return event_matmul_int8_ref(a_vals, a_idx, counts, qparams.scale,
                                     qparams.zero_point, w)
    g, e, bm, bk = a_vals.shape
    k, n = w.shape
    assert k % bk == 0, (w.shape, bk)
    wb = w.reshape(k // bk, bk, n)
    acc = a_vals.new_zeros((g, bm, n))
    e_live = int(counts.max()) if g else 0
    for s in range(min(e, e_live)):
        live = (counts > s)[:, None, None]
        a = torch.where(live, a_vals[:, s], 0.0)
        acc = tile_dot(acc, a, wb[a_idx[:, s].long()])
    return acc


def event_matmul_int8_ref(a_vals: torch.Tensor, a_idx: torch.Tensor,
                          counts: torch.Tensor, scale: torch.Tensor,
                          zero_point: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Plain version of B5: every tile of int8 codes dequantized as
    ``(q - zero_point) * scale`` in f32 — before the slot mask, so padding
    slots stay exact zeros — then B2's plain multiply.  The counterpart of
    ``repro.kernels.event_matmul.ref.event_matmul_int8_ref``, on the
    kernel's own inputs (events, not the dense code matrix)."""
    vals = dequantize(a_vals, QParams(scale=scale, zero_point=zero_point))
    return event_matmul_ref(vals, a_idx, counts, w)

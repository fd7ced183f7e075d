"""Plain PyTorch version of the block-event multiply phase (B2).

``event_matmul_ref`` computes what ``kernel.py`` computes, on any device:

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

__all__ = ["event_matmul_ref", "tile_dot"]


def tile_dot(acc: torch.Tensor, a: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """acc (G, bm, N) + a (G, bm, bk) @ w (G, bk, N), summed over bk in
    ascending order (fixed order, independent of G and bm)."""
    for j in range(a.shape[-1]):
        acc = acc + a[:, :, j:j + 1] * w[:, j:j + 1, :]
    return acc


def event_matmul_ref(a_vals: torch.Tensor, a_idx: torch.Tensor,
                     counts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain multiply phase.  a_vals (G, E, bm, bk) f32, a_idx (G, E) int32,
    counts (G,) int32, w (K, N) with K a multiple of bk -> (G, bm, N)."""
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

"""The event multiply phase of the event backends (B2, and B5 on int8 codes).

``event_matmul`` is the wrapper of ``csrc/event_matmul.cu``, which replaces
``repro.kernels.event_matmul.kernel.event_matmul_pallas``, and
``event_matmul_dequant`` the wrapper of its int8 entry, which replaces
``event_matmul_int8_pallas``: a CUDA tensor launches the kernel and counts
it (``kernels.note_launch``); a CPU tensor takes the plain version
(``ref.py``).  Bound on the card: bytes at the FC layers (each live event
reads a (bk, N) weight row-block), f32 FMA issue at the per-tap conv
layers.  ``event_matmul`` serves the FC layers (``linear_events``), the
per-tap conv path (``conv2d_events``), and the round-trip twin's
dense-input ``linear`` and ``conv2d``, which encode first so the twin
multiplies the same tiles in the same order; handed ``qparams``, it sends
the int8 codes to ``event_matmul_dequant``.  ``event_matmul_int8`` is the
dense entry of the int8 lowering: encode a code matrix, then B5.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core.quantize import QParams
from repro_torch.kernels import kernel_wrapper, note_launch
from repro_torch.kernels.event_matmul.kernel import (event_matmul_cuda,
                                                    event_matmul_int8_cuda)
from repro_torch.kernels.event_matmul.ref import (event_matmul_int8_ref,
                                                  event_matmul_ref)

__all__ = ["event_matmul", "event_matmul_dequant", "event_matmul_int8",
           "matmul_work"]


def matmul_work(a_vals: torch.Tensor, a_idx: torch.Tensor,
                counts: torch.Tensor, w: torch.Tensor,
                qbytes: int = 0) -> tuple[int, float]:
    """Bytes and operations of one B2 (or B5) launch on these events: each
    live event tile (in its own type: an int8 code is one byte) and its
    address read once, the counts, each distinct live K-block's (bk, N)
    weight rows once, the (G, bm, N) f32 output written, ``qbytes`` for
    the dequantization's scale and zero point; a multiply and an add per
    element of each live tile times N."""
    g, e, bm, bk = a_vals.shape
    n = w.shape[1]
    cnt = counts.clamp(max=e).long()
    live = torch.arange(e, device=cnt.device)[None, :] < cnt[:, None]
    slots = int(cnt.sum())
    blocks = int(torch.unique(a_idx[live]).numel())
    nbytes = slots * (bm * bk * a_vals.element_size() + 4) + g * 4 \
        + blocks * bk * n * 4 + g * bm * n * 4 + qbytes
    return nbytes, 2.0 * slots * bm * bk * n


@kernel_wrapper(lambda out, a_vals, a_idx, counts, w, *, qparams=None:
                matmul_work(a_vals, a_idx, counts, w,
                            qbytes=0 if qparams is None else 8))
def event_matmul(a_vals: torch.Tensor, a_idx: torch.Tensor,
                 counts: torch.Tensor, w: torch.Tensor, *,
                 qparams: QParams | None = None) -> torch.Tensor:
    """(G, bm, N) = sum_{e < counts[g]} a_vals[g, e] @ W[a_idx[g, e]·bk:+bk];
    with ``qparams`` the values are int8 codes (B5)."""
    if qparams is not None:
        return event_matmul_dequant(a_vals, a_idx, counts, qparams.scale,
                                    qparams.zero_point, w)
    if a_vals.device.type == "cpu":
        return event_matmul_ref(a_vals, a_idx, counts, w)
    out = event_matmul_cuda(a_vals.contiguous(), a_idx.contiguous(),
                            counts.contiguous(), w.contiguous())
    note_launch(event_matmul, (a_vals, a_idx, counts, w), {})
    return out


@kernel_wrapper(lambda out, a_vals, a_idx, counts, scale, zero_point, w:
                matmul_work(a_vals, a_idx, counts, w, qbytes=8))
def event_matmul_dequant(a_vals: torch.Tensor, a_idx: torch.Tensor,
                         counts: torch.Tensor, scale: torch.Tensor,
                         zero_point: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """B5: the event multiply on int8 codes, each tile dequantized at load
    as (q - zero_point) * scale and contracted in f32 — bitwise B2 fed the
    dequantized tiles."""
    args = (a_vals, a_idx, counts, scale, zero_point, w)
    if a_vals.device.type == "cpu":
        return event_matmul_int8_ref(*args)
    out = event_matmul_int8_cuda(*(t.contiguous() for t in args))
    note_launch(event_matmul_dequant, args, {})
    return out


def event_matmul_int8(q: torch.Tensor, w: torch.Tensor, qparams: QParams, *,
                      blk_m: int = 8, blk_k: int = 128,
                      capacity: int | None = None) -> torch.Tensor:
    """y = dequant(q) @ W on int8 codes q (M, K): encode the codes at
    threshold 0 (a tile is live iff it holds a non-zero code), then B5."""
    m, k = q.shape
    assert k == w.shape[0], (tuple(q.shape), tuple(w.shape))
    assert q.dtype == torch.int8, q.dtype
    qp2 = ev.pad_to_block_multiple(q, blk_m, 0)
    qp2 = ev.pad_to_block_multiple(qp2, blk_k, 1)
    wp = ev.pad_to_block_multiple(w, blk_k, 0)
    bev = ev.encode_block_events(qp2, blk_m=blk_m, blk_k=blk_k,
                                 capacity=capacity, threshold=0.0)
    y = event_matmul(bev.values, bev.block_idx, bev.counts, wp.contiguous(),
                     qparams=qparams)
    return y.reshape(-1, w.shape[1])[:m]

"""The event multiply phase of the event backends (B2).

``event_matmul`` is the wrapper of ``csrc/event_matmul.cu``, which replaces
``repro.kernels.event_matmul.kernel.event_matmul_pallas``: a CUDA tensor
launches the kernel and counts it (``kernels.note_launch``); a CPU
tensor takes the plain version (``ref.py``).  Bound on the card: bytes at
the FC layers (each live event reads a (bk, N) weight row-block), f32 FMA
issue at the per-tap conv layers.  It serves the FC layers
(``linear_events``), the per-tap conv path (``conv2d_events``), and the
round-trip twin's dense-input ``linear`` and ``conv2d``, which encode
first so the twin multiplies the same tiles in the same order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import note_launch
from repro_torch.kernels.event_matmul.kernel import event_matmul_cuda
from repro_torch.kernels.event_matmul.ref import event_matmul_ref

__all__ = ["event_matmul"]


def event_matmul(a_vals: torch.Tensor, a_idx: torch.Tensor,
                 counts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, bm, N) = sum_{e < counts[g]} a_vals[g, e] @ W[a_idx[g, e]·bk:+bk]."""
    if a_vals.device.type == "cpu":
        return event_matmul_ref(a_vals, a_idx, counts, w)
    out = event_matmul_cuda(a_vals.contiguous(), a_idx.contiguous(),
                            counts.contiguous(), w.contiguous())
    note_launch(event_matmul, (a_vals, a_idx, counts, w), {})
    return out


event_matmul.launches = 0
event_matmul.capture = None

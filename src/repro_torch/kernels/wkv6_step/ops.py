"""The fire-gated WKV6 decode step of the event backends (B7).

``wkv6_step_events`` is the wrapper of ``csrc/wkv6_step.cu``, which
replaces ``repro.kernels.wkv6.step.wkv6_step_events_pallas``: a CUDA
tensor launches the kernel, which derives the live mask from the events
itself, and counts it (``kernels.note_launch``): no other op runs; a CPU
tensor takes the plain version (``ref.py``).  Bound on the card: bytes
(the f32 state read and written once per row).
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import note_launch
from repro_torch.kernels.wkv6_step.kernel import wkv6_step_cuda
from repro_torch.kernels.wkv6_step.ref import wkv6_step_events_ref

__all__ = ["wkv6_step_events"]


def wkv6_step_events(bev: ev.BlockEvents, r: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, s: torch.Tensor, *,
                     blk_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One gated step.  bev: blk_m == 1 events of the fired key drive
    (G, D); r, v, w, u (G, D) f32; s (G, D, D) f32.  Returns (o, s_new):
    S' bitwise the plain version's, o within f32 summation order."""
    if r.device.type == "cpu":
        return wkv6_step_events_ref(bev, r, v, w, u, s, blk_k=blk_k)
    if bev.values.shape[-1] != blk_k:
        raise ValueError(f"events of width {bev.values.shape[-1]} handed "
                         f"with blk_k={blk_k}")
    out = wkv6_step_cuda(*(t.contiguous() for t in (
        bev.values, bev.block_idx, bev.counts, r, v, w, u, s)),
        nkb=bev.num_k_blocks)
    note_launch(wkv6_step_events, (bev, r, v, w, u, s), dict(blk_k=blk_k))
    return out


wkv6_step_events.launches = 0
wkv6_step_events.capture = None

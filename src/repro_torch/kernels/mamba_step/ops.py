"""The fire-gated Mamba decode step of the event backends (B8).

``mamba_step_events`` is the wrapper of ``csrc/mamba_step.cu``, which
replaces ``repro.kernels.mamba_scan.step.mamba_step_events_pallas``: a
CUDA tensor launches the kernel, which derives the live mask from the
events itself, and counts it (``kernels.note_launch``): no other op runs;
a CPU tensor takes the plain version (``ref.py``).  Bound on the card:
bytes (the f32 state and decay read and the state written once per row).
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import note_launch
from repro_torch.kernels.mamba_step.kernel import mamba_step_cuda
from repro_torch.kernels.mamba_step.ref import mamba_step_events_ref

__all__ = ["mamba_step_events"]


def mamba_step_events(bev: ev.BlockEvents, da: torch.Tensor,
                      bmat: torch.Tensor, cmat: torch.Tensor,
                      h: torch.Tensor, *,
                      blk_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One gated step.  bev: blk_m == 1 events of the fired gate (B, DI);
    da, h (B, DI, N) f32; bmat, cmat (B, N) f32.  Returns (y, h_new): h'
    bitwise the plain version's, y within f32 summation order."""
    if h.device.type == "cpu":
        return mamba_step_events_ref(bev, da, bmat, cmat, h, blk_k=blk_k)
    if bev.values.shape[-1] != blk_k:
        raise ValueError(f"events of width {bev.values.shape[-1]} handed "
                         f"with blk_k={blk_k}")
    out = mamba_step_cuda(*(t.contiguous() for t in (
        bev.values, bev.block_idx, bev.counts, da, bmat, cmat, h)),
        nkb=bev.num_k_blocks)
    note_launch(mamba_step_events, (bev, da, bmat, cmat, h),
                dict(blk_k=blk_k))
    return out


mamba_step_events.launches = 0
mamba_step_events.capture = None

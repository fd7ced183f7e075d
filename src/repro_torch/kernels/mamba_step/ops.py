"""The fire-gated Mamba decode step of the event backends (B8).

``mamba_step_events`` is the wrapper of ``csrc/mamba_step.cu``, which
replaces ``repro.kernels.mamba_scan.step.mamba_step_events_pallas``: a
CUDA tensor launches the kernel, which derives the live mask from the
events itself, and counts it (``kernels.note_launch``): no other op runs;
a CPU tensor takes the plain version (``ref.py``); a meta tensor (the
dry run) gives empty outputs and launches nothing.  Bound on the card:
bytes (the f32 state and decay read and the state written once per row).
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import kernel_wrapper, note_launch, on_meta
from repro_torch.kernels.mamba_step.kernel import mamba_step_cuda
from repro_torch.kernels.mamba_step.ref import mamba_step_events_ref

__all__ = ["mamba_step_events", "mamba_work"]


def mamba_work(bev: ev.BlockEvents, h: torch.Tensor) -> tuple[int, float]:
    """Bytes and operations one B8 launch needs on these events: h and dA
    read and h' written once, B and C read and y written, each live event
    tile and address, and counts (the kernel derives the live mask
    itself); a multiply per state element (decay), a multiply and an add
    per element for the readout, a multiply and an add per element of
    each live block (increment)."""
    b, di, n = h.shape
    _, e, _, bk = bev.values.shape
    # on meta tensors (the dry run) every slot counts as live
    slots = bev.counts.numel() * e if on_meta(bev.counts) \
        else int(bev.counts.clamp(max=e).sum())
    nbytes = 3 * b * di * n * 4 + 2 * b * n * 4 + b * di * 4 \
        + slots * (bk * 4 + 4) + b * 4
    return nbytes, 3.0 * b * di * n + 2.0 * slots * bk * n


@kernel_wrapper(lambda out, bev, da, bmat, cmat, h, **kw: mamba_work(bev, h))
def mamba_step_events(bev: ev.BlockEvents, da: torch.Tensor,
                      bmat: torch.Tensor, cmat: torch.Tensor,
                      h: torch.Tensor, *,
                      blk_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One gated step.  bev: blk_m == 1 events of the fired gate (B, DI);
    da, h (B, DI, N) f32; bmat, cmat (B, N) f32.  Returns (y, h_new): h'
    bitwise the plain version's, y within f32 summation order."""
    if h.device.type == "cpu":
        return mamba_step_events_ref(bev, da, bmat, cmat, h, blk_k=blk_k)
    if on_meta(h):
        return (torch.empty(h.shape[:2], dtype=torch.float32, device="meta"),
                torch.empty(h.shape, dtype=h.dtype, device="meta"))
    if bev.values.shape[-1] != blk_k:
        raise ValueError(f"events of width {bev.values.shape[-1]} handed "
                         f"with blk_k={blk_k}")
    out = mamba_step_cuda(*(t.contiguous() for t in (
        bev.values, bev.block_idx, bev.counts, da, bmat, cmat, h)),
        nkb=bev.num_k_blocks)
    note_launch(mamba_step_events, (bev, da, bmat, cmat, h),
                dict(blk_k=blk_k))
    return out

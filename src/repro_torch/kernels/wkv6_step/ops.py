"""The fire-gated WKV6 decode step of the event backends (B7).

``wkv6_step_events`` is the wrapper of ``csrc/wkv6_step.cu``, which
replaces ``repro.kernels.wkv6.step.wkv6_step_events_pallas``: a CUDA
tensor launches the kernel, which derives the live mask from the events
itself, and counts it (``kernels.note_launch``): no other op runs; a CPU
tensor takes the plain version (``ref.py``); a meta tensor (the dry run)
gives empty outputs and launches nothing.  Bound on the card: bytes
(the f32 state read and written once per row).
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import kernel_wrapper, note_launch, on_meta
from repro_torch.kernels.wkv6_step.kernel import wkv6_step_cuda
from repro_torch.kernels.wkv6_step.ref import wkv6_step_events_ref

__all__ = ["wkv6_step_events", "wkv6_work"]


def wkv6_work(bev: ev.BlockEvents, r: torch.Tensor) -> tuple[int, float]:
    """Bytes and operations one B7 launch needs on these events: the
    state read and written once, r, v, w, u read and o written, each live
    event tile and address, and counts (the kernel derives the live mask
    itself); a multiply per state element (decay), a multiply-add per
    element for the readout, a multiply and an add per element of each
    live block (increment)."""
    g, d = r.shape
    _, e, _, bk = bev.values.shape
    # on meta tensors (the dry run) every slot counts as live
    slots = bev.counts.numel() * e if on_meta(bev.counts) \
        else int(bev.counts.clamp(max=e).sum())
    nbytes = 2 * g * d * d * 4 + 5 * g * d * 4 + slots * (bk * 4 + 4) \
        + g * 4
    return nbytes, 3.0 * g * d * d + 2.0 * slots * bk * d + 5.0 * g * d


@kernel_wrapper(lambda out, bev, r, *args, **kw: wkv6_work(bev, r))
def wkv6_step_events(bev: ev.BlockEvents, r: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, s: torch.Tensor, *,
                     blk_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One gated step.  bev: blk_m == 1 events of the fired key drive
    (G, D); r, v, w, u (G, D) f32; s (G, D, D) f32.  Returns (o, s_new):
    S' bitwise the plain version's, o within f32 summation order."""
    if r.device.type == "cpu":
        return wkv6_step_events_ref(bev, r, v, w, u, s, blk_k=blk_k)
    if on_meta(r):
        return (torch.empty(r.shape, dtype=torch.float32, device="meta"),
                torch.empty(s.shape, dtype=s.dtype, device="meta"))
    if bev.values.shape[-1] != blk_k:
        raise ValueError(f"events of width {bev.values.shape[-1]} handed "
                         f"with blk_k={blk_k}")
    out = wkv6_step_cuda(*(t.contiguous() for t in (
        bev.values, bev.block_idx, bev.counts, r, v, w, u, s)),
        nkb=bev.num_k_blocks)
    note_launch(wkv6_step_events, (bev, r, v, w, u, s), dict(blk_k=blk_k))
    return out

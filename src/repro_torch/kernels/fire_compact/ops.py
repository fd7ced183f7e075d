"""Fire phase + event re-encode: the event backends' ``fire`` op.

``fire_compact`` is the wrapper of kernel B1 (``csrc/fire_compact.cu``,
replacing ``repro.kernels.fire_compact.kernel.fire_compact_pallas``): a
CUDA tensor launches the kernel and counts it (``kernels.note_launch``);
a CPU tensor takes the plain version (``ref.py``).  Bound on the card:
bytes — read the accumulator once, write the fired map once.

``fire_and_encode`` feeds the kernel's occupancy into the encode as the
tile liveness, so the accumulator is scanned once.  The BlockEvents equal
those of encoding the fired map at threshold 0 (a tile fires iff it holds
a non-zero fired value), except under fake-quant, where rounding can zero
a fired value and the encode re-scans.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import kernel_wrapper, note_launch
from repro_torch.kernels.fire_compact.kernel import fire_compact_cuda
from repro_torch.kernels.fire_compact.ref import fire_compact_ref

__all__ = ["fire_and_encode", "fire_compact", "fire_work"]


def fire_work(acc: torch.Tensor, *, blk_m: int, blk_k: int,
              **_) -> tuple[int, float]:
    """Bytes and operations of one B1 launch: the accumulator read and the
    fired map written once (f32), one int32 occupancy a tile; a compare a
    value."""
    n = acc.numel()
    return n * 8 + n // (blk_m * blk_k) * 4, float(n)


@kernel_wrapper(lambda out, acc, **kw: fire_work(acc, **kw))
def fire_compact(acc: torch.Tensor, *, blk_m: int, blk_k: int,
                 threshold: float = 0.0, magnitude: bool = False,
                 qscale: float | None = None):
    """(fired (M, K), occupancy (M/blk_m, K/blk_k) int32); M and K are
    multiples of the tile."""
    kw = dict(blk_m=blk_m, blk_k=blk_k, threshold=threshold,
              magnitude=magnitude, qscale=qscale)
    if acc.device.type == "cpu":
        return fire_compact_ref(acc, **kw)
    out = fire_compact_cuda(acc.contiguous(), **kw)
    note_launch(fire_compact, (acc,), kw)
    return out


def fire_and_encode(acc: torch.Tensor, *, blk_m: int, blk_k: int,
                    threshold: float = 0.0, magnitude: bool = False,
                    capacity: int | None = None, qscale: float | None = None):
    """Fire an (M, K) accumulator and encode the next layer's events.
    Returns (fired (M, K), BlockEvents over the tile-padded matrix)."""
    m, k = acc.shape
    ap = ev.pad_to_block_multiple(acc, blk_m, 0)
    ap = ev.pad_to_block_multiple(ap, blk_k, 1)
    fired, occ = fire_compact(ap, blk_m=blk_m, blk_k=blk_k,
                              threshold=threshold, magnitude=magnitude,
                              qscale=qscale)
    bev = ev.encode_block_events(fired, blk_m=blk_m, blk_k=blk_k,
                                 capacity=capacity, threshold=0.0,
                                 live=None if qscale else occ)
    return fired[:m, :k], bev

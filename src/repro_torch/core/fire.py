"""Fire phase (paper §4.2): threshold the accumulator and emit events.

Port of ``repro.core.fire``.  With threshold 0 the fire is exactly ReLU, so
the event-driven network computes the dense network's function.  This is
the plain tensor version; ``kernels/fire_compact`` is the fused kernel
(threshold + per-tile occupancy in one pass).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import events as ev
from repro_torch.core import quantize as qz

__all__ = ["FireConfig", "fire", "fire_stats", "fire_to_block_events"]


@dataclasses.dataclass(frozen=True)
class FireConfig:
    """threshold: fire iff a > threshold (|a| > threshold when ``magnitude``
    or ``signed``); ``signed`` flags a stream that may carry negative
    events; ``quantize_to_int8`` requantizes the fired map to 8 bits (the
    paper's accumulate -> int8 step, DESIGN.md §12)."""

    threshold: float = 0.0
    magnitude: bool = False
    signed: bool = False
    quantize_to_int8: bool = False


def fire(acc: torch.Tensor, cfg: FireConfig = FireConfig(),
         out_qp: qz.QParams | None = None) -> torch.Tensor:
    """Dense fired tensor: acc where it fires, exact 0 elsewhere; with
    ``quantize_to_int8`` the fake-quant round trip under ``out_qp``
    (calibrated over the fired map when None)."""
    if cfg.magnitude or cfg.signed:
        live = acc.abs() > cfg.threshold
    else:
        live = acc > cfg.threshold
    fired = torch.where(live, acc, 0.0)
    if cfg.quantize_to_int8:
        qp = out_qp if out_qp is not None else qz.calibrate(fired)
        fired = qz.fake_quant(fired, qp)
    return fired


def fire_stats(acc: torch.Tensor, cfg: FireConfig = FireConfig()):
    """(fired tensor, events fired (0-d int64), density (0-d f32)) — cost
    model instrumentation."""
    fired = fire(acc, cfg)
    n = ev.count_nonzero_events(fired)
    return fired, n, n / acc.numel()


def fire_to_block_events(acc: torch.Tensor, *, blk_m: int, blk_k: int,
                         cfg: FireConfig = FireConfig(),
                         capacity: int | None = None
                         ) -> tuple[torch.Tensor, ev.BlockEvents]:
    """Fire an (M, K_next) accumulator laid out as the next layer's input
    and re-encode it as that layer's block events: (dense fired tensor,
    BlockEvents)."""
    fired = fire(acc, cfg)
    bev = ev.encode_block_events(fired, blk_m=blk_m, blk_k=blk_k,
                                 capacity=capacity, threshold=0.0)
    return fired, bev

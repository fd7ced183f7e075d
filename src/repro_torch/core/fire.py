"""Fire phase (paper §4.2): threshold the accumulator and emit events.

Port of ``repro.core.fire``.  With threshold 0 the fire is exactly ReLU, so
the event-driven network computes the dense network's function.  This is
the plain tensor version; ``kernels/fire_compact`` is the fused kernel
(threshold + per-tile occupancy in one pass).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["FireConfig", "fire"]


@dataclasses.dataclass(frozen=True)
class FireConfig:
    """threshold: fire iff a > threshold (|a| > threshold when ``magnitude``
    or ``signed``); ``signed`` flags a stream that may carry negative
    events.  ``quantize_to_int8`` (int8 event values, DESIGN.md §12) is not
    ported yet (ROADMAP A7)."""

    threshold: float = 0.0
    magnitude: bool = False
    signed: bool = False
    quantize_to_int8: bool = False

    def __post_init__(self):
        if self.quantize_to_int8:
            raise NotImplementedError(
                "int8 event values are not ported yet (ROADMAP A7)")


def fire(acc: torch.Tensor, cfg: FireConfig = FireConfig()) -> torch.Tensor:
    """Dense fired tensor: acc where it fires, exact 0 elsewhere."""
    if cfg.magnitude or cfg.signed:
        live = acc.abs() > cfg.threshold
    else:
        live = acc > cfg.threshold
    return torch.where(live, acc, 0.0)

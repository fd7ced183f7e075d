"""Fire phase (paper §4.2): threshold the accumulator and emit events.

Port of ``repro.core.fire``.  With threshold 0 the fire is exactly ReLU, so
the event-driven network computes the dense network's function.  This is
the plain tensor version; ``kernels/fire_compact`` is the fused kernel
(threshold + per-tile occupancy in one pass).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quantize as qz

__all__ = ["FireConfig", "fire"]


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

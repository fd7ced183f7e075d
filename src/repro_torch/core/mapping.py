"""PE mapping technique — paper §5.3 (Eq. 1, Eq. 2, Fig. 7), port of
``repro.core.mapping``.

Sizes the PE grid of the paper's ASIC for a layer given per-PE SRAM
capacities.  Paper defaults (Table 3): 11 PEs, 27 multipliers/PE, weight
SRAM 691.2 KB, accumulate SRAM 67.5 KB, 8-bit weights, 32-bit partial sums.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["PECapacity", "PAPER_PE", "conv_pes", "fc_pes", "noc_grid",
           "LayerMapping", "plan_conv_layer", "plan_fc_layer"]


@dataclasses.dataclass(frozen=True)
class PECapacity:
    """Per-PE storage limits, in element counts (N neurons, W weights)."""

    neurons: int   # accumulate SRAM capacity / 4B psum  (paper: N)
    weights: int   # weight SRAM capacity / 1B weight    (paper: W)

    @staticmethod
    def from_table3() -> "PECapacity":
        # Table 3: weight SRAM 691.2 KB @ 8-bit weights; accumulate SRAM
        # 67.5 KB @ 32-bit partial sums.
        return PECapacity(neurons=int(67.5 * 1024 // 4),
                          weights=int(691.2 * 1024))


PAPER_PE = PECapacity.from_table3()


def conv_pes(out_w: int, out_h: int, k: int, c_out: int, c_in: int,
             cap: PECapacity = PAPER_PE, *, paper_verbatim: bool = False) -> int:
    """Eq. 1: C_PEs = max(w·h/N, k·k·c/W) (ceil).

    The paper's Eq. 1 counts weights as k·k·c with c = #filters (its worked
    example has c_in = 1); ``paper_verbatim=True`` reproduces that exactly.
    The default counts k·k·c_in·c_out weights and w·h·c_out output neurons,
    which matches the paper's Fig. 7 example (two 28×28 OFMs, N=800 ⇒ 2
    PEs).
    """
    if paper_verbatim:
        neurons_needed = out_w * out_h
        weights_needed = k * k * c_out
    else:
        neurons_needed = out_w * out_h * c_out
        weights_needed = k * k * c_in * c_out
    return max(math.ceil(neurons_needed / cap.neurons),
               math.ceil(weights_needed / cap.weights), 1)


def fc_pes(m: int, n: int, cap: PECapacity = PAPER_PE) -> int:
    """Eq. 2: F_PEs = max(n/N, m·n/W) (ceil).  Paper example: 1568×128 FC
    with N=800, W=9000 ⇒ max(1, 23) = 23 PEs."""
    return max(math.ceil(n / cap.neurons), math.ceil(m * n / cap.weights), 1)


def noc_grid(pes: int) -> tuple[int, int]:
    """PEs arranged in a ⌈√PEs⌉ × ⌈√PEs⌉ NoC grid (paper §5.3)."""
    side = math.ceil(math.sqrt(pes))
    return side, side


@dataclasses.dataclass(frozen=True)
class LayerMapping:
    pes: int
    grid: tuple[int, int]
    neurons_per_pe: int
    weights_per_pe: int
    # events are multicast to every PE holding a slice of the layer (NoC
    # multicast); the fan-out feeds the cost model's NoC term
    event_fanout: int


def plan_conv_layer(out_w: int, out_h: int, k: int, c_out: int, c_in: int,
                    cap: PECapacity = PAPER_PE) -> LayerMapping:
    pes = conv_pes(out_w, out_h, k, c_out, c_in, cap)
    return LayerMapping(
        pes=pes, grid=noc_grid(pes),
        neurons_per_pe=math.ceil(out_w * out_h * c_out / pes),
        weights_per_pe=math.ceil(k * k * c_in * c_out / pes),
        event_fanout=pes)


def plan_fc_layer(m: int, n: int, cap: PECapacity = PAPER_PE) -> LayerMapping:
    pes = fc_pes(m, n, cap)
    return LayerMapping(
        pes=pes, grid=noc_grid(pes),
        neurons_per_pe=math.ceil(n / pes),
        weights_per_pe=math.ceil(m * n / pes),
        event_fanout=pes)

"""MNF and dense cycle models — the subset of ``repro.costmodel.accelerators``
the routing decision (``costmodel/crossover.py``) needs.

Normalized to the paper's hardware budget (Table 3: 11 PEs × 27 multipliers
= 297 MACs @ 200 MHz).  These are model cycles for routing estimates, not a
time on any device.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["HWBudget", "PAPER_HW", "mnf_channel_util", "mnf_layer_cycles",
           "dense_layer_cycles"]


@dataclasses.dataclass(frozen=True)
class HWBudget:
    pes: int = 11
    mac_modules_per_pe: int = 9
    mults_per_module: int = 3
    freq_hz: float = 200e6

    @property
    def total_macs(self) -> int:
        return self.pes * self.mac_modules_per_pe * self.mults_per_module


PAPER_HW = HWBudget()


def mnf_channel_util(c_out: int, w_density: float = 1.0,
                     hw: HWBudget = PAPER_HW) -> float:
    """Multiplier utilization from the channel remainder (Fig. 2)."""
    c_eff = max(c_out * w_density, 1.0)
    per_pe = max(math.ceil(c_eff / hw.pes), 1)
    swept = math.ceil(per_pe / hw.mults_per_module) * hw.mults_per_module
    return per_pe / swept


def mnf_layer_cycles(n_events: float, avg_touched: float, c_out: int,
                     hw: HWBudget = PAPER_HW, w_density: float = 1.0
                     ) -> float:
    """Cycles of one conv/FC layer: events × touched outputs × C_out over
    the MAC array, degraded by the channel-remainder utilization."""
    work = n_events * avg_touched * c_out * w_density
    return work / (hw.total_macs * mnf_channel_util(c_out, w_density, hw))


def dense_layer_cycles(dense_macs: float, hw: HWBudget = PAPER_HW) -> float:
    """Ideal dense engine at full utilization."""
    return dense_macs / hw.total_macs

"""Cycle models: MNF and the baselines it is compared against (Fig. 8) —
port of ``repro.costmodel.accelerators``, number for number.

All accelerators are normalized to the paper's hardware budget (Table 3:
11 PEs × 27 multipliers = 297 MACs @ 200 MHz), as the paper does ("we
estimated the number of cycles ... using the same hardware
configuration").  These are model cycles of the paper's ASIC, not a time
on any device.

MNF cycle model (from §5.2.3's dispatch): an event is broadcast to all
PEs; output channels are striped across PEs; each PE covers its channel
slice with mults-per-module multipliers per filter position per cycle, so
the only loss is the channel remainder (Fig. 2's ripples).

Baselines use each design's published work formulation (which sparsity it
exploits) and the utilization-vs-sparsity behaviour the paper reports for
them in §1/§3 (SNAP <75% beyond 50% sparsity, SCNN <60% beyond 60%, GoSPA
<45% at 90%), interpolated piecewise-linearly between anchor points, times
a front-end efficiency constant per design calibrated once on Fig. 8's
VGG16 ratios and held fixed for AlexNet.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["HWBudget", "PAPER_HW", "mnf_channel_util", "mnf_layer_cycles",
           "mnf_utilization", "dense_layer_cycles", "baseline_layer_cycles",
           "UTIL_CURVES", "FRONTEND_EFF", "network_cycles"]


@dataclasses.dataclass(frozen=True)
class HWBudget:
    pes: int = 11
    mac_modules_per_pe: int = 9      # filter positions processed in parallel
    mults_per_module: int = 3        # channels processed per module per cycle
    freq_hz: float = 200e6

    @property
    def total_macs(self) -> int:
        return self.pes * self.mac_modules_per_pe * self.mults_per_module


PAPER_HW = HWBudget()


# ---------------------------------------------------------------------------
# MNF
# ---------------------------------------------------------------------------

def mnf_channel_util(c_out: int, w_density: float = 1.0,
                     hw: HWBudget = PAPER_HW) -> float:
    """Multiplier utilization from the channel remainder (Fig. 2): the last
    sweep of a PE's (compressed) channel slice is partly filled when the
    slice is not a multiple of the module width."""
    c_eff = max(c_out * w_density, 1.0)
    per_pe = max(math.ceil(c_eff / hw.pes), 1)
    swept = math.ceil(per_pe / hw.mults_per_module) * hw.mults_per_module
    return per_pe / swept


def mnf_layer_cycles(n_events: float, avg_touched: float, c_out: int,
                     hw: HWBudget = PAPER_HW, w_density: float = 1.0
                     ) -> float:
    """Cycles of one conv/FC layer: ``n_events`` input events × the filter
    positions each touches (``avg_touched``, 1 for FC) × ``c_out`` ×
    ``w_density`` (pruned weights occupy no multiplier slot) over the MAC
    array, degraded by the channel-remainder utilization.  The OFM is
    striped over the PEs (§5.3), so distinct events proceed in parallel."""
    work = n_events * avg_touched * c_out * w_density
    util = mnf_channel_util(c_out, w_density, hw)
    return work / (hw.total_macs * util)


def mnf_utilization(n_events: float, avg_touched: float, c_out: int,
                    useful_macs: float, hw: HWBudget = PAPER_HW) -> float:
    cycles = mnf_layer_cycles(n_events, avg_touched, c_out, hw)
    if cycles == 0:
        return 1.0
    return min(1.0, useful_macs / (cycles * hw.total_macs))


def dense_layer_cycles(dense_macs: float, hw: HWBudget = PAPER_HW) -> float:
    """Ideal dense engine at full utilization (lower bound reference)."""
    return dense_macs / hw.total_macs


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def _piecewise(points):
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]

    def f(x):
        if x <= xs[0]:
            return ys[0]
        for i in range(1, len(xs)):
            if x <= xs[i]:
                t = (x - xs[i - 1]) / (xs[i] - xs[i - 1])
                return ys[i - 1] + t * (ys[i] - ys[i - 1])
        return ys[-1]

    return f


#: Utilization as a function of combined sparsity (1 - d_act·d_w), anchored
#: on the figures the paper quotes for each design (§1, §3).
UTIL_CURVES = {
    # SCNN: "<60% with sparsity of more than 60%"
    "scnn": _piecewise([(0.0, 0.92), (0.6, 0.60), (0.9, 0.35), (1.0, 0.2)]),
    # SparTen: between SCNN and GoSPA (MICRO'19 reports ~0.6-0.8 mid range)
    "sparten": _piecewise([(0.0, 0.95), (0.5, 0.80), (0.9, 0.45), (1.0, 0.3)]),
    # GoSPA: "<45% with a sparsity of 90%"
    "gospa": _piecewise([(0.0, 0.95), (0.5, 0.78), (0.9, 0.45), (1.0, 0.35)]),
    # SNAP (Fig 2 comparison): "<75% beyond 50% sparsity"
    "snap": _piecewise([(0.0, 0.98), (0.5, 0.75), (0.75, 0.55), (1.0, 0.35)]),
}

#: Front-end pipeline efficiency (valid-pair identification, output scatter
#: contention), one constant per design, calibrated once against Fig. 8's
#: VGG16 ratios (19.0/8.31/3.15/2.57x) and held fixed for AlexNet.
#: SCNN-Dense runs the dense workload through SCNN's cartesian tiling.
FRONTEND_EFF = {
    "scnn_dense": 0.4708,
    "scnn": 0.2760,
    "sparten": 0.5638,
    "gospa": 0.6819,
}


def baseline_layer_cycles(design: str, dense_macs: float, d_act: float,
                          d_w: float, hw: HWBudget = PAPER_HW) -> float:
    """Cycles of one layer on a baseline design; ``d_act``/``d_w`` are the
    activation/weight densities in [0, 1]."""
    if design == "scnn_dense":
        work = dense_macs                     # no sparsity exploited
        util = UTIL_CURVES["scnn"](0.0) * FRONTEND_EFF["scnn_dense"]
    else:
        work = dense_macs * d_act * d_w       # intersection designs
        sparsity = 1.0 - d_act * d_w
        util = UTIL_CURVES[design](sparsity) * FRONTEND_EFF[design]
    return work / (hw.total_macs * util)


def network_cycles(layer_stats: list, design: str, d_w: float = 1.0,
                   hw: HWBudget = PAPER_HW) -> float:
    """Total cycles over per-layer stats dicts (``models.cnn.
    run_with_stats`` or ``workloads.analytic_network_stats``): MNF prices
    the exact event counts, the baselines the densities; ``design`` is
    "mnf", "dense_ideal", "scnn_dense", "scnn", "sparten" or "gospa"."""
    total = 0.0
    for s in layer_stats:
        d_act = s["in_events"] / max(s["in_elems"], 1)
        if design == "mnf":
            total += mnf_layer_cycles(s["in_events"],
                                      max(s["avg_touched"], 1.0),
                                      s["c_out"], hw, w_density=d_w)
        elif design == "dense_ideal":
            total += dense_layer_cycles(s["dense_macs"], hw)
        else:
            total += baseline_layer_cycles(design, s["dense_macs"], d_act,
                                           d_w, hw)
    return total

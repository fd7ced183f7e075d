"""Table 4: frames/s, power, frames/J of the MNF ASIC on VGG16/AlexNet —
port of ``repro.costmodel.table4``, number for number.

frames/s = freq / cycles-per-frame, with cycles from the MNF dispatch model
over per-layer event counts.  Power combines the paper's MNF budget split
(Fig. 9: core ≈ 80% of PE power, accumulate SRAMs > 90% of the MAC-cluster
share) with the access-energy model (Table 5) for the data-dependent part;
idle cycles burn 30% of the static budget (the paper's 70% idle power
reduction).  Every number here is a model number of the paper's 200 MHz
ASIC (Table 3), not a time or a power on a GPU.

The paper runs ImageNet through trained, pruned nets; without those
checkpoints the per-layer activation density is a parameter: the
``*_DENSITY_PROFILE`` tuples are calibrated so the cycle model reproduces
Table 4's frames/s (dense first layer, sparse deep layers), and measured
profiles come from ``models.cnn.run_with_stats`` on the port's nets.
"""
from __future__ import annotations

from repro_torch.costmodel.accelerators import (PAPER_HW, HWBudget,
                                                network_cycles)
from repro_torch.costmodel.energy import TABLE5_MNF, AccessEnergy

__all__ = ["PAPER_TABLE4", "VGG16_DENSITY_PROFILE", "ALEXNET_DENSITY_PROFILE",
           "VGG16_W_DENSITY", "ALEXNET_W_DENSITY", "frames_per_second",
           "dynamic_energy_pj", "power_mw", "frames_per_joule", "table4_row",
           "PAPER_RATIOS"]

#: The paper's own MNF column (28nm scaling / 22nm native).
PAPER_TABLE4 = {
    "vgg16": dict(frames_s=31.6, power_mw=200.5, frames_j=157.6,
                  power_mw_22nm=171.4, frames_j_22nm=184.4),
    "alexnet": dict(frames_s=612.1, power_mw=280.5, frames_j=2182.2,
                    power_mw_22nm=239.7, frames_j_22nm=2553.1),
}

#: The paper's Fig. 8: cycles of each baseline over MNF's, per network.
PAPER_RATIOS = {
    "vgg16": dict(scnn_dense=19.0, scnn=8.31, sparten=3.15, gospa=2.57),
    "alexnet": dict(scnn_dense=11.82, scnn=7.32, sparten=3.51, gospa=2.68),
}

#: Per-compute-layer input activation densities of trained ImageNet nets
#: (the input layer sees dense RGB; deep layers are very sparse).
VGG16_DENSITY_PROFILE = (1.0, 0.295, 0.23, 0.216, 0.197, 0.184, 0.144,
                         0.118, 0.098, 0.079, 0.066, 0.059, 0.052,
                         0.131, 0.131, 0.131)
ALEXNET_DENSITY_PROFILE = (1.0, 0.088, 0.064, 0.048, 0.04, 0.04, 0.04, 0.04)
VGG16_W_DENSITY = 0.596      # paper §6.1 pruned-net weight densities
ALEXNET_W_DENSITY = 0.499


def frames_per_second(layer_stats: list, hw: HWBudget = PAPER_HW,
                      w_density: float = 1.0) -> float:
    cycles = network_cycles(layer_stats, "mnf", d_w=w_density, hw=hw)
    return hw.freq_hz / max(cycles, 1.0)


def dynamic_energy_pj(layer_stats: list,
                      e: AccessEnergy = TABLE5_MNF) -> float:
    """Per-frame dynamic energy: event-driven accesses + MACs (Table 5)."""
    total = 0.0
    for s in layer_stats:
        macs = s["event_macs"]
        counts_sram = macs                      # weight vector element reads
        total += (counts_sram * 8 / e.sram_bits * e.sram_pj +
                  2 * macs * 32 / e.buf_bits * e.buf_pj / 27 +
                  macs * (e.reg_pj + e.mac_pj))
    return total


def power_mw(layer_stats: list, hw: HWBudget = PAPER_HW,
             static_mw: float = 60.0, idle_reduction: float = 0.7,
             w_density: float = 1.0) -> float:
    """Average power: dynamic (events) + static, with idle-mode savings.
    ``static_mw`` is the non-data-dependent budget (clock tree, NoC, SRAM
    leakage) at the paper's operating point; idle cycles burn
    (1 - idle_reduction) of it."""
    cycles = network_cycles(layer_stats, "mnf", d_w=w_density, hw=hw)
    t_frame = cycles / hw.freq_hz
    frames_s = 1.0 / t_frame
    dyn_w = dynamic_energy_pj(layer_stats) * 1e-12 * frames_s
    # duty cycle of the MAC arrays (events pending vs idle)
    useful = sum(s["event_macs"] for s in layer_stats)
    duty = min(1.0, useful / max(cycles * hw.total_macs, 1.0))
    stat_w = static_mw * 1e-3 * (duty + (1 - duty) * (1 - idle_reduction))
    return (dyn_w + stat_w) * 1e3


def frames_per_joule(layer_stats: list, hw: HWBudget = PAPER_HW,
                     w_density: float = 1.0) -> float:
    fps = frames_per_second(layer_stats, hw, w_density)
    p_w = power_mw(layer_stats, hw, w_density=w_density) * 1e-3
    return fps / p_w


def table4_row(layer_stats: list, hw: HWBudget = PAPER_HW,
               w_density: float = 1.0) -> dict:
    """{"frames_s", "power_mw", "frames_j"} of the ASIC model on these
    per-layer stats."""
    return dict(frames_s=frames_per_second(layer_stats, hw, w_density),
                power_mw=power_mw(layer_stats, hw, w_density=w_density),
                frames_j=frames_per_joule(layer_stats, hw, w_density))

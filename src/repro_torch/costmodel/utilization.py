"""Multiplier utilization vs density (Fig. 2): MNF vs SNAP — port of
``repro.costmodel.utilization``.

MNF's utilization comes from the dispatch model (``accelerators``): every
event drives a dense burst across all multipliers, so it is ~100% at every
density, less the channel remainder when c_out is not a multiple of the
multipliers covering it.  SNAP's curve is its published behaviour (§3.2:
AIM pair matching starves the array as sparsity grows; <75% beyond 50%).
"""
from __future__ import annotations

from repro_torch.costmodel.accelerators import (PAPER_HW, UTIL_CURVES,
                                                HWBudget, mnf_layer_cycles)

__all__ = ["mnf_utilization_at_density", "snap_utilization_at_density",
           "utilization_sweep"]


def mnf_utilization_at_density(density: float, *, c_out: int = 384,
                               k: int = 3, in_elems: int = 56 * 56 * 256,
                               hw: HWBudget = PAPER_HW) -> float:
    """Utilization of the multiplier array at a given activation density."""
    n_events = max(density * in_elems, 1.0)
    avg_touched = float(k * k)          # stride-1 interior pixels
    useful = n_events * avg_touched * c_out
    cycles = mnf_layer_cycles(n_events, avg_touched, c_out, hw)
    return min(1.0, useful / (cycles * hw.total_macs))


def snap_utilization_at_density(density: float, w_density: float = 0.6
                                ) -> float:
    sparsity = 1.0 - density * w_density
    return UTIL_CURVES["snap"](sparsity)


def utilization_sweep(densities=(1.0, 0.8, 0.6, 0.4, 0.2, 0.1, 0.05),
                      c_out: int = 384):
    rows = []
    for d in densities:
        rows.append(dict(density=d,
                         mnf=mnf_utilization_at_density(d, c_out=c_out),
                         snap=snap_utilization_at_density(d)))
    return rows

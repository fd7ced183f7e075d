"""Fig. 2 — multiplier utilization vs activation density: MNF vs SNAP.

The port's twin of ``benchmarks/fig2_utilization.py``: the same rows, the same
``derived`` strings, computed by ``repro_torch.costmodel`` (model numbers
of the paper's ASIC, not times on a GPU)::

    PYTHONPATH=src python -m benchmarks.torch_fig2_utilization
"""
from __future__ import annotations

import time

from repro_torch.costmodel import utilization_sweep


def rows():
    t0 = time.perf_counter()
    sweep = utilization_sweep()
    us = (time.perf_counter() - t0) * 1e6 / len(sweep)
    out = []
    for r in sweep:
        out.append((f"fig2_util_d{r['density']}", us,
                    f"mnf={r['mnf']:.3f};snap={r['snap']:.3f}"))
    mnf_min = min(r["mnf"] for r in sweep)
    out.append(("fig2_mnf_flatness", us,
                f"min_mnf_util={mnf_min:.3f};paper_claim=~1.0_at_all_densities"))
    return out


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()

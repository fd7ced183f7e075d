"""Fig. 1 — energy of WS/IS/OS vs MNF event-driven on Table 1 layers.

The port's twin of ``benchmarks/fig1_dataflow_energy.py``: the same rows, the same
``derived`` strings, computed by ``repro_torch.costmodel`` (model numbers
of the paper's ASIC, not times on a GPU)::

    PYTHONPATH=src python -m benchmarks.torch_fig1_dataflow_energy
"""
from __future__ import annotations

import time

from repro_torch.costmodel import TABLE1, compare_dataflows


def rows():
    out = []
    for lname, shape in TABLE1.items():
        for d_act in (1.0, 0.6, 0.3, 0.1):
            t0 = time.perf_counter()
            e = compare_dataflows(shape, d_act, d_w=0.6)
            us = (time.perf_counter() - t0) * 1e6
            best = min(e, key=e.get)
            derived = (f"d_act={d_act};uJ_ws={e['ws']/1e6:.1f};"
                       f"uJ_is={e['inp']/1e6:.1f};uJ_os={e['os']/1e6:.1f};"
                       f"uJ_mnf={e['mnf']/1e6:.1f};best={best};"
                       f"mnf_vs_best_other={min(e['ws'], e['inp'], e['os'])/e['mnf']:.2f}x")
            out.append((f"fig1_{lname}_d{d_act}", us, derived))
    return out


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()

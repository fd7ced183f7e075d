"""Fig. 8 — cycle counts: MNF vs SCNN-Dense / SCNN / SparTen / GoSPA.

The port's twin of ``benchmarks/fig8_cycles.py``: the same rows, the same
``derived`` strings, computed by ``repro_torch.costmodel`` (model numbers
of the paper's ASIC, not times on a GPU)::

    PYTHONPATH=src python -m benchmarks.torch_fig8_cycles
"""
from __future__ import annotations

import time

from repro_torch.costmodel import network_cycles
from repro_torch.costmodel.table4 import (ALEXNET_DENSITY_PROFILE,
                                          PAPER_RATIOS,
                                          VGG16_DENSITY_PROFILE)
from repro_torch.costmodel.workloads import analytic_network_stats
from repro_torch.models.cnn import ALEXNET, VGG16

W_DENSITY = {"vgg16": 0.596, "alexnet": 0.499}   # paper §6.1 pruned nets


def rows():
    out = []
    for name, spec, prof in (("vgg16", VGG16, VGG16_DENSITY_PROFILE),
                             ("alexnet", ALEXNET, ALEXNET_DENSITY_PROFILE)):
        t0 = time.perf_counter()
        stats = analytic_network_stats(spec, prof)
        mnf = network_cycles(stats, "mnf", d_w=W_DENSITY[name])
        us = (time.perf_counter() - t0) * 1e6
        for design in ("scnn_dense", "scnn", "sparten", "gospa"):
            cyc = network_cycles(stats, design, d_w=W_DENSITY[name])
            ratio = cyc / mnf
            paper = PAPER_RATIOS[name][design]
            out.append((f"fig8_{name}_{design}", us,
                        f"mnf_cycles={mnf:.3g};{design}_cycles={cyc:.3g};"
                        f"speedup={ratio:.2f}x;paper={paper}x;"
                        f"rel_err={abs(ratio-paper)/paper:.2f}"))
    return out


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()

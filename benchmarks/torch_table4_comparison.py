"""Table 4 — frames/s, power, frames/J for MNF on VGG16/AlexNet.

The port's twin of ``benchmarks/table4_comparison.py``: the same rows, the same
``derived`` strings, computed by ``repro_torch.costmodel`` (model numbers
of the paper's ASIC, not times on a GPU)::

    PYTHONPATH=src python -m benchmarks.torch_table4_comparison
"""
from __future__ import annotations

import time

from repro_torch.costmodel import PAPER_TABLE4, table4_row
from repro_torch.costmodel.table4 import (ALEXNET_DENSITY_PROFILE,
                                          ALEXNET_W_DENSITY,
                                          VGG16_DENSITY_PROFILE,
                                          VGG16_W_DENSITY)
from repro_torch.costmodel.workloads import analytic_network_stats
from repro_torch.models.cnn import ALEXNET, VGG16


def rows():
    out = []
    for name, spec, prof, wd in (
            ("vgg16", VGG16, VGG16_DENSITY_PROFILE, VGG16_W_DENSITY),
            ("alexnet", ALEXNET, ALEXNET_DENSITY_PROFILE, ALEXNET_W_DENSITY)):
        t0 = time.perf_counter()
        r = table4_row(analytic_network_stats(spec, prof), w_density=wd)
        us = (time.perf_counter() - t0) * 1e6
        p = PAPER_TABLE4[name]
        out.append((f"table4_{name}", us,
                    f"frames_s={r['frames_s']:.1f}(paper {p['frames_s']});"
                    f"power_mw={r['power_mw']:.1f}(paper {p['power_mw']});"
                    f"frames_j={r['frames_j']:.1f}(paper {p['frames_j']})"))
    return out


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()

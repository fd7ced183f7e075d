"""Table 5 — per-access energy inputs (identity check of the model inputs)
and the resulting per-MAC energy of each dataflow at the paper's operating
point.

The port's twin of ``benchmarks/table5_memory_energy.py``: the same rows, the same
``derived`` strings, computed by ``repro_torch.costmodel`` (model numbers
of the paper's ASIC, not times on a GPU)::

    PYTHONPATH=src python -m benchmarks.torch_table5_memory_energy
"""
from __future__ import annotations

import time

from repro_torch.costmodel import (TABLE1, TABLE5_MNF, TABLE5_OTHERS,
                                   compare_dataflows)


def rows():
    out = []
    e, em = TABLE5_OTHERS, TABLE5_MNF
    out.append(("table5_dram_pj", 0.0,
                f"others={e.dram_pj}@{e.dram_bits}b;mnf={em.dram_pj}@{em.dram_bits}b"))
    out.append(("table5_sram_pj", 0.0,
                f"others={e.sram_pj}@{e.sram_bits}b;mnf={em.sram_pj}@{em.sram_bits}b"))
    out.append(("table5_buf_pj", 0.0,
                f"others={e.buf_pj}@{e.buf_bits}b;mnf={em.buf_pj}@{em.buf_bits}b"))
    out.append(("table5_reg_pj", 0.0,
                f"others={e.reg_pj}x3;mnf={em.reg_pj}x3"))
    t0 = time.perf_counter()
    eng = compare_dataflows(TABLE1["layer1"], 0.3, 0.6)
    us = (time.perf_counter() - t0) * 1e6
    macs = TABLE1["layer1"].macs
    for k, v in eng.items():
        out.append((f"table5_pj_per_dense_mac_{k}", us, f"{v/macs:.3f}pJ"))
    return out


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()

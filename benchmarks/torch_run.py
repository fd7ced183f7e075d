"""Benchmark harness of the port — one module per paper table/figure, the
twin of ``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV; every ``derived`` string is the
JAX harness's for the same inputs (model numbers of the paper's ASIC,
computed by ``repro_torch.costmodel``).  Run from the repository root::

    PYTHONPATH=src python -m benchmarks.torch_run

The ``roofline`` rows read the port's dry-run records
(``results/torch_dryrun/``, written by ``python -m
repro_torch.launch.dryrun``).  The JAX harness's ``kernels`` rows
(``kernel_bench.py``) wait for the port's benchmark file (ROADMAP item 6).
"""
from __future__ import annotations

import sys
import traceback

from benchmarks import (torch_fig1_dataflow_energy, torch_fig2_utilization,
                        torch_fig8_cycles, torch_roofline_table,
                        torch_table4_comparison, torch_table5_memory_energy)

MODULES = (
    ("fig1", torch_fig1_dataflow_energy),
    ("fig2", torch_fig2_utilization),
    ("fig8", torch_fig8_cycles),
    ("table4", torch_table4_comparison),
    ("table5", torch_table5_memory_energy),
    ("roofline", torch_roofline_table),
)


def main() -> None:
    print("name,us_per_call,derived")
    failures = 0
    for tag, mod in MODULES:
        try:
            for name, us, derived in mod.rows():
                print(f"{name},{us:.1f},{derived}")
        except Exception as e:   # keep the harness running; count failures
            failures += 1
            print(f"{tag}_FAILED,0.0,{type(e).__name__}:{e}")
            traceback.print_exc(file=sys.stderr)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

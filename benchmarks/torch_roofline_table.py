"""§Roofline summary from the port's dry-run records.

The port's twin of ``benchmarks/roofline_table.py``: the same rows, the
same ``derived`` strings, read from ``results/torch_dryrun/*.json`` (the
records ``python -m repro_torch.launch.dryrun`` writes: counts of one
device's share of a cell's step traced on the meta device, not times on
a card; ``us`` is the trace time, ``lower_s``, since nothing compiles)::

    PYTHONPATH=src python -m benchmarks.torch_roofline_table
"""
from __future__ import annotations

import glob
import json
import os

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results",
                       "torch_dryrun")


def rows():
    out = []
    for path in sorted(glob.glob(os.path.join(RESULTS, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        name = f"roofline_{rec['arch']}_{rec['shape']}_{rec['mesh']}"
        if rec.get("tag"):
            name += f"_{rec['tag']}"
        if rec["status"] == "skipped":
            out.append((name, 0.0, f"skipped:{rec['reason'][:60]}"))
            continue
        if rec["status"] != "ok":
            out.append((name, 0.0, f"ERROR:{rec.get('error', '')[:80]}"))
            continue
        r = rec["roofline"]
        us = (rec.get("lower_s", 0) + rec.get("compile_s", 0)) * 1e6
        out.append((name, us,
                    f"bottleneck={r['bottleneck']};"
                    f"t_comp={r['t_compute'] * 1e3:.1f}ms;"
                    f"t_mem={r['t_memory'] * 1e3:.1f}ms;"
                    f"t_coll={r['t_collective'] * 1e3:.1f}ms;"
                    f"roofline_frac={r['roofline_frac']:.3f};"
                    f"useful={r['useful_ratio']:.2f};"
                    f"dev_gib={r['bytes_per_device'] / 2**30:.2f}"))
    if not out:
        out.append(("roofline_table", 0.0,
                    "no dry-run artifacts; run python -m "
                    "repro_torch.launch.dryrun --all"))
    return out


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()

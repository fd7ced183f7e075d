"""Readings that the limits of ``correct`` are set from (on the card).

    python3 bench/calibrate.py --workload vgg16_224.offline \
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3

For each ``--seeds`` seed, one run of the cell with the program (the
lower readings); for each ``--control-seeds`` seed, one run with the
control in the program's place: the plain reference computed in TF32
(the upper readings).  Each run goes through every step of a benchmark
run, at the cell's own sizes and load, with a short window; all in one
process.  Prints one JSON line a run and writes them all to ``--out``.
"""
import argparse
import functools
import gc
import json
import os
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)

    from mnfbench import cell as cell_mod
    from mnfbench import spec
    from mnfbench.control import ReferenceServe

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    control = functools.partial(ReferenceServe,
                                reference=spec.reference(
                                    cell.config["reference"]),
                                precision="tf32")
    runs = [(int(s), "program", None) for s in args.seeds.split(",") if s]
    runs += [(int(s), "control", control)
             for s in args.control_seeds.split(",") if s]
    rows = []
    for seed, side, make in runs:
        t = time.perf_counter()
        out = cell_mod.run_cell(cell, seed, args.seconds, False,
                                device="cuda", make_system=make)["result"]
        row = dict(workload=args.workload, side=side, seed=seed,
                   correct=out["correct"], attempted=out["attempted"],
                   failed=out["failed"], compared=out["compared"],
                   metrics=out["metrics"],
                   wall_s=time.perf_counter() - t)
        print(json.dumps(row), flush=True)
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(
            "\n".join(json.dumps(r) for r in rows) + "\n")
    for side in ("program", "control"):
        gaps = [r["compared"]["logit_gap"]["value"] for r in rows
                if r["side"] == side]
        if gaps:
            print(f"{side}: logit_gap min {min(gaps)!r} max {max(gaps)!r} "
                  f"over {len(gaps)} seeds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    os.environ["OMP_NUM_THREADS"] = "1"     # as run.py
    sys.exit(main())

"""Run one cell of the port's benchmark once, on the card, and print its
result as one JSON line (the last line of standard output).

    python3 bench/run.py --workload vgg16_224.offline --seed 7 \
        --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a fixed stretch of the window under the profiler).
The numbers that decide ``correct`` are printed beside their limits as
the last lines of standard error, and last in the JSON line.

Exits non-zero, printing no result, when no card is present (or fewer
than the cell asks for), when the port cannot be imported, or when JAX or
the JAX package was loaded by the time the window closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
BENCH = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Forbidden top-level names among ``modules`` (``sys.modules``),
    each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)

    from mnfbench import cell as cell_mod
    from mnfbench import spec

    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here, before any work, without src/)

    got = cell_mod.run_cell(cell, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}; the port may not load JAX "
              f"or the JAX package", file=sys.stderr)
        return 3
    result = got["result"]
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # One host thread for the program's CPU work (staging): the machine's
    # cores are shared, and a pool of idle worker threads waking for
    # every 602-KB copy made the latency of one stream swing by half.
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.exit(main())

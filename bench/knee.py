"""The rate sweep that finds a server cell's knee (on the card).

    python3 bench/knee.py --workload vgg16_224.server --seed 5 \
        --seconds 20 --rates 300,400,450,500,540,580,620

One system is built, then the cell's open-loop traffic is offered at
each rate in turn for ``--seconds``.  For each rate: requests/s served,
the p50 and p95 latency from due time, and whether the queue grew: the
mean wait from due to batch start over the last third of the window
against the first third, and the backlog (due, not yet served) when the
window closed.  The knee is the highest rate at which the queue does not
grow; the cell's rate is set to four fifths of it by hand.
"""
import argparse
import json
import os
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    torch.set_num_threads(1)

    from mnfbench import inputs, loads, spec
    from mnfbench.records import Run, percentile

    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.resolve(args.workload)
    cfg, traffic = cell.config, cell.traffic
    params = inputs.make_weights(cfg, args.seed, "cuda")
    pool = inputs.make_pool(cfg, traffic["pool"], args.seed, "cuda")
    order = inputs.pool_order(traffic["pool"], args.seed)
    system = spec.system(cfg["system"])(cfg, params, traffic["buckets"],
                                    "cuda", Run(cell=cell.name, loop="open",
                                                seconds=5.0, trace=False))
    loads.drive(system, Run(cell=cell.name, loop="open", seconds=5.0,
                            trace=False),
                traffic, pool, order, args.seed, 5.0)       # warm-up
    for rate in [float(r) for r in args.rates.split(",")]:
        rec = Run(cell=cell.name, loop="open", seconds=args.seconds,
                  trace=False)
        system.rec = rec
        loads.drive(system, rec, dict(traffic, rate_per_s=rate), pool,
                    order, args.seed, args.seconds)
        lat = [1e3 * (r.done - r.due) for r in rec.requests]
        third = args.seconds / 3

        def wait(lo, hi):
            w = [rec.batches[r.batch].start - r.due for r in rec.requests
                 if r.batch is not None and lo <= r.due - rec.t0 < hi]
            return 1e3 * float(np.mean(w)) if w else None

        backlog = sum(1 for r in rec.requests
                      if r.due <= rec.t_close and r.done > rec.t_close)
        served = sum(1 for r in rec.requests if r.done <= rec.t_close)
        buckets = {}
        for b in rec.batches:
            buckets[b.bucket] = buckets.get(b.bucket, 0) + 1
        first_full = next((b.start - rec.t0 for b in rec.batches
                           if b.bucket == max(traffic["buckets"])), None)
        row = dict(rate=rate, requests=len(rec.requests),
                   buckets=buckets, first_full_bucket_s=first_full,
                   max_batch_ms=1e3 * max((b.end - b.start
                                           for b in rec.batches
                                           if b.end is not None),
                                          default=0.0),
                   max_lateness_ms=1e3 * max(r.submit - r.due
                                             for r in rec.requests),
                   served_per_s=served / args.seconds,
                   p50_ms=percentile(lat, 50), p95_ms=percentile(lat, 95),
                   wait_first_third_ms=wait(0, third),
                   wait_last_third_ms=wait(2 * third, args.seconds),
                   backlog_at_close=backlog,
                   drain_s=rec.t_end - rec.t_close,
                   batches=len(rec.batches),
                   mean_batch=len(rec.requests) / max(len(rec.batches), 1))
        print(json.dumps(row), flush=True)
    system.close()
    return 0


if __name__ == "__main__":
    os.environ["OMP_NUM_THREADS"] = "1"     # as run.py
    sys.exit(main())

"""One run of one cell: set-up, the measured window, then the verdict and
the metrics.

Order matters for what is read:
1. set-up (counted in ``setup_s``): the weights and the image pool from
   the seed, the system built (each bucket's graph captured and run
   once), the traffic's ``warmup_s`` of its own load, unrecorded, and in
   a traced run whose stretch is placed by time the profiler started
   once;
2. the window: the traffic mix drives the system; with ``trace`` a fixed
   stretch of it is profiled;
3. the device's memory peak is read, and the system freed;
4. the reference runs over the images served, and every served request
   is judged; in a traced run the stretch's useful work is counted;
5. the cell's metrics are read from the run's records: its end-to-end
   metrics untraced, its per-layer metrics traced.
"""
from __future__ import annotations

import gc
import time

import torch

from mnfbench import inputs, loads, readers, spec, trace, verdict, work
from mnfbench.records import Run, percentile

__all__ = ["run_cell"]

clock = time.perf_counter


def _system(cell: spec.Cell, params, device, rec, make_system):
    make = make_system or spec.system(cell.config["system"])
    return make(cell.config, params, cell.traffic["buckets"], device, rec)


def _buckets(rec: Run) -> dict:
    """Batches served in each bucket ("none" where no staging span gave
    the shape)."""
    out: dict = {}
    for b in rec.batches:
        key = "none" if b.bucket is None else str(b.bucket)
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: (len(kv[0]), kv[0])))


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start: float | None = None,
             make_system=None) -> dict:
    """The run's result (the contract's keys, plus ``compared``) and its
    records (``"run"``).  ``make_system(cfg, params, buckets, device,
    rec)`` puts another system in the program's place (the control, a
    planted fault).  The configuration's reference module may bring its
    own ``make_weights``, ``make_pool`` and ``judge``; the CNN ones of
    :mod:`mnfbench.inputs` and :mod:`mnfbench.verdict` serve otherwise."""
    t_start = clock() if t_start is None else t_start
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    if cfg.get("tf32", False):
        raise ValueError("the configuration asks for TF32; the reference "
                         "computes in float32 with TF32 off")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reference = spec.reference(cfg["reference"])

    marks = [("imports", clock())]
    make_weights = getattr(reference, "make_weights", inputs.make_weights)
    make_pool = getattr(reference, "make_pool", inputs.make_pool)
    judge = getattr(reference, "judge", verdict.judge)
    params = make_weights(cfg, seed, device)
    pool = make_pool(cfg, traffic["pool"], seed, device)
    order = inputs.pool_order(traffic["pool"], seed)
    marks.append(("inputs", clock()))
    rec = Run(cell=cell.name, loop=traffic["loop"], seconds=seconds,
              trace=traced)
    system = _system(cell, params, device, rec, make_system)
    marks.append(("system", clock()))
    warm = Run(cell=cell.name, loop=traffic["loop"],
               seconds=traffic.get("warmup_s", 0.0), trace=False)
    if warm.seconds > 0:
        system.rec = warm
        loads.drive(system, warm, traffic, pool, order, seed, warm.seconds)
        system.rec = rec
    stretch = None
    if traced and "last_s" in traffic["profile"]:
        # A stretch placed by time starts the profiler once here, so its
        # start-up does not hold up an open loop's arrivals.  One placed
        # by ticks starts it itself: the ticks before it run as untraced
        # ticks do (once loaded, CUPTI slows every later launch).
        trace.start(device).stop()
    if traced:
        stretch = trace.Stretch(traffic["profile"], rec, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(("warm", clock()))

    loads.drive(system, rec, traffic, pool, order, seed, seconds, stretch)
    rec.setup_s = rec.t0 - t_start
    setup = {}
    prev = t_start
    for name, t in marks:
        setup[name + "_s"] = t - prev
        prev = t

    memory_peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        memory_peak = max(torch.cuda.max_memory_reserved(device),
                          torch.cuda.memory_reserved(device))
    system.close()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    used = sorted({r.pool_idx for r in rec.requests})
    ref = verdict.reference_logits(cfg, params, pool, used, reference,
                                   device)
    judged = judge(rec, ref, cfg)
    if traced:
        rec.profile = trace.reduce(stretch)
        if rec.profile is not None and rec.profile["first_tick"] is not None:
            rec.work = work.stretch_work(
                rec, cfg, params, pool, reference,
                (rec.profile["first_tick"], rec.profile["last_tick"]),
                device)

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m.name)(rec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": judged["correct"], "attempted": judged["attempted"],
           "failed": judged["failed"], "metrics": metrics, "device": dev}
    if traced and rec.profile is not None:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
        out["breakdown"] = {"device_ops": rec.profile["device_ops"],
                            "idle_gaps": rec.profile["idle_gaps"]}
    lateness = [r.submit - r.due for r in rec.requests
                if r.submit is not None]
    lat = readers.latencies_ms(rec)
    out["traffic"] = {"requests": len(rec.requests), "ticks": rec.ticks,
                      "window_s": rec.window_s,
                      "lateness_max_ms": 1e3 * max(lateness, default=0.0),
                      "latency_ms": [percentile(lat, q)
                                     for q in (0, 50, 95, 99, 100)],
                      "p50_by_sixth_ms": readers.p50_by_part_ms(rec, 6),
                      "buckets": _buckets(rec)}
    out["setup"] = setup
    out["compared"] = judged["compared"]
    return {"result": out, "run": rec}

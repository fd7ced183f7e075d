#!/usr/bin/env python3
"""Warm prefill time of repro_torch's full-width LM on one NVIDIA GPU.

    python3 tools/torch_prefill_time.py [--arch hymba-1.5b|rwkv6-7b]
        [--prompt 32] [--reps 5] [--graph] [--src DIR]

Builds the full-width model of ``--arch`` as the config ships it (MNF on,
bf16 compute; random weights from seed 0), makes a batch-4 prompt of
``--prompt`` tokens from seed 0, runs one prefill to warm up (kernels
built, handles made), then ``--reps`` prefills, each between two
synchronizes on the host clock, and one more under ``torch.profiler``
(CUDA kernels launched, device busy ms, idle share, and device ms with
launches by kernel name: the top 15, the rest as one line), and the host
syncs of one prefill (``torch.cuda.set_sync_debug_mode("warn")``).  With
``--graph`` the prefill is the graphed prefill step of ``launch.steps``
(a CUDA graph, captured before the timed runs; its capture seconds and
graph launches are reported); without it, the eager ``prefill``.  Prints
the card's name and power limit, then one JSON line.  ``--src`` names the directory
to import ``repro_torch`` from (default: this checkout's ``src``), so one
call on the card can time two trees in turns.  Needs a card; exits 2
without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: The serve driver's batch (PERF.md §4).
BATCH = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b",
                    choices=("rwkv6-7b", "hymba-1.5b"))
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--graph", action="store_true",
                    help="replay the prefill as a CUDA graph")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_prefill_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = serve.lm_config(args.arch)
    params = tfm.compute_params(tfm.init_params(0, cfg, "cuda"), cfg)
    prompts = serve.make_prompts(cfg, BATCH, args.prompt, 0, "cuda")

    capture_s = None
    if args.graph:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import steps
        pre = steps.make_prefill_step(cfg, ShapeConfig(
            "prefill", args.prompt, BATCH, "prefill"))
        g = pre.fn.capture(params, prompts)
        capture_s = getattr(g, "warmup_s", 0.0) + g.capture_s
        batch = dict(tokens=prompts)

        def prefill():
            return pre.fn(params, batch)
    else:
        def prefill():
            return tfm.prefill(params, prompts, cfg, max_len=args.prompt)

    prefill()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        prefill()
    torch.cuda.set_sync_debug_mode(0)
    times = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "device_time_total", 0) for e in kernels) / 1e3
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name.replace("void ", "", 1), [0.0, 0])
        rec[0] += getattr(e, "device_time_total", 0) / 1e3
        rec[1] += 1
    graph_launches = sum(e.count for e in prof.key_averages()
                         if e.key == "cudaGraphLaunch")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    top = [dict(kernel=n[:160], ms=round(ms, 4), launches=c)
           for n, (ms, c) in ranked[:15]]
    rest = ranked[15:]
    top.append(dict(kernel=f"the other {len(rest)} kernels",
                    ms=round(sum(ms for _, (ms, _) in rest), 4),
                    launches=sum(c for _, (_, c) in rest)))
    scan = [e for e in kernels
            if e.name.replace("void ", "", 1).startswith("mnf_mamba_scan")]
    print(json.dumps(dict(
        arch=cfg.name, src=args.src, graph=args.graph, capture_s=capture_s,
        batch=BATCH, prompt=args.prompt,
        layers=cfg.num_layers, device=torch.cuda.get_device_name(0),
        ms=[round(t, 3) for t in times], best_ms=round(min(times), 3),
        median_ms=round(statistics.median(times), 3),
        profiled_ms=round(wall, 3), cuda_kernels=len(kernels),
        graph_launches=graph_launches, host_syncs=len(syncs),
        device_busy_ms=round(busy, 3),
        idle_share=round(max(0.0, 1 - busy / wall), 4),
        b10_launches=len(scan), by_kernel=top)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

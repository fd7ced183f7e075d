#!/usr/bin/env python3
"""Where the host time of repro_torch's LM decode step goes, on one NVIDIA
GPU.

    python3 tools/torch_decode_profile.py [--arch rwkv6-7b|hymba-1.5b]
        [--layers 4] [--steps 5] [--graph] [--src DIR]

Builds the full-width model of ``--arch`` (RWKV6-7B: d_model 4096, 64x64
heads, d_ff 14336, vocab 65536; Hymba-1.5B: d_model 1600, 25 query and 5
KV heads of 64, Mamba state 16, d_ff 5504, vocab 32001) cut to
``--layers`` layers, random weights from seed 0, prefills a batch-4,
32-token prompt and then, for the gated decode (MNF on at θ = 0: B7 or B8)
and the ungated one, prints: whether any op of a decode step
syncs the host (``torch.cuda.set_sync_debug_mode("warn")``), the warm
host ms per decode step, the CUDA launches and torch ops (``aten::``
calls, nested ones included) per step, the device ms per step of each MNF
kernel (B7 or B8) and of all device work, and the host ops by self CPU
time and the device kernels by device time (``torch.profiler``, CPU and
CUDA activity), and the device ms per step between CUDA events; last, the
gated step's device ms and launches minus the ungated one's, by kernel.  With ``--graph`` each step is the graphed
decode step of ``launch.steps`` (a CUDA graph replayed; the step's
position and tokens copied in, the cache its own), captured before the
timed steps, and the graph launches per step are printed beside the
kernel launches; without it, the eager ``decode_step``.  ``--src`` names the
directory to import ``repro_torch`` from (default: this checkout's
``src``), so one call on the card can profile two trees in turns (e.g.
the parent commit unpacked by ``git archive`` under the git-ignored
``build/``).  Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: The serve driver's batch and prompt (PERF.md §4).
BATCH, PROMPT = 4, 32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rwkv6-7b",
                    choices=("rwkv6-7b", "hymba-1.5b"))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--graph", action="store_true",
                    help="replay the decode step as a CUDA graph")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    if args.graph:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import steps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; src {args.src}; {'graphed' if args.graph else 'eager'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(serve.lm_config(args.arch),
                              num_layers=args.layers)
    params = tfm.compute_params(tfm.init_params(0, cfg, "cuda"), cfg)
    prompts = serve.make_prompts(cfg, BATCH, PROMPT, 0, "cuda")
    ungated = dataclasses.replace(cfg, mnf=dataclasses.replace(
        cfg.mnf, enabled=False))
    kernels_of = {}
    for name, c in (("gated θ=0", cfg), ("ungated", ungated)):
        logits, cache = tfm.prefill(params, prompts, c, max_len=PROMPT + 1)
        tok = logits[:, -1].argmax(-1)[:, None]
        if args.graph:
            srv = steps.make_serve_step(c, ShapeConfig(
                "decode", PROMPT + 1, BATCH, "decode"))
            srv.fn.capture(params, torch.device("cuda"))
            # every step at position PROMPT: the position is copied in, the
            # graph's own cache handed back after the first step
            pos = torch.full((), PROMPT, dtype=torch.int64, device="cuda")
            state = dict(cache=cache)

            def step():
                logits, state["cache"] = srv.fn(params, state["cache"],
                                                dict(tokens=tok), pos)
                return logits
        else:
            def step():
                return tfm.decode_step(params, cache, tok, PROMPT, c)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            step()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(args.steps):
            step()
        end.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end) / args.steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        launches = sum(e.count for e in avg
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                    "cuLaunchKernel"))
        ops = sum(e.count for e in avg if e.key.startswith("aten::"))
        graph_launches = sum(e.count for e in avg
                             if e.key == "cudaGraphLaunch")
        device: dict[str, float] = {}
        by_kernel: dict[str, list] = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dur = e.device_time_total if hasattr(e, "device_time_total") \
                else e.cuda_time_total
            kernel = e.name.split("(")[0].split("<")[0].replace("void ", "")
            rec = by_kernel.setdefault(e.name.replace("void ", "")[:90],
                                       [0.0, 0])
            rec[0] += dur / 1e3 / args.steps
            rec[1] += 1
            for key in {"all", kernel} if kernel.startswith("mnf_") \
                    else {"all"}:
                device[key] = device.get(key, 0.0) + dur / 1e3 / args.steps
        busy = device.get("all", 0.0)
        print(f"{name}, {args.layers} layers, batch {BATCH}: {ms:.3f} ms per "
              f"decode step (host clock, synchronized), {event_ms:.3f} ms "
              f"between CUDA events, {launches / args.steps:.0f} CUDA kernel "
              f"launches, {graph_launches / args.steps:.0f} graph launches "
              f"and {ops / args.steps:.0f} torch ops per step, device ms per "
              f"step: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    sorted(device.items())) + ", "
              f"idle share {max(0.0, 1 - busy / ms):.3f} (device busy over "
              f"host ms), {len(syncs)} host syncs in a step"
              + (f" ({str(syncs[0].message)[:100]})" if syncs else ""))
        kernels_of[name] = by_kernel
        print("device ms and launches per step by kernel (top 12):")
        for k, (v, n) in sorted(by_kernel.items(),
                                key=lambda kv: -kv[1][0])[:12]:
            print(f"{v:10.4f}  {n // args.steps:6d}  {k}")
        print(avg.table(sort_by="self_cpu_time_total", row_limit=15))
    gated, dense = kernels_of["gated θ=0"], kernels_of["ungated"]
    diff = {k: (gated.get(k, [0.0, 0])[0] - dense.get(k, [0.0, 0])[0],
                (gated.get(k, [0.0, 0])[1] - dense.get(k, [0.0, 0])[1])
                // args.steps) for k in set(gated) | set(dense)}
    print(f"gated θ=0 minus ungated, device ms and launches per step: "
          f"{sum(d[0] for d in diff.values()):.4f} ms, "
          f"{sum(d[1] for d in diff.values())} launches; by kernel (the 15 "
          f"largest |ms|):")
    for k, (v, n) in sorted(diff.items(), key=lambda kv: -abs(kv[1][0]))[:15]:
        print(f"{v:+10.4f}  {n:+6d}  {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

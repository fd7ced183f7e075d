#!/usr/bin/env python3
"""Where the time of repro_torch's VGG16@224 batch-4 chained forward goes,
on one NVIDIA GPU, in f32 and with int8 event values.

    python3 tools/torch_profile.py [--graph] [--src DIR]

For each mode: warm forwards on the host clock (median of 5, each between
two synchronizes), then 3 forwards under ``torch.profiler`` (CPU + CUDA
activity).  Prints the card line (name, power limit), the forward's host
time, the device busy time and idle share over the profiled window, device
time by kernel name (with launch counts), device time summed per MNF kernel
versus everything else (the torch ops around the kernels: encode argsorts,
gathers, plans), the event matmul's device time by launch shape (B2 in
f32, B5 in int8) and the strip conv's by layer (B3, and B6 in int8): the
launch order of one forward, read from the wrappers' capture lists, is
matched against the profiled kernels in start order.  With ``--graph``
the timed and profiled forwards are replays of the network's pipeline
(``models.cnn.make_cnn_pipeline``: one CUDA graph, captured first; the
launch order still read from an eager forward), and the host syncs of
one forward (``torch.cuda.set_sync_debug_mode("warn")``) are counted
either way.  Ends with one JSON line per mode.  ``--src`` names the directory to import
``repro_torch`` from (default: this checkout's ``src``), so one call on
the card can profile two trees in turns.  Needs a card; exits 2 without
one.
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

MNF_KERNELS = ("mnf_fire_compact_kernel", "mnf_event_matmul_kernel",
               "mnf_event_conv_kernel", "mnf_event_pool_window_kernel",
               "mnf_event_pool_kernel")


#: The smoke cell: VGG16@224, batch 4 (PERF.md §4); forwards profiled.
BATCH, SIZE, STEPS, REPS = 4, 224, 3, 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", action="store_true",
                    help="time and profile the pipeline's CUDA graph")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fire import FireConfig
    from repro_torch.kernels.event_conv import ops as conv_ops
    from repro_torch.kernels.event_matmul import ops as mm_ops
    from repro_torch.models import cnn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    spec = cnn.VGG16
    params = cnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((BATCH, SIZE, SIZE, 3),
                               generator=gen, device=dev))
    for mode in ("f32", "int8"):
        fire_cfg = FireConfig(quantize_to_int8=mode == "int8")
        wrapper = mm_ops.event_matmul_dequant if mode == "int8" \
            else mm_ops.event_matmul

        def eager():
            return cnn.cnn_forward(params, x, spec, fire_cfg=fire_cfg)

        for _ in range(2):                     # build kernels, plans; warm
            eager()
        capture_s = None
        if args.graph:
            pipe = cnn.make_cnn_pipeline(spec, batch=BATCH,
                                         fire_cfg=fire_cfg, device=dev)
            pipe(params, x)
            g = pipe.graph              # a parent tree's has no warmup_s
            capture_s = getattr(g, "warmup_s", 0.0) + g.capture_s

            def forward():
                return pipe(params, x)
        else:
            forward = eager
        wrapper.capture = []                   # one forward's launch order
        convs = conv_ops.event_conv.capture = \
            conv_ops.event_conv_dequant.capture = []   # B3, B6 in turn
        eager()
        order = [(tuple(a[0].shape), tuple(a[-1].shape))
                 for a, _ in wrapper.capture]
        conv_order = [
            f"#{i} {'B6' if a[0].dtype == torch.int8 else 'B3'} a_vals "
            f"{tuple(a[0].shape)} x ws {tuple(a[-1].shape)} "
            f"s{kw['row_stride']}" for i, (a, kw) in enumerate(convs)]
        wrapper.capture = conv_ops.event_conv.capture = \
            conv_ops.event_conv_dequant.capture = None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            forward()
        torch.cuda.set_sync_debug_mode(0)
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]

        def dur(e):
            return (e.device_time_total if hasattr(e, "device_time_total")
                    else e.cuda_time_total) / 1e3

        by_name: dict[str, list] = {}
        for e in kernels:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += dur(e) / STEPS
            rec[1] += 1
        busy = sum(v[0] for v in by_name.values())
        mnf = sum(v[0] for n, v in by_name.items()
                  if any(k in n for k in MNF_KERNELS))
        mm = sorted((e for e in kernels
                     if "mnf_event_matmul_kernel" in e.name),
                    key=lambda e: e.time_range.start)
        if len(mm) != len(order) * STEPS:
            print(f"torch_profile: {len(mm)} event matmul kernels profiled, "
                  f"{len(order)} launches a forward", file=sys.stderr)
            return 1
        by_shape: dict[tuple, list] = {}
        for e, key in zip(mm, order * STEPS):
            rec = by_shape.setdefault(key, [0.0, 0])
            rec[0] += dur(e) / STEPS
            rec[1] += 1
        cv = sorted((e for e in kernels
                     if "mnf_event_conv_kernel" in e.name),
                    key=lambda e: e.time_range.start)
        if len(cv) != len(conv_order) * STEPS:
            print(f"torch_profile: {len(cv)} strip conv kernels profiled, "
                  f"{len(conv_order)} launches a forward", file=sys.stderr)
            return 1
        by_layer = {key: 0.0 for key in conv_order}
        for e, key in zip(cv, conv_order * STEPS):
            by_layer[key] += dur(e) / STEPS
        label = "B5" if mode == "int8" else "B2"
        graph_launches = sum(e.count for e in prof.key_averages()
                             if e.key == "cudaGraphLaunch") // STEPS
        lines = [f"== VGG16@{SIZE} batch {BATCH}, {mode} chained forward, "
                 f"{'graphed' if args.graph else 'eager'} (src {args.src})",
                 f"warm forward: median {statistics.median(times):.3f} ms of "
                 f"{[round(t, 3) for t in times]} (host clock, synchronized)",
                 f"host time per forward under the profiler: {wall_ms:.3f} ms",
                 f"device busy per forward: {busy:.3f} ms "
                 f"(idle share {max(0.0, 1 - busy / wall_ms):.3f})",
                 f"MNF kernels: {mnf:.3f} ms; other device work: "
                 f"{busy - mnf:.3f} ms",
                 f"host syncs in a forward: {len(syncs)}; graph launches "
                 f"a forward: {graph_launches}; warm-up and capture: "
                 f"{capture_s} s",
                 "device ms/forward  launches/forward  kernel"]
        for name, (ms, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0]):
            lines.append(f"{ms:16.4f}  {n // STEPS:16d}  {name[:110]}")
        lines.append(f"{label} device ms/forward by launch shape "
                     f"(a_vals x W):")
        for (a, w), (ms, n) in sorted(by_shape.items(),
                                      key=lambda kv: -kv[1][0]):
            lines.append(f"{ms:16.4f}  {n // STEPS:16d}  {a} x {w}")
        lines.append(f"strip conv device ms/forward by layer, in launch "
                     f"order ({sum(by_layer.values()):.4f} ms in all):")
        for key, ms in by_layer.items():
            lines.append(f"{ms:16.4f}  {key}")
        print("\n".join(lines), flush=True)
        print(json.dumps(dict(
            mode=mode, src=args.src, graph=args.graph, capture_s=capture_s,
            host_syncs=len(syncs), graph_launches=graph_launches,
            device=torch.cuda.get_device_name(0),
            forward_ms=round(statistics.median(times), 3),
            profiled_ms=round(wall_ms, 3), device_busy_ms=round(busy, 3),
            kernel=label, kernel_ms=round(sum(v[0] for v in
                                              by_shape.values()), 4),
            kernel_ms_by_shape={f"{a} x {w}": [round(ms, 4), n // STEPS]
                                for (a, w), (ms, n) in by_shape.items()},
            strip_conv_ms=round(sum(by_layer.values()), 4),
            strip_conv_ms_by_layer={k: round(v, 4)
                                    for k, v in by_layer.items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

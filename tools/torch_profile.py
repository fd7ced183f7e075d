#!/usr/bin/env python3
"""Where the time of repro_torch's VGG16@224 batch-4 chained forward goes,
on one NVIDIA GPU.

    python3 tools/torch_profile.py

Runs warm chained forwards under ``torch.profiler`` (CPU + CUDA activity)
and prints: the card line (name, power limit), the forward's host time,
the device busy time and idle share over the profiled window, device time
by kernel name (with launch counts), and device time summed per
MNF kernel versus everything else (the torch ops around the kernels:
encode argsorts, gathers, plans).  Needs a card; exits 2 without one.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

MNF_KERNELS = ("mnf_fire_compact_kernel", "mnf_event_matmul_kernel",
               "mnf_event_conv_kernel", "mnf_event_pool_window_kernel",
               "mnf_event_pool_kernel")


#: The smoke cell: VGG16@224, batch 4 (PERF.md §4); forwards profiled.
BATCH, SIZE, STEPS = 4, 224, 3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import cnn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    spec = cnn.VGG16
    params = cnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((BATCH, SIZE, SIZE, 3),
                               generator=gen, device=dev))
    for _ in range(2):                         # build kernels, plans; warm
        cnn.cnn_forward(params, x, spec)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            cnn.cnn_forward(params, x, spec)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        dur = e.device_time_total if hasattr(e, "device_time_total") \
            else e.cuda_time_total
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += dur / 1e3 / STEPS
        rec[1] += 1
    busy = sum(v[0] for v in by_name.values())
    mnf = sum(v[0] for n, v in by_name.items()
              if any(k in n for k in MNF_KERNELS))
    lines = [card,
             f"VGG16@{SIZE} batch {BATCH}, chained forward, "
             f"{STEPS} profiled steps",
             f"host time per forward: {wall_ms:.3f} ms",
             f"device busy per forward: {busy:.3f} ms "
             f"(idle share {max(0.0, 1 - busy / wall_ms):.3f})",
             f"MNF kernels: {mnf:.3f} ms; other device work: "
             f"{busy - mnf:.3f} ms",
             "device ms/forward  launches/forward  kernel"]
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{ms:16.4f}  {n // STEPS:16d}  {name[:110]}")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

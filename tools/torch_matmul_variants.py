#!/usr/bin/env python3
"""Time variants of the event matmul (B2, ``csrc/event_matmul.cu``) on one
NVIDIA GPU, to see what holds a shape back without a profiler that reads
stall reasons.

    python3 tools/torch_matmul_variants.py

Each variant is the source with one edit, built on its own with the
package's nvcc flags into ``build/variants/`` and called through its C
entry on synthetic all-live events (every K-block of every group an
event, values from seed 0) at four shapes VGG16@224 batch 4 hands B2:
FC1, FC2, the conv4_2 and the conv5 per-tap launch.  Variants:

- ``kernel``: the source as it is;
- ``fc_rows_128``: the FC walk at 128 union rows a stage, 6 stages
  (instead of 64 and 8);
- ``fc_one_output``: that, with one output a thread (128 threads, 4 warps
  an SM at FC1) instead of two (64 threads);
- ``fc_stages_4`` and ``fc_stages_12``: the FC ring at 4 and 12 stages
  instead of 8;
- ``no_weight_copies``: the weight rows never copied (the walk without the
  weight stream; outputs wrong);
- ``no_activation_loads``: the activation values never loaded (outputs
  wrong).

Prints the card line, each shape's device ms per variant (CUDA events
around 20 calls after 3 warm ones) and one JSON line.  Needs a card and
nvcc; exits 2 without a card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FC = "using FcShape = MnfMatmulShape<4, 32, 2, 1, 64, 8, 4, 16, 4096>;"
W_COPY = "cp_async<VEC * 4>(dst + q * TN + cc * VEC, w + row * N + n);"
A_LOAD = "            ldg<VA>(a_base +"
EDITS = {
    "kernel": [],
    "fc_rows_128": [(FC, FC.replace("2, 1, 64, 8,", "2, 1, 128, 6,"))],
    "fc_one_output": [(FC, FC.replace("2, 1, 64, 8,", "1, 1, 128, 6,"))],
    "fc_stages_4": [(FC, FC.replace("64, 8, 4,", "64, 4, 2,"))],
    "fc_stages_12": [(FC, FC.replace("64, 8, 4,", "64, 12, 4,"))],
    "no_weight_copies": [(W_COPY, "(void)row;")],
    "no_activation_loads": [(A_LOAD, A_LOAD.replace("ldg", "if (false) ldg"))],
}
#: (G, E, bm, bk, N) of B2's launches in the VGG16@224 batch-4 forward
SHAPES = {"fc1": (4, 3136, 1, 8, 4096), "fc2": (1, 32, 4, 128, 4096),
          "conv4_2": (3136, 64, 1, 8, 512), "conv5": (784, 64, 1, 8, 512)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_matmul_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    src = (build.CSRC / "event_matmul.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                print(f"torch_matmul_variants: {name}: the source no longer "
                      f"holds {old!r} once", file=sys.stderr)
                return 1
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build._FLAGS, "-shared", "-I", str(build.CSRC),
             str(out / f"{name}.cu"), "-o", str(out / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            print(f"[nvcc {name}]\n{log[-3000:]}", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(out / f"{name}.so")).mnf_event_matmul
        fn.argtypes = build._SIGNATURES["mnf_event_matmul"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}
    for shape, (g, e, bm, bk, n) in SHAPES.items():
        vals = torch.randn((g, e, bm, bk), generator=gen, device=dev)
        idx = torch.arange(e, device=dev, dtype=torch.int32).expand(g, e) \
            .contiguous()
        cnt = torch.full((g,), e, device=dev, dtype=torch.int32)
        w = torch.randn((e * bk, n), generator=gen, device=dev)
        y = torch.empty((g, bm, n), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        row = {}
        for name, fn in fns.items():
            def call():
                rc = fn(vals.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                        w.data_ptr(), y.data_ptr(), g, e, bm, bk, n, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            for _ in range(3):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            row[name] = round(start.elapsed_time(end) / 20, 4)
        report[shape] = row
        print(f"{shape} a_vals {(g, e, bm, bk)} x W {(e * bk, n)}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()),
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

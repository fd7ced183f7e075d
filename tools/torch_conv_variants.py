#!/usr/bin/env python3
"""Time variants of the strip conv (B3, ``csrc/event_conv.cu``) on one
NVIDIA GPU, to see what holds a layer back without a profiler that reads
stall reasons.

    python3 tools/torch_conv_variants.py

Each variant is the source with one edit, built on its own with the
package's nvcc flags into ``build/variants/`` and called through its C
entry on synthetic all-live events (every K-block of every strip an event,
values from seed 0) at three VGG16@224 batch-4 strip layers: conv1_2
(4, 224, 224, 64) -> 64, conv2_2 (4, 112, 112, 128) -> 128 and conv3_2
(4, 56, 56, 256) -> 256, all k3 s1 p1.  Variants:

- ``kernel``: the source as it is;
- ``no_weight_copies``: the weight rows never copied (outputs wrong);
- ``no_activation_loads``: the activation values never loaded (outputs
  wrong);
- ``no_plan_scan``: the plan's a_idx scan takes kb = e instead of loading
  it (the same outputs on these all-live events);
- ``no_producer``: no stage's operands stored, copied or loaded after the
  prologue (outputs wrong): the walk's compute, flushes and barriers;
- ``no_compute``: no stage's register-tile update (outputs wrong): the
  plan, the operand traffic and the barriers;
- ``a_lds_once`` and ``w_lds_once``: the register-tile update reads its
  activation (or weight) operands from the stage's first row at every
  row, so the compiler loads them once a stage (outputs wrong): what the
  shared-memory loads cost;
- ``unroll_16``: the stage's two 8-row groups unrolled into one block of
  code (twice the loop's instructions);
- ``carveout_164k``: 164 KB of each SM's 256 KB as shared memory instead
  of 228, the rest L1 (where the three dx taps re-read a source strip);
- ``stages_3`` and ``stages_6``: the weight ring at 3 and 6 stages
  instead of 4;
- ``rows_8`` and ``rows_32``: stages of 8 or 32 union rows instead of 16;
- ``ctas_3``: ``__launch_bounds__`` asking for 3 CTAs an SM instead of 2
  (fewer registers a thread);
- ``strips_8`` and ``strips_32``: CTAs of 8 strips (64 threads, 4 CTAs an
  SM) or 32 strips (256 threads, one CTA an SM) instead of 16.

Prints the card line, each layer's device ms per variant (CUDA events
around 20 calls after 3 warm ones) beside F.conv2d's (f32, TF32 off) on
the same dense map, and one JSON line.  Needs a card and nvcc; exits 2
without a card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
W_COPY = ("cp_async<VEC * 4>(d, ws + ((slab + ul[ub]) * bk + p - ub * bk) "
          "* N + n);")
A_LOAD = "ldg8(a_vals + row_base"
STAGES = "constexpr int kS = 4; "
ROWS = "constexpr int kR = 16; "
SCAN = "const int kb = idx[e];"
STORE_A = "if (i + 1 < nstages) store_a((i + 1) & 1, va, alive);"
ISSUE_W = "if (i + kS - 1 < nstages) issue_w(i + kS - 1, (i + kS - 1) % kS);"
LOAD_A = "if (i + 2 < nstages) alive = load_a(i + 2, va);"
CARVEOUT = "(int)cudaSharedmemCarveoutMaxShared"
Q_LOOP = "#pragma unroll 1\n    for (int q0 = 0; q0 < nq; q0 += 8) {"
A_LDS = "lds<8>(as + q * kAST, a);"
B_LDS = "lds<4>(wsp + q * kTN, b);"
B2_LDS = "lds<4>(wsp + q * kTN + 32, b2);"
COMPUTE = "if (!ALIGNED && q >= nq) break;"
BOUNDS = "__launch_bounds__(kThreads, 2)"
STRIPS = "constexpr int kStrips = 16; "
THREADS = "constexpr int kThreads = 128; "
EDITS = {
    "kernel": [],
    "no_weight_copies": [(W_COPY, "(void)ub;")],
    "no_activation_loads": [(A_LOAD, "if (false) " + A_LOAD)],
    "stages_3": [(STAGES, STAGES.replace("4", "3"))],
    "stages_6": [(STAGES, STAGES.replace("4", "6"))],
    "no_plan_scan": [(SCAN, "const int kb = e;")],
    "no_producer": [(STORE_A, ""), (ISSUE_W, ""), (LOAD_A, "")],
    "no_compute": [(COMPUTE, "break;")],
    "unroll_16": [(Q_LOOP, Q_LOOP.replace("unroll 1", "unroll"))],
    "a_lds_once": [(A_LDS, "lds<8>(as, a);")],
    "w_lds_once": [(B_LDS, "lds<4>(wsp, b);"),
                   (B2_LDS, "lds<4>(wsp + 32, b2);")],
    "carveout_164k": [(CARVEOUT, "72")],
    "rows_8": [(ROWS, ROWS.replace("16", "8"))],
    "rows_32": [(ROWS, ROWS.replace("16", "32"))],
    "ctas_3": [(BOUNDS, BOUNDS.replace("2)", "3)"))],
    "strips_8": [(STRIPS, STRIPS.replace("16", "8")),
                 (THREADS, THREADS.replace("128", "64")),
                 (BOUNDS, BOUNDS.replace("2)", "4)"))],
    "strips_32": [(STRIPS, STRIPS.replace("16", "32")),
                  (THREADS, THREADS.replace("128", "256")),
                  (BOUNDS, BOUNDS.replace("2)", "1)"))],
}
#: (B, H, W, CI), CO of three strip layers of VGG16@224 at batch 4
LAYERS = {"conv1_2": ((4, 224, 224, 64), 64),
          "conv2_2": ((4, 112, 112, 128), 128),
          "conv3_2": ((4, 56, 56, 256), 256)}


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_conv_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import events as ev
    from repro_torch.kernels import build

    src = (build.CSRC / "event_conv.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                print(f"torch_conv_variants: {name}: the source no longer "
                      f"holds {old!r} once", file=sys.stderr)
                return 1
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        (out / f"conv_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build._FLAGS, "-shared", "-I", str(build.CSRC),
             str(out / f"conv_{name}.cu"), "-o",
             str(out / f"conv_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    logs = {name: proc.communicate()[0].decode(errors="replace")
            for name, proc in procs.items()}     # every build ends first
    for name, proc in procs.items():
        log = logs[name]
        if proc.returncode:
            print(f"[nvcc {name}]\n{log[-3000:]}", file=sys.stderr)
            return 1
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in log.splitlines() if "Used " in line})
        print(f"{name}: ptxas {regs}", flush=True)
        fn = ctypes.CDLL(str(out / f"conv_{name}.so")).mnf_event_conv
        fn.argtypes = build._SIGNATURES["mnf_event_conv"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def timed(call) -> float:
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        return round(start.elapsed_time(end) / 20, 4)

    report = {}
    for layer, (shape, co) in LAYERS.items():
        b, h, w, ci = shape
        bk, nkb = 8, ci // 8
        g_in = b * h * w // 8
        vals = torch.randn((g_in, nkb, 8, bk), generator=gen, device=dev)
        idx = torch.arange(nkb, device=dev, dtype=torch.int32) \
            .expand(g_in, nkb).contiguous()
        src_, live, shift, tap = ev.device_plan(ev.strip_tap_map,
                                                (shape, 3, 1, 1), str(dev))
        cnt = torch.where(live, nkb, 0).to(torch.int32)
        ws = torch.randn((9 * nkb * bk, co), generator=gen, device=dev)
        y = torch.empty((src_.shape[0], 8, co), device=dev)
        row = {}
        for name, fn in fns.items():
            def call():
                rc = fn(vals.data_ptr(), idx.data_ptr(), tap.data_ptr(),
                        shift.data_ptr(), src_.data_ptr(), cnt.data_ptr(),
                        ws.data_ptr(), y.data_ptr(), src_.shape[0], nkb, 8,
                        bk, co, src_.shape[1], nkb, 1, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            row[name] = timed(call)
        if layer == "conv1_2":      # the SM clock while the kernel runs
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader", "-lms", "100"],
                stdout=subprocess.PIPE, text=True)
            for _ in range(3000):
                fns["kernel"](vals.data_ptr(), idx.data_ptr(), tap.data_ptr(),
                              shift.data_ptr(), src_.data_ptr(),
                              cnt.data_ptr(), ws.data_ptr(), y.data_ptr(),
                              src_.shape[0], nkb, 8, bk, co, src_.shape[1],
                              nkb, 1, stream)
            torch.cuda.synchronize()
            smi.terminate()
            samples = smi.communicate()[0].split("\n")
            print(f"{layer} kernel x3000: nvidia-smi clocks.sm, power.draw "
                  f"samples {[x for x in samples if x][2:12]}", flush=True)
        x = vals.permute(0, 2, 1, 3).reshape(b, h, w, ci) \
            .permute(0, 3, 1, 2).contiguous()
        wt = ws.reshape(3, 3, ci, co).permute(3, 2, 0, 1).contiguous()
        row["F.conv2d"] = timed(lambda: F.conv2d(x, wt, padding=1))
        report[layer] = row
        print(f"{layer} {shape} -> {co}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()),
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card, "ms": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

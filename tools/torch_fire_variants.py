#!/usr/bin/env python3
"""Time variants of the fire kernel (B1, ``csrc/fire_compact.cu``) on one
NVIDIA GPU, to see what holds it back without a profiler that reads stall
reasons.

    python3 tools/torch_fire_variants.py

Each variant is the source with one edit, built on its own with the
package's nvcc flags into ``build/variants/`` and called through its C
entry on an accumulator of normal values from seed 0 (about half live at
threshold 0) at three launch shapes of the f32 VGG16@224 batch-4 forward:
acc (200704, 64) with strip tiles (8, 8) and with pixel tiles (1, 8), and
acc (50176, 128) with strip tiles.  Variants:

- ``kernel``: the source as it is (a CTA a tile of whole row groups,
  loads and stores with the evict-first hints ``__ldcs`` / ``__stcs``);
- ``plain``: no hints on the 16-byte path; ``ldcs``: the hint on its
  loads only;
- ``grid_stride``: one wave of 528 CTAs (4 an SM at 64 registers)
  striding over the tiles, so no CTA turnover lies between one tile's
  stores and the next tile's loads (shuffle path only: every shape here
  takes it);
- ``rows_4`` and ``rows_16``: 4 or 16 rows a thread loads at once
  instead of 8 (with strip tiles a thread still walks its 8-row band);
- ``ctas_6``: ``__launch_bounds__`` asking for 6 CTAs an SM (fewer
  registers a thread);
- ``rows_4_ctas_6`` and ``rows_2_ctas_8``: 4 rows at once and 6 CTAs an
  SM, or 2 rows and 8 CTAs (every thread of the SM resident);
- ``threads_128`` and ``threads_512``: CTAs of 128 or 512 threads;
- ``no_occ``: the occupancy flags never written (output wrong);
- ``copy_only``: the loaded values stored as they are, no fire and no
  flags (output wrong): the kernel's own copy pace.

Prints the card line, each shape's device ms per variant beside
``torch.relu`` and ``Tensor.copy_`` on the same accumulator, the ptxas
registers of each build, and one JSON line.  Each variant is a CUDA graph
of 20 calls; the graphs are replayed in turns, 3 replays a turn between
CUDA events, for 7 rounds: the median and the range of the rounds.  Every
variant but the "output wrong" ones is checked ``torch.equal`` to the
plain version.
Needs a card and nvcc; exits 2 without a card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS = "constexpr int kRows = 8; "
BOUNDS = "__launch_bounds__(kThreads)"
THREADS = "constexpr int kThreads = 256;"
LOAD = "__ldcs(reinterpret_cast<const float4*>(p));"
STORE = "__stcs(reinterpret_cast<float4*>(q),\n"
STORE_END = "make_float4(x[r][0], x[r][1], x[r][2], x[r][3]));"
RG0 = "  const int64_t rg0 = (int64_t)blockIdx.x * groups;\n"
END = "occ[b0 * nkb + i] = flag[i];\n  }\n}"
GRID = "(unsigned)((row_groups + groups - 1) / groups);"
OCC = "if (on && cq % gc == 0) {"
FIRE = "x[r][i] = y;"
NO_STCS = [(STORE, "*reinterpret_cast<float4*>(q) =\n"),
           (STORE_END, STORE_END[:-2] + ";")]
EDITS = {
    "kernel": [],
    "plain": [(LOAD, "*reinterpret_cast<const float4*>(p);"), *NO_STCS],
    "ldcs": NO_STCS,
    "grid_stride": [
        (RG0, "  for (int64_t rg0 = (int64_t)blockIdx.x * groups; rg0 * rows "
              "< M;\n       rg0 += (int64_t)gridDim.x * groups) {\n"),
        (END, END + "\n}"),
        (GRID, "(unsigned)((row_groups + groups - 1) / groups < 528 ? "
               "(row_groups + groups - 1) / groups : 528);")],
    "rows_4": [(ROWS, ROWS.replace("8", "4"))],
    "rows_16": [(ROWS, ROWS.replace("8", "16"))],
    "ctas_6": [(BOUNDS, "__launch_bounds__(kThreads, 6)")],
    "rows_4_ctas_6": [(ROWS, ROWS.replace("8", "4")),
                      (BOUNDS, "__launch_bounds__(kThreads, 6)")],
    "rows_2_ctas_8": [(ROWS, ROWS.replace("8", "2")),
                      (BOUNDS, "__launch_bounds__(kThreads, 8)")],
    "threads_128": [(THREADS, THREADS.replace("256", "128"))],
    "threads_512": [(THREADS, THREADS.replace("256", "512"))],
    "no_occ": [(OCC, "if (false) {")],
    "copy_only": [(FIRE, "(void)y;"), (OCC, "if (false) {")],
}
EXACT = ("kernel", "plain", "ldcs", "grid_stride", "rows_4", "rows_16",
         "ctas_6", "rows_4_ctas_6", "rows_2_ctas_8", "threads_128",
         "threads_512")
#: (M, K), (bm, bk): launch shapes of the f32 VGG16@224 batch-4 forward
SHAPES = {"acc (200704, 64) tile (8, 8)": ((200704, 64), (8, 8)),
          "acc (200704, 64) tile (1, 8)": ((200704, 64), (1, 8)),
          "acc (50176, 128) tile (8, 8)": ((50176, 128), (8, 8))}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_fire_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.fire_compact.ref import fire_compact_ref

    src = (build.CSRC / "fire_compact.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                print(f"torch_fire_variants: {name}: the source no longer "
                      f"holds {old!r} once", file=sys.stderr)
                return 1
            text = text.replace(old, new)
        (out / f"fire_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build._FLAGS, "-shared", "-I", str(build.CSRC),
             str(out / f"fire_{name}.cu"), "-o", str(out / f"fire_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    logs = {name: proc.communicate()[0].decode(errors="replace")
            for name, proc in procs.items()}     # every build ends first
    fns = {}
    for name, proc in procs.items():
        if proc.returncode:
            print(f"[nvcc {name}]\n{logs[name][-3000:]}", file=sys.stderr)
            return 1
        regs = [line.split("Used ")[1].split(",")[0]
                for line in logs[name].splitlines() if "Used " in line]
        print(f"{name}: ptxas registers {regs}", flush=True)
        fn = ctypes.CDLL(str(out / f"fire_{name}.so")).mnf_fire_compact
        fn.argtypes = build._SIGNATURES["mnf_fire_compact"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def capture(call, iters=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                call()
        graph.replay()
        torch.cuda.synchronize()
        return graph

    def replay_ms(graph, iters=20, reps=3) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * reps)

    report = {}
    for label, ((m, k), (bm, bk)) in SHAPES.items():
        acc = torch.randn((m, k), generator=gen, device="cuda")
        fired = torch.empty_like(acc)
        occ = torch.empty((m // bm, k // bk), dtype=torch.int32,
                          device="cuda")
        f_ref, o_ref = fire_compact_ref(acc, blk_m=bm, blk_k=bk)
        graphs = {}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                rc = fn(acc.data_ptr(), fired.data_ptr(), occ.data_ptr(), m,
                        k, bm, bk, 0.0, 0, 0.0,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            fired.fill_(-1.0)
            occ.fill_(-1)
            call()
            torch.cuda.synchronize()
            if name in EXACT and not (torch.equal(fired, f_ref)
                                      and torch.equal(occ, o_ref)):
                print(f"torch_fire_variants: {name} != plain at {label}",
                      file=sys.stderr)
                return 1
            graphs[name] = capture(call)
        graphs["torch.relu"] = capture(lambda: torch.relu(acc))
        graphs["copy_"] = capture(lambda: fired.copy_(acc))
        rounds = {name: [] for name in graphs}
        for _ in range(7):
            for name, graph in graphs.items():
                rounds[name].append(replay_ms(graph))
        row = {name: [round(statistics.median(t), 5), round(min(t), 5),
                      round(max(t), 5)] for name, t in rounds.items()}
        del graphs
        report[label] = row
        print(f"{label}: median (min-max) ms: " + ", ".join(
            f"{n} {v[0]:.5f} ({v[1]:.5f}-{v[2]:.5f})"
            for n, v in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card, "ms": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

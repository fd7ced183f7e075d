#!/usr/bin/env python3
"""Time variants of the window pool (B4a, ``csrc/event_pool.cu``) and the
gated WKV6 step (B7, ``csrc/wkv6_step.cu``) on one NVIDIA GPU, to see which
parts of their designs pay without a profiler that reads stall reasons.

    python3 tools/torch_pool_step_variants.py [--parent build/parent/src]

Each variant is the source with one edit, built on its own with the
package's nvcc flags into ``build/variants/`` and called through its C
entry.  ``--parent`` names another tree's ``src`` (e.g. the parent commit
unpacked by ``git archive`` under the git-ignored ``build/``): its two
sources are built as they are and timed beside the variants, B7 with its
own signature and the live mask built by ``live_block_mask``.

B4a at pool1 (4, 224, 224, 64) and pool2 (4, 112, 112, 128) of VGG16@224
batch 4, strip events (bm 8, bk 8) of relu(normal) maps from seed 0 (every
tile live, as in the forward), k2 s2:

- ``kernel``: the source as it is (slot table, 16-byte loads, 64 threads
  a strip and 4 strips a CTA: 2 chunks a lane at pool1, 4 at pool2; the
  subtap loop unrolled 8 deep);
- ``loads_4B``: the 4-byte path at every shape;
- ``strips_1``: one strip a CTA;
- ``group_32``, ``group_128``, ``group_256``: up to 32, 128 or 256
  threads a strip (8, 2 or 1 strips a CTA at pool1);
- ``unroll_4``: the subtap loop unrolled 4 deep;
- ``parent``: the other tree's kernel (for a tree before the slot-table
  design: a CTA a strip, every column thread scans every live event of
  every subtap);

beside ``F.max_pool2d`` on the dense NCHW map.

B7 at RWKV6-7B batch 4's decode shape (rows (256, 64), state (256, 64,
64), events (256, 4, 1, 16) of a normal key at θ = 0, every block live):

- ``kernel``: the source as it is (state loads before the barrier, a CTA
  a row, the live mask derived in the kernel, every event load of warp 0
  issued before its stores, after its state loads);
- ``late``: the state loads after the barrier;
- ``events_first``: warp 0 issues its event loads before its state
  loads;
- ``scatter_1``: warp 0 loads one event value and address, stores it,
  then loads the next (a round trip each);
- ``no_scatter``: no event scattered (output wrong): what the drive costs;
- ``split_2``, ``split_4``: 2 or 4 CTAs a row, each a share of the
  columns;
- ``parent``: the other tree's kernel, fed the live mask;
- ``wrapper``: ``wkv6_step_events`` as the model calls it;
  ``parent+mask``: ``live_block_mask`` and the parent kernel, as the
  parent's wrapper ran them;

beside the byte bound (``chip_smoke.wkv6_work``).  The wrappers are also
timed eagerly on the host clock (200 calls, one synchronize), which is
what a decode step pays for them.

Every variant is checked against the plain version (B4a ``torch.equal``,
B7 S' ``torch.equal`` and o within 1e-4 of max|plain|).  Each is a CUDA
graph of 20 calls; the graphs are replayed in turns, 3 replays a turn
between CUDA events, for 7 rounds: the median and the range.  Prints the
card line, ptxas registers of each build, each shape's ms, and one JSON
line.  Needs a card and nvcc; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

POOL_V = "const int V = wide ? 4 : 1;"
POOL_GROUP = "constexpr int kWindowGroup = 64;"
POOL_STRIPS = "int nstrip = kPoolThreads / gsz;"
POOL_UNROLL = ("#pragma unroll 8\n        for (int t = 0; t < T; ++t) {\n"
               "          const int sr")
POOL_EDITS = {
    "kernel": [],
    "loads_4B": [(POOL_V, "const int V = 1; (void)wide;")],
    "strips_1": [(POOL_STRIPS, "int nstrip = 1;")],
    "group_32": [(POOL_GROUP, POOL_GROUP.replace("64", "32"))],
    "group_128": [(POOL_GROUP, POOL_GROUP.replace("64", "128"))],
    "group_256": [(POOL_GROUP, POOL_GROUP.replace("64", "256"))],
    "unroll_4": [(POOL_UNROLL, POOL_UNROLL.replace("8", "4"))],
}
STEP_FETCH = "  fetch(y);                            // the state first\n"
STEP_BARRIER = "  __syncthreads();\n\n  float acc[V], bonus = 0.f;"
STEP_EVENTS = ("    cnt = (int)min((int64_t)counts[g], (int64_t)E);\n"
               "    load_events(0);\n")
STEP_SPLIT = "constexpr int kSplit = 1;"
STEP_SCATTER = "constexpr int kScatter = 4;"
STEP_EDITS = {
    "kernel": [],
    "late": [(STEP_FETCH, ""),
             (STEP_BARRIER, STEP_BARRIER.replace("\n\n", "\n  fetch(y);\n"))],
    "events_first": [(STEP_EVENTS, ""),
                     (STEP_FETCH, "  if (tid < 32) {\n" + STEP_EVENTS
                      + "  }\n" + STEP_FETCH)],
    "scatter_1": [(STEP_SCATTER, STEP_SCATTER.replace("4", "1"))],
    "split_2": [(STEP_SPLIT, STEP_SPLIT.replace("1", "2"))],
    "split_4": [(STEP_SPLIT, STEP_SPLIT.replace("1", "4"))],
    "no_scatter": [("const int ne = E * bk;", "const int ne = 0;")],
}
#: variants whose output is wrong on purpose (not checked)
INEXACT = {"no_scatter"}
#: NHWC maps the window pool reads in VGG16@224 batch 4 (pool1, pool2).
POOLS = {"pool1": (4, 224, 224, 64), "pool2": (4, 112, 112, 128)}
#: RWKV6-7B batch 4: 4 x 64 heads of 64.
G, D = 256, 64
ROUNDS, ITERS, REPS = 7, 20, 3


def build_all(jobs: dict, out: pathlib.Path) -> dict:
    """nvcc every (source text, include dir) of ``jobs`` at once into
    ``out``; returns {name: (library, ptxas registers)}."""
    from repro_torch.kernels import build
    procs = {}
    for name, (text, inc) in jobs.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build._FLAGS, "-shared", "-I", str(inc),
             str(out / f"{name}.cu"), "-o", str(out / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    logs = {name: p.communicate()[0].decode(errors="replace")
            for name, p in procs.items()}       # every build ends first
    libs = {}
    for name, p in procs.items():
        if p.returncode:
            raise RuntimeError(f"nvcc {name}:\n{logs[name][-3000:]}")
        regs = [line.split("Used ")[1].split(",")[0]
                for line in logs[name].splitlines() if "Used " in line]
        libs[name] = (ctypes.CDLL(str(out / f"{name}.so")), regs)
    return libs


def edited(src: str, edits: list) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r} once")
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another tree's src whose B4a and B7 to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_pool_step_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch import engine
    from repro_torch.core import events as ev
    from repro_torch.kernels import build
    from repro_torch.kernels.event_pool.ops import pool_window_inputs
    from repro_torch.kernels.event_pool.ref import event_pool_window_ref
    from repro_torch.kernels.wkv6_step.ops import wkv6_step_events
    from repro_torch.kernels.wkv6_step.ref import wkv6_step_events_ref

    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    pool_src = (build.CSRC / "event_pool.cu").read_text()
    step_src = (build.CSRC / "wkv6_step.cu").read_text()
    jobs = {f"pool_{n}": (edited(pool_src, e), build.CSRC)
            for n, e in POOL_EDITS.items()}
    jobs.update({f"step_{n}": (edited(step_src, e), build.CSRC)
                 for n, e in STEP_EDITS.items()})
    if args.parent:
        pc = pathlib.Path(args.parent).resolve() / "repro_torch" / "csrc"
        jobs["pool_parent"] = ((pc / "event_pool.cu").read_text(), pc)
        jobs["step_parent"] = ((pc / "wkv6_step.cu").read_text(), pc)
    libs = build_all(jobs, out)
    for name, (_, regs) in libs.items():
        print(f"{name}: ptxas registers {regs}", flush=True)
    pool_fns, step_fns = {}, {}
    for name, (lib, _) in libs.items():
        if name.startswith("pool_"):
            fn = lib.mnf_event_pool_window
            fn.argtypes = build._SIGNATURES["mnf_event_pool_window"]
            pool_fns[name[5:]] = fn
        else:
            fn = lib.mnf_wkv6_step
            fn.argtypes = (
                [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 5
                + [ctypes.c_void_p] if name == "step_parent"
                else build._SIGNATURES["mnf_wkv6_step"])
            step_fns[name[5:]] = fn
        fn.restype = ctypes.c_int

    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def capture(call):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(ITERS):
                call()
        graph.replay()
        torch.cuda.synchronize()
        return graph

    def replay_ms(graph) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (ITERS * REPS)

    def rounds(graphs: dict) -> dict:
        times = {name: [] for name in graphs}
        for _ in range(ROUNDS):
            for name, graph in graphs.items():
                times[name].append(replay_ms(graph))
        return {name: [round(statistics.median(t), 5), round(min(t), 5),
                       round(max(t), 5)] for name, t in times.items()}

    def line(label, row, extra=""):
        print(f"{label}: median (min-max) ms: " + ", ".join(
            f"{n} {v[0]:.5f} ({v[1]:.5f}-{v[2]:.5f})"
            for n, v in row.items()) + extra, flush=True)

    def stream_ptr():
        return torch.cuda.current_stream().cuda_stream

    report = {}
    for label, shape in POOLS.items():
        x = torch.relu(torch.randn(shape, generator=gen, device=dev))
        st = engine.EventStream.encode_nhwc(x, blk_k=8, blk_m=8)
        nkb = st.events.num_k_blocks
        a_vals, a_idx, shift, src, cnt = (t.contiguous() for t in
                                          pool_window_inputs(st, 2, 2))
        g_out, t_n = src.shape
        y = torch.empty((g_out, 8, nkb, 8), device=dev)
        want = event_pool_window_ref(a_vals, a_idx, shift, src, cnt,
                                     nkb=nkb, row_stride=2)
        graphs = {}
        for name, fn in pool_fns.items():
            def call(fn=fn, name=name):
                rc = fn(a_vals.data_ptr(), a_idx.data_ptr(),
                        shift.data_ptr(), src.data_ptr(), cnt.data_ptr(),
                        y.data_ptr(), g_out, a_vals.shape[1], 8, nkb, t_n, 2,
                        stream_ptr())
                if rc:
                    raise RuntimeError(f"B4a {name}: CUDA error {rc}")
            y.fill_(-1.0)
            call()
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                print(f"torch_pool_step_variants: B4a {name} != plain at "
                      f"{label}", file=sys.stderr)
                return 1
            graphs[name] = capture(call)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        graphs["F.max_pool2d"] = capture(lambda: F.max_pool2d(x_nchw, 2, 2))
        b = chip_smoke.bound_ms(*chip_smoke.pool_work(a_vals, cnt, y.numel()))
        row = rounds(graphs)
        del graphs
        report[f"B4a {label}"] = dict(ms=row, bound_ms=b[0], bound_by=b[1])
        line(f"B4a {label} {shape}", row, f"; bound {b[0]:.5f} ms ({b[1]})")

    f = lambda *s: torch.randn(s, generator=gen, device=dev)
    r, k, v, u, s = f(G, D), f(G, D), f(G, D), f(G, D), f(G, D, D)
    w = torch.rand((G, D), generator=gen, device=dev) * 0.9 + 0.05
    kst = engine.fire_delta(k, engine.EngineConfig(threshold=0.0))
    bev = kst.events
    bk = kst.blk_k
    e = bev.values.shape[1]
    nkb = bev.num_k_blocks
    o = torch.empty((G, D), device=dev)
    s_new = torch.empty_like(s)
    o2, s2 = wkv6_step_events_ref(bev, r, v, w, u, s, blk_k=bk)
    ev_args = (bev.values, bev.block_idx, bev.counts)
    rows = (r, v, w, u, s, o, s_new)
    graphs = {}
    for name, fn in step_fns.items():
        def call(fn=fn, name=name, mask=None):
            live = () if mask is None else (mask.data_ptr(),)
            rc = fn(*(t.data_ptr() for t in ev_args), *live,
                    *(t.data_ptr() for t in rows), G, e, D, bk, nkb,
                    stream_ptr())
            if rc:
                raise RuntimeError(f"B7 {name}: CUDA error {rc}")
        if name == "parent":
            mask = ev.live_block_mask(bev).to(torch.int32)
            call = (lambda call=call, mask=mask: call(mask=mask))
        s_new.fill_(-1.0)
        call()
        torch.cuda.synchronize()
        ratio = float((o - o2).abs().max()) / float(o2.abs().max())
        if name not in INEXACT and (not torch.equal(s_new, s2)
                                    or ratio > 1e-4):
            print(f"torch_pool_step_variants: B7 {name} != plain (o off "
                  f"{ratio:.3e} of max|plain|)", file=sys.stderr)
            return 1
        graphs[name] = capture(call)
        if name == "parent":
            def parent_wrapper():
                live = ev.live_block_mask(bev).to(torch.int32)
                rc = step_fns["parent"](
                    *(t.data_ptr() for t in ev_args), live.data_ptr(),
                    *(t.data_ptr() for t in rows), G, e, D, bk, nkb,
                    stream_ptr())
                if rc:
                    raise RuntimeError(f"B7 parent: CUDA error {rc}")
            graphs["parent+mask"] = capture(parent_wrapper)

    def wrapper():
        return wkv6_step_events(bev, r, v, w, u, s, blk_k=bk)

    graphs["wrapper"] = capture(wrapper)
    b = chip_smoke.bound_ms(*chip_smoke.wkv6_work(bev, r))
    row = rounds(graphs)
    del graphs
    eager = {"wrapper": wrapper}
    if "parent" in step_fns:
        eager["parent+mask"] = parent_wrapper
    host = {}
    for name, fn in eager.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        host[name] = round((time.perf_counter() - t0) * 1e3 / 200, 5)
    report["B7"] = dict(ms=row, bound_ms=b[0], bound_by=b[1],
                        eager_host_ms=host,
                        shape=f"rows ({G}, {D}), state ({G}, {D}, {D}), "
                              f"events {tuple(bev.values.shape)}")
    line(f"B7 rows ({G}, {D}) events {tuple(bev.values.shape)}", row,
         f"; bound {b[0]:.5f} ms ({b[1]}); eager host ms a call: {host}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "results": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

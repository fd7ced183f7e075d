#!/usr/bin/env python3
"""Time variants of the gated Mamba step (B8, ``csrc/mamba_step.cu``) and
the selective scan (B10, ``csrc/mamba_scan.cu``) on one NVIDIA GPU, to see
which parts of their designs pay without a profiler that reads stall
reasons.

    python3 tools/torch_mamba_variants.py [--parent build/parent/src]

Each variant is the source with one edit, built on its own with the
package's nvcc flags into ``build/variants/`` and called through its C
entry.  ``--parent`` names another tree's ``src`` (e.g. the parent commit
unpacked by ``git archive`` under the git-ignored ``build/``): its two
sources are built as they are and timed beside the variants (B8, with
the live mask built by ``live_block_mask`` where its entry takes one;
B10's streams entry; B10's backward where the tree has one).

B8 at Hymba-1.5B batch 4's decode shape (state (4, 1600, 16), B/C (4, 16),
events (4, 100, 1, 16) of a normal gate at θ = 0, every block live):

- ``kernel``: the source as it is (2 DI-blocks a CTA, the state loads
  and slot kb's address and gate first, 16-byte loads, a warp searches
  the slots only for a block that slot kb does not name);
- ``late``: the state loads after the slot search;
- ``loads_4B``: the 4-byte path;
- ``blocks_1``, ``blocks_4``: 1 or 4 DI-blocks a CTA;
- ``always_search``: every warp searches every slot below the count;
- ``parent``: the other tree's kernel (fed the live mask where its C
  entry takes one, and then ``parent+mask``: ``live_block_mask`` and the
  parent kernel, as the parent's wrapper ran them); ``wrapper``:
  ``mamba_step_events`` as the model calls it;

beside the byte bound (``mamba_step.ops.mamba_work``).  The wrappers are also
timed eagerly on the host clock (200 calls, one synchronize), which is
what a decode step pays for them.

B10 at the main path's prompt-32 launch (dt, x (4, 32, 1600) bf16, B and
C (4, 32, 16) bf16 slices of one wider row, A = -exp(log 1..16)) and at
Hymba layer 0 of a prompt-2000 prefill (4 launches of T 512, 512, 512,
464, h carried): for the streams entry (``streams_*``, fed the streams
torch builds) and the fused entry (``fused_*``):

- ``kernel``: the source as it is (at N 16: 4 state elements a thread,
  64 threads a CTA, 8 steps' loads in flight, 4 steps' readouts reduced
  together by shuffles);
- ``depth_4``, ``depth_16``: the loads of 4 or 16 steps in flight;
- ``threads_128``: 128 threads a CTA;
- ``narrow``: four 4-byte loads a stream a step in place of one 16-byte
  (8-byte for bf16) load;
- ``no_shfl``, ``no_store``: y_t not reduced, or not stored; ``no_exp``:
  da = dt A with no expf; ``const_loads``: no input loaded in the walk
  (outputs wrong: what each part costs);
- ``parent``: the other tree's streams entry;

beside ``build``, the eager building of the two streams alone (what the
fused entry removes), and each entry's bound (``mamba_scan.ops``'s
``mamba_scan_work`` and ``mamba_scan_fused_work``).

B10's backward (``mnf_mamba_scan_fused_bwd``) at the two launches of a
Hymba-1.5B train step of batch 8 x 1024 (two chunks of 512 a layer:
dt, x (8, 512, 1600) bf16 T-slices of (8, 1024, 1600), B and C slices
of one 2N + 100 wide row; chunk 1 with h0 given and gh None, chunk 0
with h0 None and gh given, gy f32):

- ``kernel``: the source as it is (checkpoints every 8 steps in the
  global scratch, 64 channels a CTA of 256 threads at N 16, the
  segment's states and decays in shared memory);
- ``seg_4``, ``seg_16``: segments of 4 or 16 steps; ``seg_32_cta_16``:
  of 32 steps at 16 channels a CTA (64 threads: 32 steps at 64 channels
  take more shared memory than a CTA has);
- ``cta_16``, ``cta_32``: 16 or 32 channels a CTA (64, 128 threads);
- ``parent``: the other tree's ``mnf_mamba_scan_fused_bwd``, with the
  scratch its own launcher sized;

beside B10's forward fused entry on the same launch's inputs (the
backward over the forward is printed) and the bound
(``mamba_scan_fused_bwd_work``).  ``--bwd-only`` times the backward
alone.

Every variant is checked against the plain version (states
``torch.equal``, readouts within 1e-4 of max|plain|; the fused entry's
y ``torch.equal`` the streams entry's of the same build; the backward's
gradients within 1e-4 of max|plain| of ``mamba_scan_fused_bwd_ref`` and
two launches bitwise).  Each is a
CUDA graph of a few calls; the graphs are replayed in turns, 3 replays a
turn between CUDA events, for 7 rounds: the median and the range.  Prints
the card line, ptxas registers of each build, each shape's ms, and one
JSON line.  Needs a card and nvcc; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

STEP_FETCH = ("  fetch(q);                                      "
              "// the state first\n")
STEP_GATE = "  const float g = slot == guess ? g_guess"
STEP_V = "const int V = wide ? 4 : 1;"
STEP_BLOCKS = "constexpr int kBlocks = 2;"
STEP_SEARCH = "if (__any_sync(0xffffffffu, on && !hit)) {"
STEP_EDITS = {
    "kernel": [],
    "late": [(STEP_FETCH, ""), (STEP_GATE, "  fetch(q);\n" + STEP_GATE)],
    "loads_4B": [(STEP_V, "const int V = 1; (void)wide;")],
    "blocks_1": [(STEP_BLOCKS, STEP_BLOCKS.replace("2", "1"))],
    "blocks_4": [(STEP_BLOCKS, STEP_BLOCKS.replace("2", "4"))],
    "always_search": [(STEP_SEARCH, "if (true) {")],
}
SCAN_DEPTH = "  static constexpr int depth = V == 4 ? 8 : 4;"
SCAN_STREAMS = ("struct MambaScanStreams {\n  static constexpr int V = V_;\n"
                "  static constexpr bool wide = WIDE;\n")
SCAN_SOURCES = ("struct MambaScanSources {\n  static constexpr int V = V_;\n"
                "  static constexpr bool wide = WIDE;\n")


def _depth(k):
    deep = SCAN_DEPTH.replace("? 8", f"? {k}")
    return [(SCAN_STREAMS + SCAN_DEPTH, SCAN_STREAMS + deep),
            (SCAN_SOURCES + SCAN_DEPTH, SCAN_SOURCES + deep)]


SCAN_EDITS = {
    "kernel": [],
    "depth_4": _depth(4),
    "depth_16": _depth(16),
    "threads_128": [("constexpr int kThreads4 = 64;",
                     "constexpr int kThreads4 = 128;")],
    "narrow": [("if (wide && (uintptr_t)h0 % 16 == 0",
                "if (false && (uintptr_t)h0 % 16 == 0")],
    "no_shfl": [("reduce_steps<kBatch>(pv, q);", "(void)q;")],
    "no_store": [("if (valid && ts < T) y[(b * T + ts) * DI + d] = pv[0];",
                  "if (valid && ts < T && pv[0] == 1234.5f) "
                  "y[(b * T + ts) * DI + d] = pv[0];")],
    "no_exp": [("da = expf(__fmul_rn(dt, a[v]));",
                "da = __fmul_rn(dt, a[v]);")],
    "const_loads": [("    r.a.load(pa), r.x.load(px), r.c.load(pc);\n",
                     "    r = Raw{};\n"),
                    ("    r.dt.load(pdt), r.x.load(px), r.b.load(pb), "
                     "r.c.load(pc);\n", "    r = Raw{};\n")],
}
#: variants whose output is wrong on purpose (not checked)
INEXACT = {"no_shfl", "no_store", "no_exp", "const_loads"}
BWD_SEG = "constexpr int kBwdSeg = 8; "
BWD_CTA = "constexpr int kBwdChannels4 = 64;"
CTA16 = (BWD_CTA, BWD_CTA.replace("64", "16"))
BWD_EDITS = {
    "kernel": [],
    "seg_4": [(BWD_SEG, BWD_SEG.replace("8", "4"))],
    "seg_16": [(BWD_SEG, BWD_SEG.replace("8", "16"))],
    "seg_32_cta_16": [(BWD_SEG, BWD_SEG.replace("8", "32")), CTA16],
    "cta_16": [CTA16],
    "cta_32": [(BWD_CTA, BWD_CTA.replace("64", "32"))],
}
#: Hymba-1.5B's train step in chip_smoke [13]: batch 8 x 1024, chunks of 512.
TRAIN_B, TRAIN_SEQ = 8, 1024
#: Hymba-1.5B batch 4: DI 1600, state 16, DI-blocks of 16 (RECURRENT_BLK_K).
B, DI, N, BK = 4, 1600, 16, 16
PROMPT, LONG, CHUNK = 32, 2000, 512
ROUNDS, REPS = 7, 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another tree's src whose B8 and B10 to time")
    ap.add_argument("--bwd-only", action="store_true",
                    help="time B10's backward alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_mamba_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))

    import chip_smoke
    from repro_torch import engine
    from repro_torch.core import events as ev
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                    mamba_scan_streams)
    from repro_torch.kernels.mamba_scan.ops import (mamba_scan_fused_work,
                                                    mamba_scan_work)
    from repro_torch.kernels.mamba_step.ops import (mamba_step_events,
                                                    mamba_work)
    from repro_torch.kernels.mamba_step.ref import mamba_step_events_ref
    from torch_pool_step_variants import build_all, edited

    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    step_src = (build.CSRC / "mamba_step.cu").read_text()
    scan_src = (build.CSRC / "mamba_scan.cu").read_text()
    jobs = {} if args.bwd_only else {
        f"step_{n}": (edited(step_src, e), build.CSRC)
        for n, e in STEP_EDITS.items()}
    if not args.bwd_only:
        jobs.update({f"scan_{n}": (edited(scan_src, e), build.CSRC)
                     for n, e in SCAN_EDITS.items()})
    jobs.update({f"bwd_{n}": (edited(scan_src, e), build.CSRC)
                 for n, e in BWD_EDITS.items()})
    if args.parent:
        pc = pathlib.Path(args.parent).resolve() / "repro_torch" / "csrc"
        if not args.bwd_only:
            jobs["step_parent"] = ((pc / "mamba_step.cu").read_text(), pc)
            jobs["scan_parent"] = ((pc / "mamba_scan.cu").read_text(), pc)
        scan_parent = (pc / "mamba_scan.cu").read_text()
        if "mnf_mamba_scan_fused_bwd" in scan_parent:
            jobs["bwd_parent"] = (scan_parent, pc)
    # a parent whose B8 takes the live mask (one pointer more)
    parent_mask = False
    if args.parent and not args.bwd_only:
        text = (pc / "mamba_step.cu").read_text()
        head = text[text.index('extern "C" int mnf_mamba_step('):]
        parent_mask = head[:head.index(")")].count("void*") == 11
    t0 = time.perf_counter()
    libs = build_all(jobs, out)
    print(f"{len(jobs)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, (_, regs) in libs.items():
        print(f"{name}: ptxas registers {regs}", flush=True)

    def entry(lib, name, argtypes):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    sig = build._SIGNATURES
    step_fns = {n[5:]: entry(lib, "mnf_mamba_step", (
        [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        if n == "step_parent" and parent_mask else sig["mnf_mamba_step"]))
        for n, (lib, _) in libs.items() if n.startswith("step_")}
    streams_fns = {n[5:]: entry(lib, "mnf_mamba_scan", sig["mnf_mamba_scan"])
                   for n, (lib, _) in libs.items() if n.startswith("scan_")}
    fused_fns = {n[5:]: entry(lib, "mnf_mamba_scan_fused",
                              sig["mnf_mamba_scan_fused"])
                 for n, (lib, _) in libs.items()
                 if n.startswith("scan_") and n != "scan_parent"}

    bwd_fns = {n[4:]: entry(lib, "mnf_mamba_scan_fused_bwd",
                            sig["mnf_mamba_scan_fused_bwd"])
               for n, (lib, _) in libs.items() if n.startswith("bwd_")}

    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f = lambda *s: torch.randn(s, generator=gen, device=dev)

    def stream_ptr():
        return torch.cuda.current_stream().cuda_stream

    def capture(call, iters):
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
        return graph, iters

    def rounds(graphs: dict) -> dict:
        times = {name: [] for name in graphs}
        for _ in range(ROUNDS):
            for name, (graph, iters) in graphs.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    graph.replay()
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / (iters * REPS))
        return {name: [round(statistics.median(t), 5), round(min(t), 5),
                       round(max(t), 5)] for name, t in times.items()}

    def line(label, row, extra=""):
        print(f"{label}: median (min-max) ms: " + ", ".join(
            f"{n} {v[0]:.5f} ({v[1]:.5f}-{v[2]:.5f})"
            for n, v in row.items()) + extra, flush=True)

    def ratio(y, want):
        return float((y - want).abs().max()) / max(float(want.abs().max()),
                                                   1e-30)

    report = {}
    if args.bwd_only:
        return finish(bwd_part(torch, dev, f, bwd_fns, libs, capture,
                               rounds, line, ratio, report), card, report)

    # -- B8 ------------------------------------------------------------------
    g, bm, cm, h = f(B, DI), f(B, N), f(B, N), f(B, DI, N)
    da = torch.rand((B, DI, N), generator=gen, device=dev) * 0.9 + 0.05
    gst = engine.fire_delta(g, engine.EngineConfig(threshold=0.0))
    bev = gst.events
    e = bev.values.shape[1]
    nkb = bev.num_k_blocks
    assert bool(ev.live_block_mask(bev).all()), "a dead block at θ = 0"
    y = torch.empty((B, DI), device=dev)
    h_new = torch.empty_like(h)
    y2, h2 = mamba_step_events_ref(bev, da, bm, cm, h, blk_k=BK)
    evs = (bev.values, bev.block_idx, bev.counts)
    rows = (da, bm, cm, h, y, h_new)
    graphs = {}
    for name, fn in step_fns.items():
        def call(fn=fn, name=name, mask=None):
            live = () if mask is None else (mask.data_ptr(),)
            rc = fn(*(t.data_ptr() for t in evs), *live,
                    *(t.data_ptr() for t in rows), B, e, DI, N, BK, nkb,
                    stream_ptr())
            if rc:
                raise RuntimeError(f"B8 {name}: CUDA error {rc}")
        if name == "parent" and parent_mask:
            mask = ev.live_block_mask(bev).to(torch.int32)
            call = (lambda call=call, mask=mask: call(mask=mask))
        h_new.fill_(-1.0)
        call()
        torch.cuda.synchronize()
        r = ratio(y, y2)
        if not torch.equal(h_new, h2) or r > 1e-4:
            print(f"torch_mamba_variants: B8 {name} != plain (y off {r:.3e}"
                  f" of max|plain|)", file=sys.stderr)
            return 1
        graphs[name] = capture(call, 20)
        if name == "parent" and parent_mask:
            def parent_wrapper():
                live = ev.live_block_mask(bev).to(torch.int32)
                rc = step_fns["parent"](
                    *(t.data_ptr() for t in evs), live.data_ptr(),
                    *(t.data_ptr() for t in rows), B, e, DI, N, BK, nkb,
                    stream_ptr())
                if rc:
                    raise RuntimeError(f"B8 parent: CUDA error {rc}")
            graphs["parent+mask"] = capture(parent_wrapper, 20)

    def wrapper():
        return mamba_step_events(bev, da, bm, cm, h, blk_k=BK)

    graphs["wrapper"] = capture(wrapper, 20)
    b = chip_smoke.bound_ms(*mamba_work(bev, h))
    row = rounds(graphs)
    del graphs
    eager = {"wrapper": wrapper}
    if parent_mask:
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
    shape = (f"state ({B}, {DI}, {N}), B/C ({B}, {N}), events "
             f"{tuple(bev.values.shape)}")
    report["B8"] = dict(ms=row, bound_ms=b[0], bound_by=b[1],
                        eager_host_ms=host, shape=shape)
    line(f"B8 {shape}", row, f"; bound {b[0]:.5f} ms ({b[1]}); eager host "
         f"ms a call: {host}")

    # -- B10 -----------------------------------------------------------------
    def sources(t):
        """dt, x (B, t, DI), A, B, C (B, t, N) as the Hymba prefill hands
        them: bf16, B and C slices of one wider row."""
        dt = torch.nn.functional.softplus(f(B, t, DI)).bfloat16()
        bc = f(B, t, 2 * N + 100).bfloat16()
        a = -torch.arange(1, N + 1, dtype=torch.float32,
                          device=dev).repeat(DI, 1)
        return dt, f(B, t, DI).bfloat16(), a, bc[..., :N], bc[..., N:2 * N]

    def chunks(src, t):
        return [tuple(x[:, c0:c0 + CHUNK] if x.dim() == 3 else x
                      for x in src) for c0 in range(0, t, CHUNK)]

    for label, t_all in (("prompt 32", PROMPT), ("layer 0 at prompt 2000",
                                                 LONG)):
        parts = chunks(sources(t_all), t_all)
        streams = [tuple(x.contiguous() for x in mamba_scan_streams(*p))
                   for p in parts]
        h0s = [None] + [torch.empty((B, DI, N), device=dev)
                        for _ in parts[1:]]
        ys = [torch.empty((B, p[0].shape[1], DI), device=dev) for p in parts]
        hs = [torch.empty((B, DI, N), device=dev) for _ in parts]
        want = []
        h_prev = None
        for p in parts:
            yw, h_prev = mamba_scan_fused_ref(*p, h_prev)
            want.append((yw, h_prev))

        def run(kind, fn, name):
            """One layer: every chunk, h carried into the next."""
            def go():
                for i, (p, s) in enumerate(zip(parts, streams)):
                    h_in = None if i == 0 else hs[i - 1]
                    t = p[0].shape[1]
                    if kind == "streams":
                        rc = fn(*(x.data_ptr() for x in s),
                                0 if h_in is None else h_in.data_ptr(),
                                ys[i].data_ptr(), hs[i].data_ptr(), B, t,
                                DI, N, stream_ptr())
                    else:
                        strides = [st for x in (p[0], p[1], p[3], p[4])
                                   for st in x.stride()[:2]]
                        rc = fn(*(x.data_ptr() for x in p),
                                0 if h_in is None else h_in.data_ptr(),
                                ys[i].data_ptr(), hs[i].data_ptr(), B, t,
                                DI, N, *strides, 1, stream_ptr())
                    if rc:
                        raise RuntimeError(f"B10 {kind} {name}: CUDA error "
                                           f"{rc}")
            return go

        graphs, outs = {}, {}
        iters = 20 if t_all == PROMPT else 2
        for kind, fns in (("streams", streams_fns), ("fused", fused_fns)):
            for name, fn in fns.items():
                go = run(kind, fn, name)
                for x in hs:
                    x.fill_(-1.0)
                go()
                torch.cuda.synchronize()
                graphs[f"{kind}_{name}"] = capture(go, iters)
                if name in INEXACT:
                    continue
                for (yw, hw), y_, h_ in zip(want, ys, hs):
                    r = ratio(y_, yw)
                    if not torch.equal(h_, hw) or r > 1e-4:
                        print(f"torch_mamba_variants: B10 {kind} {name} != "
                              f"plain at {label} (y off {r:.3e})",
                              file=sys.stderr)
                        return 1
                outs[(kind, name)] = [y_.clone() for y_ in ys]
        for name in set(fused_fns) - INEXACT:
            if not all(torch.equal(a, b_) for a, b_ in zip(
                    outs[("fused", name)], outs[("streams", name)])):
                print(f"torch_mamba_variants: B10 fused {name} y is not "
                      f"bitwise the streams entry's at {label}",
                      file=sys.stderr)
                return 1
        graphs["build"] = capture(
            lambda: [mamba_scan_streams(*p) for p in parts], 1)
        bs = chip_smoke.bound_ms(*map(sum, zip(*(
            mamba_scan_work(*s[:3], None if i == 0 else s[0])
            for i, s in enumerate(streams)))))
        bf = chip_smoke.bound_ms(*map(sum, zip(*(
            mamba_scan_fused_work(*p[:5], None if i == 0 else p[0])
            for i, p in enumerate(parts)))))
        row = rounds(graphs)
        del graphs, outs
        ts = [p[0].shape[1] for p in parts]
        report[f"B10 {label}"] = dict(
            ms=row, streams_bound_ms=bs[0], streams_bound_by=bs[1],
            fused_bound_ms=bf[0], fused_bound_by=bf[1], T=ts)
        line(f"B10 {label} (T {ts}, h carried)", row,
             f"; bound streams {bs[0]:.5f} ms ({bs[1]}), fused {bf[0]:.5f} "
             f"ms ({bf[1]})")
        del parts, streams, want, ys, hs, h0s
        torch.cuda.empty_cache()
    return finish(bwd_part(torch, dev, f, bwd_fns, libs, capture, rounds,
                           line, ratio, report), card, report)


def finish(rc: int, card: str, report: dict) -> int:
    import torch
    if rc == 0:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "card": card, "results": report}), flush=True)
    return rc


def bwd_part(torch, dev, f, fns, libs, capture, rounds, line, ratio,
             report) -> int:
    """B10's backward at the two launches of [13]'s Hymba step (module
    docstring): each build checked, then timed in 7 interleaved rounds
    beside the forward fused entry on the same inputs."""
    import chip_smoke
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_fused_cuda
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused_bwd_work
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_fused_bwd_ref

    def stream_ptr():
        return torch.cuda.current_stream().cuda_stream

    t = TRAIN_SEQ // 2
    dt_all = torch.nn.functional.softplus(
        f(TRAIN_B, TRAIN_SEQ, DI)).bfloat16()
    x_all = f(TRAIN_B, TRAIN_SEQ, DI).bfloat16()
    bc_all = f(TRAIN_B, TRAIN_SEQ, 2 * N + 100).bfloat16()
    a = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(DI,
                                                                        1)
    launches = {}
    for chunk in (1, 0):
        sl = slice(chunk * t, (chunk + 1) * t)
        h0 = f(TRAIN_B, DI, N) if chunk else None
        gh = None if chunk else f(TRAIN_B, DI, N) * 1e-2
        launches[f"chunk {chunk}"] = (
            dt_all[:, sl], x_all[:, sl], a, bc_all[:, sl, :N],
            bc_all[:, sl, N:2 * N], h0, f(TRAIN_B, t, DI) * 1e-2, gh)
    # one scratch for every build: the parent's size, the largest
    parent_floats = 2 * TRAIN_B * t * DI * N + TRAIN_B * DI * N \
        + 2 * 16 * TRAIN_B * t * N
    scratch = torch.empty(parent_floats, dtype=torch.float32, device=dev)
    for what, args in launches.items():
        dt, x, a_, bm, cm, h0, gy, gh = args
        want = mamba_scan_fused_bwd_ref(dt.float(), x.float(), a_,
                                        bm.float(), cm.float(), h0, gy, gh)
        outs = [torch.empty(w.shape, dtype=torch.float32, device=dev)
                if w is not None else None for w in want]
        strides = [st for m in (dt, x, bm, cm) for st in m.stride()[:2]]
        ptr = lambda m: 0 if m is None else m.data_ptr()
        graphs = {}
        for name, fn in fns.items():
            def go(fn=fn, name=name):
                rc = fn(*(ptr(m) for m in (dt, x, a_, bm, cm, h0, gy, gh)),
                        *(ptr(o) for o in outs), scratch.data_ptr(),
                        TRAIN_B, t, DI, N, *strides, 1, stream_ptr())
                if rc:
                    raise RuntimeError(f"B10 bwd {name}: CUDA error {rc}")
            runs = []
            for _ in range(2):
                for o in outs:
                    if o is not None:
                        o.fill_(float("nan"))
                go()
                torch.cuda.synchronize()
                runs.append([None if o is None else o.clone()
                             for o in outs])
            for gname, u, v, w in zip(("dt", "x", "A", "B", "C", "h0"),
                                      runs[0], runs[1], want):
                if w is None:
                    continue
                r = ratio(u, w.float())
                if r > 1e-4 or not torch.equal(u, v):
                    print(f"torch_mamba_variants: B10 bwd {name} d{gname} "
                          f"off {r:.3e} of max|plain| at {what} (two "
                          f"launches equal: {torch.equal(u, v)})",
                          file=sys.stderr)
                    return 1
            graphs[name] = capture(go, 5)
        fwd = (dt, x, a_, bm, cm, h0)
        graphs["forward"] = capture(lambda: mamba_scan_fused_cuda(*fwd), 5)
        b = chip_smoke.bound_ms(*mamba_scan_fused_bwd_work(*args))
        row = rounds(graphs)
        del graphs
        shape = (f"dt/x {tuple(dt.shape)} bf16, B/C {tuple(bm.shape)}, h0 "
                 f"{'given' if h0 is not None else 'None'}, gh "
                 f"{'given' if gh is not None else 'None'}")
        report[f"B10 bwd {what}"] = dict(
            ms=row, bound_ms=b[0], bound_by=b[1], shape=shape,
            bwd_over_fwd=round(row["kernel"][0] / row["forward"][0], 3),
            registers={n: libs[f"bwd_{n}"][1] for n in fns})
        line(f"B10 bwd {what}: {shape}", row,
             f"; bound {b[0]:.5f} ms ({b[1]}); backward / forward "
             f"{row['kernel'][0] / row['forward'][0]:.2f}")
        del want, outs, runs
    del scratch
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

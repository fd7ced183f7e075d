#!/usr/bin/env python3
"""Time variants of the WKV6 recurrence (B9/B9', ``csrc/wkv6.cu``) on one
NVIDIA GPU, to see which parts of its design pay without a profiler that
reads stall reasons.

    python3 tools/torch_wkv6_variants.py [--parent build/parent/src]

Each variant is the source with one edit, built on its own with the
package's nvcc flags into ``build/variants/`` and called through its C
entry:

- ``kernel``: the source as it is (8 lanes a column group, 2 columns a
  thread below 128 tokens and 4 from there on, 1 chunk of 32 tokens in
  flight, a CTA a row);
- ``lanes_1``, ``lanes_2``, ``lanes_4``, ``lanes_16``: 1, 2, 4 or 16
  lanes a column group (the rows of S split that many ways; 1 and 1, 2
  and 2, 2 and 4, 2 and 4 columns a thread; 16 lanes reduce 8 tokens'
  readouts at once, as the source's 8 lanes do);
- ``cols_1``, ``cols_8``: 1 or 8 columns a thread at every T; ``cols_2``,
  ``cols_4``: the source's 2 or 4 at every T;
- ``group_4``: 4 tokens' readouts reduced at once (after a butterfly over
  the lanes above them) in place of 8;
- ``depth_2``, ``depth_3``: 2 or 3 chunks in flight;
- ``chunk_16``: 16 tokens a chunk;
- ``split``: a row's columns split over CTAs while the rows leave SMs
  idle (B9's 4 rows: 4 CTAs a row);
- ``loads_4B``: 4-byte copies into the staging ring (16 bytes for four
  f32, 8 for four bf16 in the source);
- ``no_bonus``, ``no_loads``, ``no_stores``: the bonus not summed, no
  input copied, o not stored (outputs wrong: what each part costs);
- ``parent``: the other tree's kernel (``--parent``), fed the contiguous
  f32 copies its wrapper made, and ``parent+copies``: those copies and
  the kernel, as the parent's wrapper ran them; ``wrapper``: ``wkv6`` as
  a caller calls it;

at three shapes of the RWKV6-7B prefill, batch 4 (64 heads of 64), as it
hands the WKV its inputs (bf16 r, k, v and f32 w, (B, H, T, D) views of
(B, T, H, D) tensors): B9' at prompt 32 (rows (256, 32, 64)) and at
prompt 2000 (rows (256, 2000, 64)), and B9 on head 0's rows (4, 32, 64);
also B9' at prompt 128, where the source turns to 4 columns a thread.
Beside each: the bound (``chip_smoke.wkv6_scan_work``: bytes over 3.35
TB/s or f32 operations over 67 TFLOP/s) and the f32 issue floor (4
instructions a state element and token, the bitwise update's multiply,
multiply and add and the readout's fmaf, over 132 SMs x 128 lanes x 1.98
GHz).

Every exact variant is checked against the plain version (S
``torch.equal``, o within 1e-4 of max|plain|) and B9 against B9''s slice
(bitwise).  Each is a CUDA graph of a few calls; the graphs are replayed
in turns, 3 replays a turn between CUDA events, for 7 rounds: the median
and the range.  Prints the card line, ptxas registers of each build, each
shape's ms, and one JSON line.  Needs a card and nvcc; exits 2 without a
card.
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

BONUS = "        bonus = bonus4(f[0], u4, f[1]);\n"
SHFL = "      for (int m = a.P2 / 2; m >= 1; m >>= 1)\n"
LANES = "constexpr int kLanes = 8;"
SHORT = "constexpr int kColsShort = 2;"
LONG = "constexpr int kColsLong = 4;"
GROUP = "constexpr int kGroup = kLanes;"
LONG_T = "constexpr int64_t kLongT = 128;"


def _shape(lanes, short, long, group=None):
    """lanes a column group, columns a thread below and from kLongT tokens
    on, tokens whose readouts reduce at once."""
    edits = [(LANES, LANES.replace("8", str(lanes))),
             (SHORT, SHORT.replace("2", str(short))),
             (LONG, LONG.replace("4", str(long)))]
    return edits + ([] if group is None else
                    [(GROUP, GROUP.replace("kLanes;", f"{group};"))])


EDITS = {
    "kernel": [],
    "lanes_1": _shape(1, 1, 1),
    "lanes_2": _shape(2, 2, 2),
    "lanes_4": _shape(4, 2, 4),
    "lanes_16": _shape(16, 2, 4, 8),
    "cols_1": _shape(8, 1, 1),
    "cols_2": [(LONG_T, LONG_T.replace("128", "int64_t{1} << 62"))],
    "cols_4": [(LONG_T, LONG_T.replace("128", "0"))],
    "cols_8": _shape(8, 8, 8),
    "group_4": _shape(8, 2, 4, 4),
    "depth_2": [("constexpr int kDepth = 1;", "constexpr int kDepth = 2;")],
    "depth_3": [("constexpr int kDepth = 1;", "constexpr int kDepth = 3;")],
    "chunk_16": [("constexpr int kChunk = 32;", "constexpr int kChunk = 16;")],
    "split": [("constexpr bool kSplit = false;",
               "constexpr bool kSplit = true;")],
    "loads_4B": [("constexpr int kMaxUnit = 16;",
                  "constexpr int kMaxUnit = 4;")],
    "no_bonus": [(BONUS, ""),
                 (SHFL, SHFL.replace("a.P2 / 2", "0"))],
    "no_loads": [("        if (tok >= T) break;",
                  "        if (tok >= 0) break;")],
    "no_stores": [("      if (q < kGroup && valid && (!CHECK || tt < tc)) {",
                   "      if (q < kGroup && valid && (!CHECK || tt < tc) && "
                   "pv[0][0] == 1234.5f) {")],
}
#: variants whose output is wrong on purpose (not checked)
INEXACT = {"no_bonus", "no_loads", "no_stores"}
#: RWKV6-7B batch 4: 64 heads of 64.
B, H, D = 4, 64, 64
PROMPT, LONG = 32, 2000
ROUNDS, REPS = 7, 3
#: f32 lane-instructions a second: 132 SMs x 128 lanes x 1.98 GHz.
F32_ISSUE = 132 * 128 * 1.98e9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another tree's src whose B9/B9' to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_wkv6_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_single
    from repro_torch.kernels.wkv6.ref import wkv6_multihead_ref
    from torch_pool_step_variants import build_all, edited

    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "wkv6.cu").read_text()
    jobs = {n: (edited(src, e), build.CSRC) for n, e in EDITS.items()}
    if args.parent:
        pc = pathlib.Path(args.parent).resolve() / "repro_torch" / "csrc"
        jobs["parent"] = ((pc / "wkv6.cu").read_text(), pc)
    t0 = time.perf_counter()
    libs = build_all(jobs, out)
    print(f"{len(jobs)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, (_, regs) in libs.items():
        print(f"{name}: ptxas registers {regs}", flush=True)

    def entry(lib, argtypes):
        fn = lib.mnf_wkv6
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    parent_sig = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4 \
        + [ctypes.c_void_p]
    fns = {n: entry(lib, parent_sig if n == "parent"
                    else build._SIGNATURES["mnf_wkv6"])
           for n, (lib, _) in libs.items()}

    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def stream_ptr():
        return torch.cuda.current_stream().cuda_stream

    def inputs(t):
        """r, k, v bf16 and w f32, each a (B, H, T, D) view of (B, T, H,
        D) as the prefill hands them; w = exp(-exp(x)) in (0, 1); u."""
        f = lambda: torch.randn((B, t, H, D), generator=gen, device=dev)
        rows = [f().bfloat16().transpose(1, 2) for _ in range(3)]
        w = torch.exp(-torch.exp(f() * 0.5 - 1.0)).transpose(1, 2)
        return rows + [w], torch.randn((H, D), generator=gen, device=dev)

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

    def ratio(y, want):
        return float((y - want).abs().max()) / max(float(want.abs().max()),
                                                   1e-30)

    report, b9p_head0 = {}, {}
    for label, t, heads in (("B9' prompt 32", PROMPT, H),
                            ("B9 head 0 prompt 32", PROMPT, 1),
                            ("B9' prompt 128", 128, H),
                            ("B9' prompt 2000", LONG, H)):
        if heads == 1:                       # head 0's rows, as B9 takes
            rows, u = [x[:, 0] for x in b9p_rows], b9p_u[0]
        else:
            rows, u = inputs(t)
        if label == "B9' prompt 32":
            b9p_rows, b9p_u = rows, u
        r4 = [x.unsqueeze(1) if heads == 1 else x for x in rows]
        u2 = u.reshape(-1, D)
        g = B * (H if heads > 1 else 1)
        o = torch.empty((g, t, D), device=dev)
        s = torch.empty((g, D, D), device=dev)
        strides = [st if n > 1 else 0 for x in r4
                   for st, n in zip(x.stride()[:3], x.shape[:3])]
        flat = [x.float().reshape(g, t, D).contiguous() for x in r4]
        o2, s2 = wkv6_multihead_ref(*r4, u2)
        o2, s2 = o2.reshape(g, t, D), s2.reshape(g, D, D)

        def call_for(name, fn):
            if name == "parent":
                def go():
                    rc = fn(*(x.data_ptr() for x in flat), u2.data_ptr(),
                            None, o.data_ptr(), s.data_ptr(), g, t, D,
                            u2.shape[0], stream_ptr())
                    if rc:
                        raise RuntimeError(f"parent: CUDA error {rc}")
                return go

            def go():
                rc = fn(*(x.data_ptr() for x in r4), u2.data_ptr(), None,
                        o.data_ptr(), s.data_ptr(), B, u2.shape[0], t, D,
                        *strides, 7, stream_ptr())
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            return go

        graphs = {}
        iters = 20 if t < LONG else 3
        for name, fn in fns.items():
            go = call_for(name, fn)
            s.fill_(-1.0)
            go()
            torch.cuda.synchronize()
            if name not in INEXACT:
                r = ratio(o, o2)
                if not torch.equal(s, s2) or r > 1e-4:
                    print(f"torch_wkv6_variants: {name} != plain at {label}"
                          f" (o off {r:.3e} of max|plain|)", file=sys.stderr)
                    return 1
                if heads == 1 and name != "parent" and not (
                        torch.equal(o, b9p_head0[name][0])
                        and torch.equal(s, b9p_head0[name][1])):
                    print(f"torch_wkv6_variants: B9 {name} is not B9''s "
                          f"head 0 bitwise", file=sys.stderr)
                    return 1
                if label == "B9' prompt 32":
                    head0 = lambda x: x.reshape(B, H, *x.shape[1:])[:, 0]
                    b9p_head0[name] = (head0(o).clone(), head0(s).clone())
            graphs[name] = capture(go, iters)
            if name == "parent":
                def with_copies(go=go):
                    for x, y in zip(flat, r4):
                        x.copy_(y.reshape(flat[0].shape))
                    go()
                graphs["parent+copies"] = capture(with_copies, iters)
        op = wkv6 if heads > 1 else wkv6_single
        graphs["wrapper"] = capture(lambda: op(*rows, u), iters)
        row = rounds(graphs)
        del graphs
        b = chip_smoke.bound_ms(*chip_smoke.wkv6_scan_work(*r4, u2, None))
        issue_ms = 4.0 * D * D * g * t / F32_ISSUE * 1e3
        shape = f"rows ({g}, {t}, {D}), r/k/v bf16, w f32, strided views"
        report[label] = dict(ms=row, bound_ms=b[0], bound_by=b[1],
                             f32_issue_ms=issue_ms, shape=shape)
        print(f"{label} {shape}: median (min-max) ms: " + ", ".join(
            f"{n} {v[0]:.5f} ({v[1]:.5f}-{v[2]:.5f})"
            for n, v in row.items())
            + f"; bound {b[0]:.5f} ms ({b[1]}), f32 issue floor "
            f"{issue_ms:.5f} ms", flush=True)
        del o, s, o2, s2, flat
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "results": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

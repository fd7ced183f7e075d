#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA GPU (built for the H100, sm_90a).

    python3 chip_smoke.py

Phases (any mismatch exits non-zero):

1. Probe and build: the card's name and power limit, TF32 off for the dense
   oracles, the CUDA kernels built from src/repro_torch/csrc.
2. The slice: VGG16 at 224x224, full widths, batch 4 (four requests), He
   weights from a seeded torch.Generator with weight sparsity 0.5, inputs
   relu(normal).  Every kernel's launch counter is set to 0 just before the
   chained forward and read just after; each must have moved.  Each
   wrapper's ``capture`` list collects the inputs of its launches.  The trace
   must hold no fallback_decode, the plan no densify point; chained ==
   round-trip bitwise; logits within 5e-3 of the dense oracle and within
   1e-4 of its largest magnitude.  Prints the warm forward time (median
   of 3).
3. Kernel checks: each kernel against its plain PyTorch version on the
   inputs the forward handed it (captured during phase 2), plus the strip
   conv at stride 4 and 2 (ALEXNET_FF@256 conv1 and a k3s2 layer).  Pools
   and fire must agree exactly; the event matmul and strip conv within
   max|d| <= 1e-4 * max|plain| (the kernel accumulates with fmaf, the plain
   version with a separate multiply and add: one rounding fewer per step).
   The forward's matmuls, strip convs and pools are also held against
   torch.matmul, F.conv2d and F.max_pool2d on the decoded maps (the same
   tolerance; pools exact).
   Prints each kernel's time, the plain version's, one PyTorch library
   call's on the same function, and the bound.

The last lines are the card line, a JSON line of per-kernel numbers, and
the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and f32
#: FLOP/s outside the tensor cores — the kernels here are f32 CUDA-core code.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

KERNELS = {  # name: (source, TPU kernel it replaces)
    "fire_compact": ("src/repro_torch/csrc/fire_compact.cu",
                     "src/repro/kernels/fire_compact/kernel.py:54"),
    "event_matmul": ("src/repro_torch/csrc/event_matmul.cu",
                     "src/repro/kernels/event_matmul/kernel.py:163"),
    "event_conv": ("src/repro_torch/csrc/event_conv.cu",
                   "src/repro/kernels/event_conv/kernel.py:213"),
    "event_pool_window": ("src/repro_torch/csrc/event_pool.cu",
                          "src/repro/kernels/event_pool/kernel.py:200"),
    "event_pool": ("src/repro_torch/csrc/event_pool.cu",
                   "src/repro/kernels/event_pool/kernel.py:106"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device ms per call over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# Per-kernel work: the bytes each input/output moves once and the operations
# this run's data needs (live events only).
# ---------------------------------------------------------------------------

def matmul_work(torch, a_vals, a_idx, counts, w):
    g, e, bm, bk = a_vals.shape
    n = w.shape[1]
    cnt = counts.clamp(max=e).long()
    live = torch.arange(e, device=cnt.device)[None, :] < cnt[:, None]
    slots = int(cnt.sum())
    blocks = int(torch.unique(a_idx[live]).numel())
    nbytes = (slots * (bm * bk + 1) + g) * 4 + blocks * bk * n * 4 \
        + g * bm * n * 4
    return nbytes, 2.0 * slots * bm * bk * n


def live_slots(a_vals):
    """(G, E) live event slots: padding slots hold zeros, a live tile from
    the fire phase holds a non-zero value."""
    return a_vals.flatten(2).ne(0).any(-1)


def conv_work(torch, args, stride):
    a_vals, a_idx, tap, shift, src, cnt, ws = args
    g_in, e, bm, bk = a_vals.shape
    g_out, t_n = src.shape
    n = ws.shape[1]
    live = live_slots(a_vals)
    slots = int(live.sum())
    blocks = int(torch.unique(a_idx[live]).numel())
    taps = int(torch.unique(tap).numel())
    i = torch.arange(bm, device=shift.device)
    r = stride * i[None, :] + shift[:, None].long()
    rows = ((r >= 0) & (r < bm)).sum(1)                      # (T,)
    events = cnt.clamp(max=e).long().sum(0)                  # (T,)
    flops = 2.0 * bk * n * float((rows * events).sum())
    nbytes = (slots * (bm * bk + 1)) * 4 + taps * blocks * bk * n * 4 \
        + g_out * bm * n * 4 + src.numel() * 8
    return nbytes, flops


def pool_work(a_vals, cnt, out_elems):
    _, e, bm, bk = a_vals.shape
    slots = int(live_slots(a_vals).sum())
    nbytes = slots * (bm * bk + 1) * 4 + out_elems * 4 + cnt.numel() * 8
    return nbytes, float(cnt.clamp(max=e).sum()) * bm * bk


def layer_inputs(cnn, spec, batch: int) -> list:
    """(layer, (B, H, W, C) map it takes) for each layer of ``spec``."""
    h = w = spec.input_size
    c = spec.in_ch
    out = []
    for layer in spec.layers:
        out.append((layer, (batch, h, w, c)))
        if isinstance(layer, cnn.ConvSpec):
            h = (h + 2 * layer.padding - layer.k) // layer.stride + 1
            w = (w + 2 * layer.padding - layer.k) // layer.stride + 1
            c = layer.out_ch
        elif isinstance(layer, cnn.PoolSpec):
            h = (h - layer.k) // layer.stride + 1
            w = (w - layer.k) // layer.stride + 1
        else:
            h, w, c = 1, 1, layer.out
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is missing ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch from {ROOT / 'src'} "
              f"({exc}); run from a checkout of the repository",
              file=sys.stderr)
        return 2
    try:
        return run(torch)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


def run(torch) -> int:
    import torch.nn.functional as F

    from repro_torch import engine
    from repro_torch.core import events as ev
    from repro_torch.kernels import build
    from repro_torch.kernels.event_conv import ops as conv_ops
    from repro_torch.kernels.event_conv.ref import event_conv_ref
    from repro_torch.kernels.event_matmul import ops as mm_ops
    from repro_torch.kernels.event_matmul.ref import event_matmul_ref
    from repro_torch.kernels.event_pool import ops as pool_ops
    from repro_torch.kernels.event_pool.ref import (event_pool_ref,
                                                    event_pool_window_ref)
    from repro_torch.kernels.fire_compact import ops as fire_ops
    from repro_torch.kernels.fire_compact.ref import fire_compact_ref
    from repro_torch.models import cnn

    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"-> {lib.relative_to(ROOT)}", flush=True)

    wrappers = {"fire_compact": fire_ops.fire_compact,
                "event_matmul": mm_ops.event_matmul,
                "event_conv": conv_ops.event_conv,
                "event_pool_window": pool_ops.event_pool_window,
                "event_pool": pool_ops.event_pool}

    # -- 2. the slice: VGG16@224, batch 4 ------------------------------------
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    spec = cnn.VGG16
    params = cnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((4, spec.input_size, spec.input_size,
                                spec.in_ch), generator=gen, device=dev))

    # Every wrapper appends what the chained forward hands its kernel to
    # its ``capture`` list (kernels.note_launch); the checks of phase 3
    # replay those inputs.
    for w in wrappers.values():
        w.launches = 0
        w.capture = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with engine.trace_dispatch() as recs:
            y_chain = cnn.cnn_forward(params, x, spec)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
    finally:
        captured = {name: w.capture for name, w in wrappers.items()}
        for w in wrappers.values():
            w.capture = None
    print(f"[2] {spec.name}@{spec.input_size} batch 4 chained forward "
          f"(first, plans built): "
          f"{first_s:.3f} s; launches per kernel: {launches}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(all(len(captured[n]) == launches[n] for n in wrappers),
          "a wrapper's capture list disagrees with its launch count")
    check(len(recs) == len(spec.layers),
          f"{len(recs)} trace records for {len(spec.layers)} layers")
    geometry = layer_inputs(cnn, spec, batch=4)
    strip_convs = [(layer, shape) for (layer, shape), r in zip(geometry, recs)
                   if r["op"] == "conv2d" and r.get("strip")]
    pools = {route: [(layer, shape) for (layer, shape), r in zip(geometry,
                                                                 recs)
                     if r["op"] == "maxpool2d" and r.get("pool_events")
                     and (r["route"] == "window") == (route == "window")]
             for route in ("window", "event")}
    check(len(strip_convs) == launches["event_conv"]
          and len(pools["window"]) == launches["event_pool_window"]
          and len(pools["event"]) == launches["event_pool"],
          f"trace routes disagree with the launches {launches}")
    fallbacks = [r for r in recs if r.get("fallback_decode")]
    check(not fallbacks, f"fallback_decode on the chain: {fallbacks}")
    summary = cnn.chain_boundary_summary(spec, batch=4, device=dev)
    check(summary["densify"] == 0, f"densify points: {summary['densify']}")
    routes = [(r["op"], r["route"]) for r in recs]
    print(f"[2] trace: {len(recs)} records, routes "
          f"{sorted(set(routes))}, densify {summary['densify']}, "
          f"pool_events {summary['pool_events']}, retile "
          f"{summary['retile']}", flush=True)
    check(y_chain.shape == (4, spec.num_classes)
          and bool(torch.isfinite(y_chain).all()),
          f"logits {tuple(y_chain.shape)} not finite (4, {spec.num_classes})")
    y_rt = cnn.cnn_forward(params, x, spec, chain=False)
    bitwise = bool(torch.equal(y_chain, y_rt))
    y_dense = cnn.cnn_forward(params, x, spec, mnf=False)
    torch.cuda.synchronize()
    d_dense = float((y_chain - y_dense).abs().max())
    scale = float(y_dense.abs().max())
    ratio = d_dense / max(scale, 1e-30)
    print(f"[2] chained == round-trip bitwise: {bitwise}; max|chained - "
          f"dense| = {d_dense:.3e} (max|dense| {scale:.3e}, "
          f"ratio {ratio:.3e}, limit 1e-4)", flush=True)
    check(bitwise, "chained != round-trip bitwise")
    check(bool(torch.allclose(y_chain, y_dense, atol=5e-3, rtol=5e-3)),
          f"logits off the dense oracle by {d_dense}")
    # The 5e-3 allclose is loose against logits of ~4e-2; summation order
    # alone moves them by ~1e-7 of their scale, so a dropped or misplaced
    # event shows here.
    check(ratio <= 1e-4, f"logits off the dense oracle by {ratio:.3e} of "
          f"max|dense| (limit 1e-4)")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cnn.cnn_forward(params, x, spec)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = statistics.median(times)
    print(f"[2] warm chained forward: median {fwd_ms:.3f} ms of "
          f"{[round(t, 3) for t in times]} (host clock, synchronized)",
          flush=True)
    dense_ms = cuda_ms(torch, lambda: cnn.cnn_forward(params, x, spec,
                                                      mnf=False), 3)
    print(f"[2] dense oracle forward (F.conv2d/torch.matmul, f32): "
          f"{dense_ms:.3f} ms", flush=True)
    del y_rt, y_dense

    # -- 3. kernel checks on the captured inputs ------------------------------
    results = []

    def shapes(args, kw):
        return tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                     for a in args) + tuple(sorted(kw.items()))

    def unique(calls):
        """The first captured call of each distinct shape."""
        seen = {}
        for args, kw in calls:
            seen.setdefault(shapes(args, kw), (args, kw))
        return list(seen.values())

    def heaviest(items, work):
        """(bound, item) of the item with the largest bound."""
        return max(((bound_ms(*work(item)), item) for item in items),
                   key=lambda t: t[0][0])

    def close(y, ref, what):
        d = float((y - ref).abs().max())
        check(d <= 1e-4 * max(float(ref.abs().max()), 1e-30),
              f"{what}: max|d| {d:.3e} over 1e-4 * max|ref|")
        return d

    def dense_nchw(a_vals, a_idx, nkb, shape):
        """The NCHW map an event tensor holds; padding slots hold zeros, so
        every slot decodes."""
        g, e, bm, bk = a_vals.shape
        full = torch.full((g,), e, dtype=torch.int32, device=a_vals.device)
        rows = ev.decode_block_events(ev.BlockEvents(a_vals, a_idx, full, nkb),
                                      blk_m=bm, blk_k=bk, m=g * bm,
                                      k=nkb * bk)
        b_, h, w_, c = shape
        check(rows.shape[0] == b_ * h * w_, f"{rows.shape[0]} event rows "
              f"for a {shape} map")
        return rows[:, :c].reshape(shape).permute(0, 3, 1, 2).contiguous()

    def report(name, err, ms, plain_ms, lib_ms, b, extra=""):
        src, replaces = KERNELS[name]
        results.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            library_ms=lib_ms))
        print(f"[3] {name}: max_abs_err {err:.3e}, {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, library {lib_ms:.4f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]}){extra}", flush=True)

    # B1 fire_compact: fired and occupancy exact, every launch
    for (acc,), kw in captured["fire_compact"]:
        f1, o1 = fire_ops.fire_compact(acc, **kw)
        f2, o2 = fire_compact_ref(acc, **kw)
        check(torch.equal(f1, f2) and torch.equal(o1, o2),
              f"fire_compact != plain at {tuple(acc.shape)} {kw}")
    b, ((acc,), kw) = heaviest(
        captured["fire_compact"],
        lambda c: (c[0][0].numel() * 8 + c[0][0].numel()
                   // (c[1]["blk_m"] * c[1]["blk_k"]) * 4,
                   float(c[0][0].numel())))
    report("fire_compact", 0.0,
           cuda_ms(torch, lambda: fire_ops.fire_compact(acc, **kw), 20),
           cuda_ms(torch, lambda: fire_compact_ref(acc, **kw), 3),
           cuda_ms(torch, lambda: torch.relu(acc), 20), b,
           f" at acc {tuple(acc.shape)}, "
           f"{len(captured['fire_compact'])} launches checked exact")

    # B2 event_matmul: against its plain version and against torch.matmul
    # on the decoded map, each within 1e-4 * max|ref|
    def decoded(a_vals, a_idx, counts, w):
        g, e, bm, bk = a_vals.shape
        return ev.decode_block_events(
            ev.BlockEvents(a_vals, a_idx, counts, w.shape[0] // bk),
            blk_m=bm, blk_k=bk, m=g * bm, k=w.shape[0])

    worst = 0.0
    mm_calls = unique(captured["event_matmul"])
    for args, _ in mm_calls:
        what = f"event_matmul at {tuple(args[0].shape)}x{tuple(args[3].shape)}"
        y = mm_ops.event_matmul(*args)
        worst = max(worst, close(y, event_matmul_ref(*args), what))
        close(y.reshape(-1, y.shape[-1]), decoded(*args) @ args[3],
              what + " vs torch.matmul")
    b, (args, _) = heaviest(mm_calls, lambda c: matmul_work(torch, *c[0]))
    dense_a = decoded(*args)
    report("event_matmul", worst,
           cuda_ms(torch, lambda: mm_ops.event_matmul(*args), 10),
           cuda_ms(torch, lambda: event_matmul_ref(*args), 1),
           cuda_ms(torch, lambda: torch.matmul(dense_a, args[3]), 10), b,
           f" at a_vals {tuple(args[0].shape)} x W {tuple(args[3].shape)}, "
           f"{len(mm_calls)} shapes checked")
    del dense_a

    # B3 event_conv: the slice's strip layers against the plain version and
    # F.conv2d, then stride 4 and stride 2
    def conv_oihw(ws, k, ci):
        return ws.reshape(k, k, ws.shape[0] // (k * k), -1)[:, :, :ci] \
            .permute(3, 2, 0, 1).contiguous()

    worst = 0.0
    convs = list(zip(strip_convs, captured["event_conv"]))
    for (layer, shape), (args, kw) in convs:
        check(kw["row_stride"] == layer.stride, f"{layer} ran at {kw}")
        what = f"event_conv at {shape} k{layer.k}s{layer.stride}"
        y = conv_ops.event_conv(*args, **kw)
        worst = max(worst, close(y, event_conv_ref(*args, **kw), what))
        ref = F.conv2d(dense_nchw(args[0], args[1], kw["nkb"], shape),
                       conv_oihw(args[6], layer.k, shape[3]),
                       stride=layer.stride, padding=layer.padding)
        co = ref.shape[1]
        close(y.reshape(-1, co)[:ref.numel() // co],
              ref.permute(0, 2, 3, 1).reshape(-1, co), what + " vs F.conv2d")
    ff = cnn.ALEXNET_FF                  # conv1 (k11 s4) and conv2 (k3 s2)
    for layer, shape in ((ff.layers[0], (4, ff.input_size, ff.input_size,
                                         ff.in_ch)),
                         (ff.layers[1], (4, 64, 64, ff.layers[0].out_ch))):
        k, s, p, co = layer.k, layer.stride, layer.padding, layer.out_ch
        xin = torch.relu(torch.randn(shape, generator=gen, device=dev))
        xin = xin * (torch.rand(shape, generator=gen, device=dev) > 0.5)
        wk = torch.randn((k, k, shape[3], co), generator=gen, device=dev) \
            * (2.0 / (k * k * shape[3])) ** 0.5
        st = engine.EventStream.encode_nhwc(xin, blk_k=min(8, shape[3]),
                                            blk_m=8, keep_dense=False)
        args, nkb = conv_ops.strip_conv_inputs(st, wk, stride=s, padding=p)
        d = close(conv_ops.event_conv(*args, nkb=nkb, row_stride=s),
                  event_conv_ref(*args, nkb=nkb, row_stride=s),
                  f"event_conv at {shape} k{k}s{s}")
        ms = cuda_ms(torch, lambda: conv_ops.event_conv(
            *args, nkb=nkb, row_stride=s), 5)
        print(f"[3] event_conv stride {s} (k{k}, input {shape}): max_abs_err "
              f"{d:.3e}, {ms:.4f} ms", flush=True)
    b, ((layer, shape), (args, kw)) = heaviest(
        convs, lambda c: conv_work(torch, c[1][0], c[0][0].stride))
    x_nchw = dense_nchw(args[0], args[1], kw["nkb"], shape)
    w_oihw = conv_oihw(args[6], layer.k, shape[3])
    report("event_conv", worst,
           cuda_ms(torch, lambda: conv_ops.event_conv(*args, **kw), 10),
           cuda_ms(torch, lambda: event_conv_ref(*args, **kw), 1),
           cuda_ms(torch, lambda: F.conv2d(x_nchw, w_oihw,
                                           stride=layer.stride,
                                           padding=layer.padding), 10), b,
           f" at {shape} -> {layer.out_ch} ch, {len(convs)} layers checked")
    del x_nchw

    # B4 pools: exact against the plain version and F.max_pool2d
    for name, route, kern, ref in (
            ("event_pool_window", "window", pool_ops.event_pool_window,
             event_pool_window_ref),
            ("event_pool", "event", pool_ops.event_pool, event_pool_ref)):
        items = []
        for (layer, shape), (args, kw) in zip(pools[route], captured[name]):
            y = kern(*args, **kw)
            items.append(((layer, shape), (args, kw), y.numel()))
            check(torch.equal(y, ref(*args, **kw)),
                  f"{name} != plain at {shape}")
            pooled = F.max_pool2d(dense_nchw(args[0], args[1], kw["nkb"],
                                             shape), layer.k, layer.stride)
            c = shape[3]
            check(torch.equal(y.reshape(-1, y.shape[-2] * y.shape[-1])[:, :c],
                              pooled.permute(0, 2, 3, 1).reshape(-1, c)),
                  f"{name} != F.max_pool2d at {shape}")
        b, ((layer, shape), (args, kw), _) = heaviest(
            items, lambda c: pool_work(c[1][0][0], c[1][0][4], c[2]))
        x_nchw = dense_nchw(args[0], args[1], kw["nkb"], shape)
        report(name, 0.0,
               cuda_ms(torch, lambda: kern(*args, **kw), 20),
               cuda_ms(torch, lambda: ref(*args, **kw), 2),
               cuda_ms(torch, lambda: F.max_pool2d(x_nchw, layer.k,
                                                   layer.stride), 20), b,
               f" at {shape}, {len(items)} layers checked exact")
        del x_nchw

    print(f"[done] {time.perf_counter() - t_start:.1f} s in all; warm "
          f"forward {fwd_ms:.3f} ms", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Replay every strip conv launch (B3, B6) of chip_smoke.py's phases 2 and
4, and its stride-4 and stride-2 strip convs of phase 3, through this
tree's kernel and another tree's, and require the outputs bitwise equal.

    python3 tools/torch_conv_parity.py --src build/parent/src

Runs, with this checkout's ``repro_torch`` and the inputs chip_smoke.py
makes (seed 0): the VGG16@224 batch-4 chained forward in f32 (B3 x 7) and
with int8 event values (B3 x 1, B6 x 6), with the wrappers' capture lists
on; then ALEXNET_FF@256's conv1 (k11 s4) and a k3 s2 layer in f32 and on
int8 codes (chip_smoke.strided_conv_inputs, from a generator seeded 1).
``--src``'s ``repro_torch/csrc/event_conv.cu`` (a parent tree unpacked by
``git archive`` under the git-ignored ``build/``) is built on its own into
``build/parity/<hash>/`` with the same nvcc flags and called through its C
entries on every launch.  Prints the launches compared per run and one
JSON line; exits 1 on the first launch whose outputs differ.  Needs a card
and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENTRIES = ("mnf_event_conv", "mnf_event_conv_int8")


def build_other(csrc: pathlib.Path, build) -> ctypes.CDLL:
    """The other tree's strip conv alone, as a shared library."""
    src = csrc / "event_conv.cu"
    key = hashlib.sha256(src.read_bytes()
                         + (csrc / "mnf_common.cuh").read_bytes())
    out = ROOT / "build" / "parity" / key.hexdigest()[:16]
    lib = out / "libmnf_event_conv.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build._FLAGS, "-shared", "-I",
                        str(csrc), str(src), "-o", str(lib)], check=True,
                       stdout=subprocess.DEVNULL)
    dll = ctypes.CDLL(str(lib))
    for name in ENTRIES:
        fn = getattr(dll, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the other tree's src directory")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_conv_parity: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import strided_conv_inputs
    from repro_torch.core.fire import FireConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.event_conv import ops as conv_ops
    from repro_torch.models import cnn

    other = build_other(pathlib.Path(args.src).resolve() / "repro_torch"
                        / "csrc", build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = cnn.init_cnn_params(cnn.VGG16, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((4, 224, 224, 3), generator=gen, device=dev))
    q8 = FireConfig(quantize_to_int8=True)
    wrappers = {"mnf_event_conv": conv_ops.event_conv,
                "mnf_event_conv_int8": conv_ops.event_conv_dequant}
    runs = {}
    for tag, fwd in (
            ("[2] VGG16 f32", lambda: cnn.cnn_forward(params, x, cnn.VGG16)),
            ("[4] VGG16 int8", lambda: cnn.cnn_forward(params, x, cnn.VGG16,
                                                      fire_cfg=q8))):
        for w in wrappers.values():
            w.capture = []
        fwd()
        runs[tag] = {n: w.capture for n, w in wrappers.items()}
        for w in wrappers.values():
            w.capture = None
    sgen = torch.Generator(device=dev).manual_seed(1)
    runs["[3] strides 4 and 2"] = {
        name: [(a, kw) for _, _, a, kw in strided_conv_inputs(
            torch, sgen, name.endswith("int8"))] for name in ENTRIES}
    torch.cuda.synchronize()

    stream = torch.cuda.current_stream().cuda_stream
    report = {}
    for tag, caps in runs.items():
        counts = {}
        for name, calls in caps.items():
            for call_args, kw in calls:
                mine = wrappers[name](*call_args, **kw)
                a, src, ws = call_args[0], call_args[4], call_args[-1]
                g, e, bm, bk = a.shape
                theirs = torch.empty_like(mine)
                ins = [t.contiguous() for t in call_args]
                rc = getattr(other, name)(
                    *(t.data_ptr() for t in ins), theirs.data_ptr(),
                    src.shape[0], e, bm, bk, ws.shape[1], src.shape[1],
                    kw["nkb"], kw["row_stride"], stream)
                if rc:
                    print(f"{tag}: {name} of {args.src} returned CUDA "
                          f"error {rc}", file=sys.stderr)
                    return 1
                if not torch.equal(mine, theirs):
                    d = float((mine - theirs).abs().max())
                    print(f"{tag}: {name} at a_vals {tuple(a.shape)} x ws "
                          f"{tuple(ws.shape)} stride {kw['row_stride']}: "
                          f"outputs differ (max|d| {d:.3e})", file=sys.stderr)
                    return 1
            counts[name] = len(calls)
        report[tag] = counts
        print(f"{tag}: every strip conv launch bitwise equal to "
              f"{args.src}'s kernel: {counts}", flush=True)
    total = sum(sum(c.values()) for c in report.values())
    print(f"{total} launches compared, all bitwise equal", flush=True)
    print(json.dumps({"src": args.src, "bitwise": True, "compared": total,
                      "launches": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Replay every event matmul launch (B2, B5) of chip_smoke.py's phases 2, 4
and 5 through this tree's kernel and another tree's, and require the
outputs bitwise equal.

    python3 tools/torch_matmul_parity.py --src build/parent/src

Runs, with this checkout's ``repro_torch`` and the inputs chip_smoke.py
makes (seed 0): the VGG16@224 batch-4 chained forward in f32 and with int8
event values, and LeNet-300-100 at batch 128 in f32 and int8, each with the
wrappers' capture lists on.  ``--src``'s ``repro_torch/csrc/event_matmul.cu``
(a parent tree unpacked by ``git archive`` under the git-ignored
``build/``) is built on its own into ``build/parity/<hash>/`` with the same
nvcc flags and called through its C entries on every captured launch.
Prints the launches compared per forward and one JSON line; exits 1 on the
first launch whose outputs differ.  Needs a card and nvcc.
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


def build_other(csrc: pathlib.Path, build) -> ctypes.CDLL:
    """The other tree's event matmul alone, as a shared library."""
    src = csrc / "event_matmul.cu"
    key = hashlib.sha256(src.read_bytes()
                         + (csrc / "mnf_common.cuh").read_bytes())
    out = ROOT / "build" / "parity" / key.hexdigest()[:16]
    lib = out / "libmnf_event_matmul.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build._FLAGS, "-shared", "-I",
                        str(csrc), str(src), "-o", str(lib)], check=True,
                       stdout=subprocess.DEVNULL)
    dll = ctypes.CDLL(str(lib))
    for name in ("mnf_event_matmul", "mnf_event_matmul_int8"):
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
        print("torch_matmul_parity: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.fire import FireConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.event_matmul import ops as mm_ops
    from repro_torch.models import cnn, mlp

    other = build_other(pathlib.Path(args.src).resolve() / "repro_torch"
                        / "csrc", build)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = cnn.init_cnn_params(cnn.VGG16, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((4, 224, 224, 3), generator=gen, device=dev))
    lenet = mlp.LENET_300_100
    mparams = mlp.init_mlp_params(lenet, gen, weight_sparsity=0.5)
    xm = torch.randn((128, lenet.in_features), generator=gen,
                     device=dev).abs()
    xm = xm * (torch.rand(xm.shape, generator=gen, device=dev) > 0.8)
    q8 = FireConfig(quantize_to_int8=True)
    forwards = {
        "[2] VGG16 f32": lambda: cnn.cnn_forward(params, x, cnn.VGG16),
        "[4] VGG16 int8": lambda: cnn.cnn_forward(params, x, cnn.VGG16,
                                                 fire_cfg=q8),
        "[5] LeNet f32": lambda: mlp.mlp_forward(mparams, xm, lenet),
        "[5] LeNet int8": lambda: mlp.mlp_forward(mparams, xm, lenet,
                                                 fire_cfg=q8),
    }
    wrappers = {"mnf_event_matmul": mm_ops.event_matmul,
                "mnf_event_matmul_int8": mm_ops.event_matmul_dequant}
    stream = torch.cuda.current_stream().cuda_stream
    report = {}
    for tag, fwd in forwards.items():
        for w in wrappers.values():
            w.capture = []
        fwd()
        torch.cuda.synchronize()
        caps = {n: w.capture for n, w in wrappers.items()}
        for w in wrappers.values():
            w.capture = None
        counts = {}
        for name, calls in caps.items():
            for call_args, _ in calls:
                mine = wrappers[name](*call_args)
                a = call_args[0]
                g, e, bm, bk = a.shape
                w = call_args[-1]
                theirs = torch.empty_like(mine)
                ins = [t.contiguous() for t in call_args]
                rc = getattr(other, name)(*(t.data_ptr() for t in ins),
                                          theirs.data_ptr(), g, e,
                                          bm, bk, w.shape[1], stream)
                if rc:
                    print(f"{tag}: {name} of {args.src} returned CUDA "
                          f"error {rc}", file=sys.stderr)
                    return 1
                if not torch.equal(mine, theirs):
                    d = float((mine - theirs).abs().max())
                    print(f"{tag}: {name} at a_vals {tuple(a.shape)} x W "
                          f"{tuple(w.shape)}: outputs differ (max|d| "
                          f"{d:.3e})", file=sys.stderr)
                    return 1
            counts[name] = len(calls)
        report[tag] = counts
        print(f"{tag}: every event matmul launch bitwise equal to "
              f"{args.src}'s kernel: {counts}", flush=True)
    print(json.dumps({"src": args.src, "bitwise": True,
                      "launches": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

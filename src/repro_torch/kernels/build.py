"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

One shared library holds every kernel.  It is built at first use with
``nvcc`` for ``sm_90a`` — each source compiled by its own ``nvcc`` process,
all started together, then linked — into ``build/repro_torch/<hash>/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags, and
loaded with ``ctypes``: each C entry takes ``void*`` pointers, int64 sizes
and the CUDA stream, and returns its ``cudaGetLastError()``.  The build
prints ptxas's report (registers, shared memory, spills per kernel).

Nothing here runs at import: a machine without ``nvcc`` imports the
package, and only a launch on a CUDA tensor reaches :func:`library`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["BUILD_DIR", "CSRC", "SOURCES", "build", "launch", "library",
           "require_cuda"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("fire_compact.cu", "event_matmul.cu", "event_conv.cu",
           "event_pool.cu", "wkv6_step.cu", "mamba_step.cu", "wkv6.cu",
           "mamba_scan.cu")
_HEADERS = ("mnf_common.cuh",)
BUILD_DIR = CSRC.parents[2] / "build" / "repro_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
#: argtypes of each C entry (pointers, sizes, then the stream).
_SIGNATURES = {
    "mnf_fire_compact": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _P],
    "mnf_event_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mnf_event_matmul_int8": [_P] * 7 + [_I] * 5 + [_P],
    "mnf_event_conv": [_P] * 8 + [_I] * 8 + [_P],
    "mnf_event_conv_int8": [_P] * 10 + [_I] * 8 + [_P],
    "mnf_event_pool": [_P] * 6 + [_I] * 6 + [_P],
    "mnf_event_pool_window": [_P] * 6 + [_I] * 6 + [_P],
    "mnf_wkv6_step": [_P] * 10 + [_I] * 5 + [_P],
    "mnf_mamba_step": [_P] * 9 + [_I] * 6 + [_P],
    "mnf_wkv6": [_P] * 8 + [_I] * 17 + [_P],
    "mnf_mamba_scan": [_P] * 6 + [_I] * 4 + [_P],
    "mnf_mamba_scan_fused": [_P] * 8 + [_I] * 13 + [_P],
    "mnf_mamba_scan_fused_bwd": [_P] * 15 + [_I] * 13 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def build() -> pathlib.Path:
    """Build the shared library unless a build of these sources exists."""
    flags = list(_FLAGS)
    h = hashlib.sha256(" ".join(flags).encode())
    for name in _HEADERS + SOURCES:
        h.update(name.encode() + (CSRC / name).read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib = out_dir / "libmnf_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [pathlib.Path(tmp) / (name + ".o") for name in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *flags, "-I", str(CSRC), "-c", str(CSRC / name),
             "-o", str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for name, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        for name, p, log in zip(SOURCES, procs, logs):
            if log.strip():
                print(f"[nvcc {name}]\n{log.rstrip()}", flush=True)
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {name} (rc "
                                   f"{p.returncode})")
        tmp_lib = pathlib.Path(tmp) / lib.name
        subprocess.run([nvcc, *flags, "-shared", *map(str, objs), "-o",
                        str(tmp_lib)], check=True)
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def require_cuda(**tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} lies on {t.device}; the CUDA kernel "
                             f"takes CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream; raise on a CUDA error.

    Tensor arguments pass as their data pointers, ints as int64, floats as
    float; the stream is appended."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(), name)(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")

"""Launcher of the hand-written CUDA selective scan (B10,
``csrc/mamba_scan.cu``).

Replaces ``repro.kernels.mamba_scan.kernel.mamba_scan_pallas``.  Takes
CUDA tensors only; ``ops.py`` holds the counting wrappers.
:func:`mamba_scan_cuda` scans the streams da and dbx as the TPU kernel
does; :func:`mamba_scan_fused_cuda` runs the same walk on the streams'
sources (dt, x, A, B, C), forming da and dbx in registers;
:func:`mamba_scan_fused_bwd_cuda` gives the fused entry's gradients.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["BWD_CHANNELS4", "BWD_N", "BWD_SEG", "BWD_THREADS1", "MAX_N", "bwd_plan", "mamba_scan_cuda",
           "mamba_scan_fused_bwd_cuda", "mamba_scan_fused_bwd_scratch",
           "mamba_scan_fused_cuda"]

#: Largest state width: a CTA holds at least one channel's N threads.
MAX_N = 1024
#: State widths the backward takes: a channel's lanes in one warp.
BWD_N = (1, 2, 4, 8, 16, 32)
#: The backward's constants, as the source names them (``kBwdSeg``,
#: ``kBwdChannels4``, ``kBwdThreads1``): steps a segment (S), channels a
#: CTA at N = 16, threads a CTA at any other N.
BWD_SEG = 8
BWD_CHANNELS4 = 64
BWD_THREADS1 = 256


def bwd_plan(t: int, di: int, n: int) -> dict:
    """The backward's CTA shape at (T, DI, N), as the source's
    ``bwd_plan`` computes it: ``v`` state elements a thread (4 at N = 16,
    else 1), ``threads`` and ``cpc`` channels a CTA, ``nseg`` segments of
    :data:`BWD_SEG` steps, ``ncol`` CTA columns over DI, ``smem`` its
    shared bytes."""
    v = 4 if n == 16 else 1
    threads = BWD_CHANNELS4 * 4 if v == 4 else BWD_THREADS1
    cpc = threads // (n // v)
    smem = 4 * BWD_SEG * ((threads // 32) * 2 * n + 2 * cpc * n
                          + 2 * (3 * cpc + 2 * n))
    return dict(v=v, threads=threads, cpc=cpc, nseg=-(-t // BWD_SEG),
                ncol=-(-di // cpc), smem=smem)


def mamba_scan_fused_bwd_scratch(b: int, t: int, di: int, n: int) -> int:
    """f32 elements of the backward's scratch: the checkpoints (B,
    ceil(T / S), DI, N), the dA partials (B, DI, N) and the dB / dC
    partials (2, ncol, B, T, N), ncol = ceil(DI / channels a CTA).  No
    term is B T DI N: the states stay in the kernel's registers."""
    p = bwd_plan(t, di, n)
    return (b * p["nseg"] * di * n + b * di * n
            + 2 * p["ncol"] * b * t * n)


def mamba_scan_cuda(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                    h0: torch.Tensor | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, DI), h (B, DI, N)) of the scan.  da, dbx (B, T, DI, N)
    f32, c (B, T, N) f32, h0 (B, DI, N) f32 or None (zeros)."""
    tensors = dict(da=da, dbx=dbx, c=c) | ({} if h0 is None else
                                           dict(h0=h0))
    build.require_cuda(**tensors)
    if any(t.dtype != torch.float32 for t in tensors.values()):
        raise TypeError("mamba_scan takes f32 decay, increment, C and state")
    b, t, di, n = da.shape
    if dbx.shape != da.shape or c.shape != (b, t, n) \
            or (h0 is not None and h0.shape != (b, di, n)):
        raise ValueError(f"shapes da {tuple(da.shape)}, dbx "
                         f"{tuple(dbx.shape)}, c {tuple(c.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if b == 0 or t == 0 or di == 0 or n == 0:
        raise ValueError("zero-extent mamba scan: a launch with gridDim 0 "
                         "is an invalid configuration")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535 rows of the launch grid")
    if n > MAX_N:
        raise ValueError(f"state width {n} > {MAX_N} threads of a CTA")
    y = torch.empty((b, t, di), dtype=torch.float32, device=da.device)
    h = torch.empty((b, di, n), dtype=torch.float32, device=da.device)
    build.launch("mnf_mamba_scan", da, dbx, c, h0, y, h, b, t, di, n)
    return y, h


def _sources(dt, x, a, bmat, cmat, h0) -> tuple:
    """Check the fused entry's inputs; returns (b, t, di, n, row strides
    of dt, x, B and C, bf16 flag)."""
    rows = dict(dt=dt, x=x, bmat=bmat, cmat=cmat)
    for name, t in rows.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} lies on {t.device}; the CUDA kernel "
                             f"takes CUDA tensors only")
        if t.dim() != 3 or (t.shape[-1] > 1 and t.stride(-1) != 1):
            raise ValueError(f"{name} {tuple(t.shape)} (strides "
                             f"{t.stride()}) is not (B, T, width) with a "
                             f"unit stride in its last dimension")
    build.require_cuda(a=a, **({} if h0 is None else dict(h0=h0)))
    dtype = dt.dtype
    if dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != dtype for t in rows.values()):
        raise TypeError("mamba_scan_fused takes dt, x, B and C all f32 or "
                        "all bf16")
    if a.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise TypeError("mamba_scan_fused takes f32 A and state")
    b, t, di = dt.shape
    n = a.shape[-1]
    if x.shape != dt.shape or a.shape != (di, n) \
            or any(m.shape != (b, t, n) for m in (bmat, cmat)) \
            or (h0 is not None and h0.shape != (b, di, n)):
        raise ValueError(f"shapes dt {tuple(dt.shape)}, x {tuple(x.shape)}, "
                         f"A {tuple(a.shape)}, B {tuple(bmat.shape)}, C "
                         f"{tuple(cmat.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if b == 0 or t == 0 or di == 0 or n == 0:
        raise ValueError("zero-extent mamba scan: a launch with gridDim 0 "
                         "is an invalid configuration")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535 rows of the launch grid")
    if n > MAX_N:
        raise ValueError(f"state width {n} > {MAX_N} threads of a CTA")
    strides = [s for m in rows.values() for s in m.stride()[:2]]
    return b, t, di, n, strides, int(dtype == torch.bfloat16)


def mamba_scan_fused_cuda(dt: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                          bmat: torch.Tensor, cmat: torch.Tensor,
                          h0: torch.Tensor | None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, DI), h (B, DI, N)) of the scan of da = exp(dt A), dbx =
    (dt x) B.  dt, x (B, T, DI) and bmat, cmat (B, T, N), all f32 or all
    bf16, each with unit stride in its last dimension (a slice along T or
    of a wider last dimension is taken as it lies); a (DI, N) f32; h0 (B,
    DI, N) f32 or None (zeros)."""
    b, t, di, n, strides, bf16 = _sources(dt, x, a, bmat, cmat, h0)
    y = torch.empty((b, t, di), dtype=torch.float32, device=dt.device)
    h = torch.empty((b, di, n), dtype=torch.float32, device=dt.device)
    build.launch("mnf_mamba_scan_fused", dt, x, a, bmat, cmat, h0, y, h, b,
                 t, di, n, *strides, bf16)
    return y, h


def mamba_scan_fused_bwd_cuda(dt: torch.Tensor, x: torch.Tensor,
                              a: torch.Tensor, bmat: torch.Tensor,
                              cmat: torch.Tensor, h0: torch.Tensor | None,
                              gy: torch.Tensor, gh: torch.Tensor | None
                              ) -> tuple:
    """The gradients of :func:`mamba_scan_fused_cuda` given gy (B, T, DI)
    f32 (contiguous) and gh (B, DI, N) f32 or None (zeros): (d dt, d x
    (B, T, DI), d A (DI, N), d B, d C (B, T, N), d h0 (B, DI, N) or None
    where h0 is None), all f32.  The inputs as the forward takes them; N
    one of :data:`BWD_N`.  Allocates its outputs and one f32 scratch
    buffer of :func:`mamba_scan_fused_bwd_scratch` elements (checkpoints
    every :data:`BWD_SEG` steps and the partial sums; 66.4 MB at
    Hymba-1.5B's training launch, (8, 512, 1600) x 16); two kernel
    launches, no host sync."""
    b, t, di, n, strides, bf16 = _sources(dt, x, a, bmat, cmat, h0)
    if n not in BWD_N:
        raise ValueError(f"the B10 backward takes a state width in {BWD_N} "
                         f"(a channel's lanes in one warp), not {n}")
    build.require_cuda(gy=gy, **({} if gh is None else dict(gh=gh)))
    if gy.dtype != torch.float32 or gy.shape != (b, t, di) \
            or (gh is not None and (gh.dtype != torch.float32
                                    or gh.shape != (b, di, n))):
        raise ValueError(f"gy {gy.dtype} {tuple(gy.shape)}, gh "
                         f"{None if gh is None else (gh.dtype, tuple(gh.shape))}"
                         f" for the scan of ({b}, {t}, {di}) x {n}")
    f32, dev = torch.float32, dt.device
    g_dt = torch.empty((b, t, di), dtype=f32, device=dev)
    g_x = torch.empty((b, t, di), dtype=f32, device=dev)
    g_a = torch.empty((di, n), dtype=f32, device=dev)
    g_b = torch.empty((b, t, n), dtype=f32, device=dev)
    g_c = torch.empty((b, t, n), dtype=f32, device=dev)
    g_h0 = None if h0 is None else torch.empty((b, di, n), dtype=f32,
                                               device=dev)
    scratch = torch.empty(mamba_scan_fused_bwd_scratch(b, t, di, n),
                          dtype=f32, device=dev)
    build.launch("mnf_mamba_scan_fused_bwd", dt, x, a, bmat, cmat, h0, gy,
                 gh, g_dt, g_x, g_a, g_b, g_c, g_h0, scratch, b, t, di, n,
                 *strides, bf16)
    return g_dt, g_x, g_a, g_b, g_c, g_h0

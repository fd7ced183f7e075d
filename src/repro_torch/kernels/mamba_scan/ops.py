"""The selective scan of the Mamba prefill (B10).

``csrc/mamba_scan.cu`` replaces
``repro.kernels.mamba_scan.kernel.mamba_scan_pallas`` and its padding
wrapper ``repro.kernels.mamba_scan.ops.mamba_scan`` with two entries of
one walk, each with its counting wrapper: ``mamba_scan`` takes the
streams da and dbx, as the TPU kernel does (bound on the card: bytes, the
streams read once); ``mamba_scan_fused``, which the Mamba prefill calls,
takes their sources dt, x, A, B and C and forms the streams in registers
(bound: the walk's instructions).  A CUDA tensor launches the kernel and
counts it (``kernels.note_launch``); a CPU tensor takes the plain version
(``ref.py``).  The JAX wrapper's ``d_blk`` and ``chunk`` tile the TPU's
grid and have no counterpart: the kernel masks the ragged channels and
loops to T.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import note_launch
from repro_torch.kernels.mamba_scan.kernel import (mamba_scan_cuda,
                                                   mamba_scan_fused_cuda)
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                mamba_scan_ref)

__all__ = ["mamba_scan", "mamba_scan_fused"]


def mamba_scan(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """da, dbx (B, T, DI, N); c (B, T, N); h0 (B, DI, N) or None (zeros);
    any float, cast to f32.  Returns (y (B, T, DI) f32, h (B, DI, N) f32):
    h bitwise the plain version's, y within f32 summation order."""
    if da.device.type == "cpu":
        return mamba_scan_ref(da, dbx, c, h0)
    f32 = lambda t: None if t is None else t.float().contiguous()
    out = mamba_scan_cuda(f32(da), f32(dbx), f32(c), f32(h0))
    note_launch(mamba_scan, (da, dbx, c, h0), {})
    return out


def mamba_scan_fused(dt: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                     bmat: torch.Tensor, cmat: torch.Tensor,
                     h0: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan of da = exp(dt A), dbx = (dt x) B.  dt, x (B, T, DI); a
    (DI, N); bmat, cmat (B, T, N); h0 (B, DI, N) or None (zeros).  dt, x,
    B and C go to the kernel as they lie where they are f32 or bf16 (a
    slice along T too), cast to f32 otherwise.  Returns (y (B, T, DI) f32,
    h (B, DI, N) f32): h bitwise the plain version's, y within f32
    summation order."""
    if dt.device.type == "cpu":
        return mamba_scan_fused_ref(dt, x, a, bmat, cmat, h0)
    rows = (dt, x, bmat, cmat)
    if dt.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != dt.dtype for t in rows):
        rows = tuple(t.float() for t in rows)
    f32 = lambda t: None if t is None else t.float().contiguous()
    y, h = mamba_scan_fused_cuda(rows[0], rows[1], f32(a), rows[2], rows[3],
                                 f32(h0))
    note_launch(mamba_scan_fused, (dt, x, a, bmat, cmat, h0), {})
    return y, h


mamba_scan.launches = 0
mamba_scan.capture = None
mamba_scan_fused.launches = 0
mamba_scan_fused.capture = None

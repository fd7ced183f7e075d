"""The selective scan of the Mamba prefill (B10).

``mamba_scan`` is the wrapper of ``csrc/mamba_scan.cu``, which replaces
``repro.kernels.mamba_scan.kernel.mamba_scan_pallas`` and its padding
wrapper ``repro.kernels.mamba_scan.ops.mamba_scan``: a CUDA tensor
launches the kernel and counts it (``kernels.note_launch``); a CPU tensor
takes the plain version (``ref.py``).  The JAX wrapper's ``d_blk`` and
``chunk`` tile the TPU's grid and have no counterpart: the kernel masks
the ragged channels and loops to T.  Bound on the card: bytes (da and
dbx read once).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import note_launch
from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

__all__ = ["mamba_scan"]


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


mamba_scan.launches = 0
mamba_scan.capture = None

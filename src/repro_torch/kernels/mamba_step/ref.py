"""Plain PyTorch version of the fire-gated Mamba decode step (B8).

Port of ``repro.kernels.mamba_scan.step`` (``mamba_step_ref``,
``mamba_step_events_ref``).  Per batch row, one token::

    h' = h * dA + g B^T          (decay + rank-1 increment, g = dt * x)
    y  = sum_N h' * C            (state readout)

The increment is driven by the gate g alone, so the gated step takes the
fired gate as events and runs the dense step's arithmetic on the drive
they carry (zeros where nothing fired).  The dense decode
(``models.ssm.mamba_step``) calls :func:`mamba_step_ref` too, so at
threshold 0 the gated step equals the dense one bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels.wkv6_step.ref import drive_from_events

__all__ = ["mamba_step_events_ref", "mamba_step_ref"]


def mamba_step_ref(gdrive, da, bmat, cmat, h):
    """Dense single-token step.  gdrive (B, DI), the dt * x increment gate;
    da (B, DI, N) decay; bmat, cmat (B, N); h (B, DI, N); all math f32.
    Returns (y (B, DI), h_new (B, DI, N))."""
    gdrive, bmat, cmat = (x.float() for x in (gdrive, bmat, cmat))
    da, h = da.float(), h.float()
    dbx = gdrive[..., None] * bmat[:, None, :]
    h_new = h * da + dbx
    y = (h_new * cmat[:, None, :]).sum(-1)
    return y, h_new


def mamba_step_events_ref(bev: ev.BlockEvents, da: torch.Tensor,
                          bmat: torch.Tensor, cmat: torch.Tensor,
                          h: torch.Tensor, *, blk_k: int):
    """The gated step on its events: the dense step on the event-carried
    gate.  Same arguments as the kernel's wrapper."""
    g = drive_from_events(bev, blk_k=blk_k, m=da.shape[0], k=da.shape[1])
    return mamba_step_ref(g, da, bmat, cmat, h)

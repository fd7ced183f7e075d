"""Plain PyTorch version of the Mamba selective scan (B10).

Port of ``repro.kernels.mamba_scan.ref.mamba_scan_ref``: the exact
sequential recurrence over streams the caller precomputes
(da = exp(dt A), dbx = (dt x) B)::

    h_t = da_t * h_{t-1} + dbx_t          (h: (B, DI, N))
    y_t = sum_N h_t * c_t

:func:`mamba_scan_fused_ref` is the plain version of the fused entry: it
builds the two streams from their sources (:func:`mamba_scan_streams`,
the Mamba prefill's own operations in its own order) and runs the same
loop.  The Mamba prefill (``models.ssm.mamba_apply``) runs it once per
scan chunk; on the CPU this is the prefill's scan itself.
"""
from __future__ import annotations

import torch

__all__ = ["mamba_scan_fused_ref", "mamba_scan_ref", "mamba_scan_streams"]


def mamba_scan_ref(da, dbx, c, h0=None):
    """da, dbx (B, T, DI, N); c (B, T, N); h0 (B, DI, N) or None (zeros);
    all math f32.  Returns (y (B, T, DI), h_final (B, DI, N))."""
    da, dbx, c = da.float(), dbx.float(), c.float()
    b, t, di, n = da.shape
    h = torch.zeros((b, di, n), dtype=torch.float32, device=da.device) \
        if h0 is None else h0.float()
    ys = []
    for i in range(t):
        h = da[:, i] * h + dbx[:, i]
        ys.append((h * c[:, i, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


def mamba_scan_streams(dt, x, a, bmat, cmat):
    """(da, dbx, c) f32 of a scan chunk: da = exp(dt A) (B, T, DI, N), dbx
    = (dt x) B (B, T, DI, N), c = C.  dt, x (B, T, DI); a (DI, N); bmat,
    cmat (B, T, N)."""
    dt = dt.float()
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * x.float())[..., None] * bmat.float()[..., None, :]
    return da, dbx, cmat.float()


def mamba_scan_fused_ref(dt, x, a, bmat, cmat, h0=None):
    """The scan of :func:`mamba_scan_streams`'s streams.  Returns (y (B, T,
    DI), h_final (B, DI, N)), all f32."""
    return mamba_scan_ref(*mamba_scan_streams(dt, x, a, bmat, cmat), h0)

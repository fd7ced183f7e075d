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

:func:`mamba_scan_fused_bwd_ref` is the plain backward of the fused entry:
the explicit reverse scan, the specification the backward kernel
(``csrc/mamba_scan.cu``, ``mnf_mamba_scan_fused_bwd``) is held to.  With
lambda_t the gradient of the loss in h_t (y_t's and every later step's)::

    lambda_{T-1} = gh + gy_{T-1} c_{T-1}
    lambda_t     = gy_t c_t + da_{t+1} lambda_{t+1}
    d(dbx_t) = lambda_t,   d(da_t) = lambda_t h_{t-1},   dh0 = da_0 lambda_0

and from those the gradients of dt, x, A, B and C through da = exp(dt A)
and dbx = (dt x) B, in the forward's own order.
"""
from __future__ import annotations

import torch

__all__ = ["mamba_scan_fused_bwd_ref", "mamba_scan_fused_ref",
           "mamba_scan_ref", "mamba_scan_streams"]


def _math(t) -> torch.dtype:
    """The plain versions' math type: f32, or f64 for f64 inputs (so that
    ``torch.autograd.gradcheck`` can hold the backward in f64)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def mamba_scan_ref(da, dbx, c, h0=None):
    """da, dbx (B, T, DI, N); c (B, T, N); h0 (B, DI, N) or None (zeros);
    all math f32 (f64 for f64 da).  Returns (y (B, T, DI), h_final (B, DI,
    N))."""
    w = _math(da)
    da, dbx, c = da.to(w), dbx.to(w), c.to(w)
    b, t, di, n = da.shape
    h = torch.zeros((b, di, n), dtype=w, device=da.device) \
        if h0 is None else h0.to(w)
    ys = []
    for i in range(t):
        h = da[:, i] * h + dbx[:, i]
        ys.append((h * c[:, i, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


def mamba_scan_streams(dt, x, a, bmat, cmat):
    """(da, dbx, c) f32 of a scan chunk: da = exp(dt A) (B, T, DI, N), dbx
    = (dt x) B (B, T, DI, N), c = C.  dt, x (B, T, DI); a (DI, N); bmat,
    cmat (B, T, N); f64 for f64 dt."""
    w = _math(dt)
    dt = dt.to(w)
    da = torch.exp(dt[..., None] * a.to(w))
    dbx = (dt * x.to(w))[..., None] * bmat.to(w)[..., None, :]
    return da, dbx, cmat.to(w)


def mamba_scan_fused_ref(dt, x, a, bmat, cmat, h0=None):
    """The scan of :func:`mamba_scan_streams`'s streams.  Returns (y (B, T,
    DI), h_final (B, DI, N)), all f32."""
    return mamba_scan_ref(*mamba_scan_streams(dt, x, a, bmat, cmat), h0)


def mamba_scan_fused_bwd_ref(dt, x, a, bmat, cmat, h0, gy, gh):
    """The gradients of :func:`mamba_scan_fused_ref` in each of its inputs,
    given gy (B, T, DI) (the loss's gradient in y) and gh (B, DI, N) (in
    the final state), either None for zeros: (d dt, d x, d A, d B, d C,
    d h0), each in its input's dtype (d h0 None where h0 is None).  The
    states are recomputed from h0; all math f32 (f64 for f64 dt)."""
    w = _math(dt)
    dt_, x_, b_, c_ = (t.to(w) for t in (dt, x, bmat, cmat))
    bsz, t, di = dt.shape
    n = a.shape[-1]
    da, dbx, _ = mamba_scan_streams(dt, x, a, bmat, cmat)
    zeros = lambda *s: torch.zeros(s, dtype=w, device=dt.device)
    h = zeros(bsz, di, n) if h0 is None else h0.to(w)
    prev = []                                  # prev[i] = h_{i-1}
    for i in range(t):
        prev.append(h)
        h = da[:, i] * h + dbx[:, i]
    gy_ = zeros(bsz, t, di) if gy is None else gy.to(w)
    lam = zeros(bsz, di, n) if gh is None else gh.to(w)
    g_da, g_dbx = torch.empty_like(da), torch.empty_like(dbx)
    g_c = zeros(bsz, t, n)
    for i in reversed(range(t)):
        lam = lam + gy_[:, i, :, None] * c_[:, i, None, :]     # lambda_i
        g_c[:, i] = (gy_[:, i, :, None] * h).sum(1)            # h = h_i
        g_dbx[:, i] = lam
        g_da[:, i] = lam * prev[i]
        h = prev[i]
        lam = lam * da[:, i]                   # carried to step i - 1
    g_s = g_da * da                            # da = exp(s), s = dt A
    g_u = (g_dbx * b_[:, :, None, :]).sum(-1)  # dbx = u B, u = dt x
    g_dt = (g_s * a.to(w)).sum(-1) + g_u * x_
    g_x = g_u * dt_
    g_a = (g_s * dt_[..., None]).sum((0, 1))
    g_b = (g_dbx * (dt_ * x_)[..., None]).sum(2)
    return (g_dt.to(dt.dtype), g_x.to(x.dtype), g_a.to(a.dtype),
            g_b.to(bmat.dtype), g_c.to(cmat.dtype),
            None if h0 is None else lam.to(h0.dtype))

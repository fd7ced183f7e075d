"""Plain PyTorch version of the WKV6 recurrence (B9, B9').

Port of ``repro.kernels.wkv6.ref.wkv6_ref``.  Per row (batch, head) with
head dim D, the exact sequential recurrence::

    o_t = (sum_d r_t u k_t) v_t + r_t^T S      (bonus + state readout)
    S  <- diag(w_t) S + k_t v_t^T              (decay + rank-1 increment)

with no clamp on the decay w (the model's chunked prefill,
``models.ssm.wkv6_chunked``, clamps it; the kernels do not).
"""
from __future__ import annotations

import torch

__all__ = ["wkv6_multihead_ref", "wkv6_ref", "wkv6_rows_ref"]


def wkv6_rows_ref(r, k, v, w, u, s0=None):
    """Rows flattened: r, k, v, w (G, T, D); u (G, D), each row's bonus;
    s0 (G, D, D) or None (zeros); all math f32.  Returns (o (G, T, D),
    s_final (G, D, D))."""
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    g, t, d = r.shape
    s = torch.zeros((g, d, d), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    outs = []
    for i in range(t):
        rt, kt, vt, wt = r[:, i], k[:, i], v[:, i], w[:, i]
        att = (rt * u * kt).sum(-1)
        outs.append(att[:, None] * vt + (rt[:, :, None] * s).sum(1))
        s = wt[..., None] * s + kt[..., None] * vt[:, None, :]
    return torch.stack(outs, dim=1), s


def wkv6_ref(r, k, v, w, u, s0=None):
    """Single head (B9).  r, k, v, w (B, T, D); u (D,); s0 (B, D, D) or
    None.  Returns (o (B, T, D) f32, s_final (B, D, D) f32)."""
    return wkv6_rows_ref(r, k, v, w, u.expand(r.shape[0], -1), s0)


def wkv6_multihead_ref(r, k, v, w, u, s0=None):
    """Multi-head (B9').  r, k, v, w (B, H, T, D); u (H, D); s0 (B, H, D,
    D) or None.  Returns (o (B, H, T, D) f32, s_final (B, H, D, D) f32)."""
    b, h, t, d = r.shape
    fl = lambda x: x.reshape(b * h, t, d)
    o, s = wkv6_rows_ref(fl(r), fl(k), fl(v), fl(w),
                         u.expand(b, h, d).reshape(b * h, d),
                         None if s0 is None else s0.reshape(b * h, d, d))
    return o.reshape(b, h, t, d), s.reshape(b, h, d, d)

"""Launcher of the hand-written CUDA WKV6 recurrence (B9, B9';
``csrc/wkv6.cu``).

Replaces ``repro.kernels.wkv6.kernel.wkv6_pallas`` and the multi-head
``pallas_call`` of ``repro.kernels.wkv6.ops.wkv6``: one C entry, rows
flattened, row g taking the bonus row ``u[g % heads]``.  Takes CUDA
tensors only; ``ops.py`` holds the counting wrappers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["MAX_D", "wkv6_cuda"]

#: Widest head: each thread keeps D * D / 256 state elements in registers.
MAX_D = 64


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None, *,
              heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(o (G, T, D), s (G, D, D)) of the recurrence.  r, k, v, w (G, T, D)
    f32; u (heads, D) f32; s0 (G, D, D) f32 or None (zeros)."""
    tensors = dict(r=r, k=k, v=v, w=w, u=u) | ({} if s0 is None else
                                               dict(s0=s0))
    build.require_cuda(**tensors)
    if any(t.dtype != torch.float32 for t in tensors.values()):
        raise TypeError("wkv6 takes f32 r, k, v, w, u and state")
    g, t, d = r.shape
    if any(x.shape != r.shape for x in (k, v, w)) \
            or u.shape != (heads, d) \
            or (s0 is not None and s0.shape != (g, d, d)):
        raise ValueError(f"shapes rows {tuple(r.shape)}, u "
                         f"{tuple(u.shape)} for {heads} heads, s0 "
                         f"{None if s0 is None else tuple(s0.shape)}")
    if g == 0 or t == 0 or d == 0:
        raise ValueError("zero-extent wkv6: a launch with gridDim 0 is an "
                         "invalid configuration")
    if heads < 1 or g % heads:
        raise ValueError(f"{g} rows are not a whole number of {heads} heads")
    if d > MAX_D:
        raise ValueError(f"head_dim {d} > {MAX_D}: the state does not fit "
                         f"the kernel's registers")
    o = torch.empty((g, t, d), dtype=torch.float32, device=r.device)
    s = torch.empty((g, d, d), dtype=torch.float32, device=r.device)
    build.launch("mnf_wkv6", r, k, v, w, u, s0, o, s, g, t, d, heads)
    return o, s

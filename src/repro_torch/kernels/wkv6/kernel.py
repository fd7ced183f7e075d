"""Launcher of the hand-written CUDA WKV6 recurrence (B9, B9';
``csrc/wkv6.cu``).

Replaces ``repro.kernels.wkv6.kernel.wkv6_pallas`` and the multi-head
``pallas_call`` of ``repro.kernels.wkv6.ops.wkv6``: one C entry, row
(b, h) taking the bonus row ``u[h]``.  r, k, v and w go in as they lie:
each f32 or bf16, with a unit stride along D and any strides along the
rest (the RWKV6 prefill's (B, H, T, D) views of its (B, T, H, D)
projections take no copy).  Takes CUDA tensors only; ``ops.py`` holds the
counting wrappers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["MAX_D", "wkv6_cuda"]

#: Widest head: each thread keeps its rows of S in registers.
MAX_D = 64

_ROW_DTYPES = (torch.float32, torch.bfloat16)


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, s) of the recurrence, f32.  Multi-head: r, k, v, w (B, H, T, D),
    u (H, D), s0 (B, H, D, D) or None (zeros) -> o (B, H, T, D), s (B, H,
    D, D).  One head: r, k, v, w (B, T, D), u (D,), s0 (B, D, D) or None
    -> o (B, T, D), s (B, D, D).  r, k, v, w each f32 or bf16 with a unit
    stride along D; u and s0 f32, contiguous."""
    rows = dict(r=r, k=k, v=v, w=w)
    for name, x in rows.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} lies on {x.device}; the CUDA kernel "
                             f"takes CUDA tensors only")
    build.require_cuda(u=u, **({} if s0 is None else dict(s0=s0)))
    if any(x.dtype not in _ROW_DTYPES for x in rows.values()):
        raise TypeError("wkv6 takes r, k, v and w each f32 or bf16")
    if u.dtype != torch.float32 or (s0 is not None
                                    and s0.dtype != torch.float32):
        raise TypeError("wkv6 takes f32 u and state")
    single = r.dim() == 3
    if single:
        rows = {n: x.unsqueeze(1) for n, x in rows.items()}
    rv = rows["r"]
    if rv.dim() != 4:
        raise ValueError(f"r {tuple(r.shape)} is not (B, T, D) or (B, H, "
                         f"T, D)")
    b, h, t, d = rv.shape
    u_shape = (d,) if single else (h, d)
    s_shape = (b, d, d) if single else (b, h, d, d)
    if any(x.shape != rv.shape for x in rows.values()) \
            or u.shape != u_shape \
            or (s0 is not None and s0.shape != s_shape):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, s0 "
                         f"{None if s0 is None else tuple(s0.shape)}")
    for name, x in rows.items():
        if d > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name} {tuple(x.shape)} (strides "
                             f"{x.stride()}) has no unit stride along D")
    if b == 0 or h == 0 or t == 0 or d == 0:
        raise ValueError("zero-extent wkv6: a launch with gridDim 0 is an "
                         "invalid configuration")
    if d > MAX_D:
        raise ValueError(f"head_dim {d} > {MAX_D}: the state does not fit "
                         f"the kernel's registers")
    o = torch.empty((b, h, t, d), dtype=torch.float32, device=r.device)
    s = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    # a dimension of extent 1 is never stepped: its stride reads as 0
    strides = [st if n > 1 else 0 for x in rows.values()
               for st, n in zip(x.stride()[:3], x.shape[:3])]
    bf16 = sum(1 << i for i, x in enumerate(rows.values())
               if x.dtype == torch.bfloat16)
    build.launch("mnf_wkv6", *rows.values(), u, s0, o, s, b, h, t, d,
                 *strides, bf16)
    return (o[:, 0], s[:, 0]) if single else (o, s)

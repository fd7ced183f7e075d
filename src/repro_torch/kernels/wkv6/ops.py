"""The WKV6 recurrence as ops (B9 single-head, B9' multi-head).

``wkv6_single`` (B9, ``repro.kernels.wkv6.kernel.wkv6_pallas``) and
``wkv6`` (B9', ``repro.kernels.wkv6.ops.wkv6``) wrap one kernel,
``csrc/wkv6.cu``; each counts its own launches (``kernels.note_launch``).
A CPU tensor takes the plain version (``ref.py``); any other device
launches the kernel, which raises off the card.  r, k, v and w go to the
kernel as they lie where they are f32 or bf16, strided views included
(the kernel casts at load, as the TPU kernel does); any other float type
is cast to f32 first.  T needs no padding (the JAX wrapper pads with w = 1
to whole chunks; the kernel loops to T).  No model of either package
calls these ops: the RWKV6 prefill runs the chunked form
(``models.ssm.wkv6_chunked``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kernel_wrapper, note_launch
from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.kernels.wkv6.ref import wkv6_multihead_ref, wkv6_ref

__all__ = ["wkv6", "wkv6_scan_work", "wkv6_single"]


def wkv6_scan_work(r, k, v, w, u, s0=None) -> tuple[int, float]:
    """Bytes and operations one B9/B9' launch needs: r, k, v, w and u read
    once in their own types (G x T x D each), o written once (f32), s0
    (when given) read and S written once (f32, G x D x D); per row and
    token 5 D^2 (the readout's multiply-add, the decay's multiply, the
    increment's multiply and add) and 5 D (the bonus r u k and o = att v +
    readout)."""
    t, d = r.shape[-2:]
    g = r.numel() // (t * d)
    nbytes = sum(x.numel() * x.element_size() for x in (r, k, v, w, u)) \
        + g * t * d * 4 + (2 if s0 is not None else 1) * g * d * d * 4
    return nbytes, g * t * (5.0 * d * d + 5.0 * d)


def _kernel_args(r, k, v, w, u, s0):
    """The launcher's arguments: r, k, v, w as they lie where f32 or bf16,
    else f32; u and s0 f32 and contiguous."""
    row = lambda x: x if x.dtype in (torch.float32, torch.bfloat16) \
        else x.float()
    f32 = lambda x: None if x is None else x.float().contiguous()
    return row(r), row(k), row(v), row(w), f32(u), f32(s0)


@kernel_wrapper(lambda out, *a, **kw: wkv6_scan_work(*a, **kw))
def wkv6_single(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                s0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """B9, one head per row.  r, k, v, w (B, T, D); u (D,); s0 (B, D, D)
    or None.  Returns (o (B, T, D) f32, s (B, D, D) f32): S bitwise the
    plain version's, o within f32 summation order."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    out = wkv6_cuda(*_kernel_args(r, k, v, w, u, s0))
    note_launch(wkv6_single, (r, k, v, w, u, s0), {})
    return out


@kernel_wrapper(lambda out, *a, **kw: wkv6_scan_work(*a, **kw))
def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """B9', multi-head.  r, k, v, w (B, H, T, D); u (H, D); s0 (B, H, D,
    D) or None.  Returns (o (B, H, T, D) f32, s (B, H, D, D) f32)."""
    if r.device.type == "cpu":
        return wkv6_multihead_ref(r, k, v, w, u, s0)
    out = wkv6_cuda(*_kernel_args(r, k, v, w, u, s0))
    note_launch(wkv6, (r, k, v, w, u, s0), {})
    return out

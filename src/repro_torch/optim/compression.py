"""Distributed gradient compression — port of ``repro.optim.compression``:
MNF applied to the collective layer.

Two compressed all-reduce primitives for explicit data-parallel
training, each over a process group where the JAX package names an axis:

  * :func:`quantized_psum` — an int-quantized all-reduce with one f32
    scale shared by the group (the max of the ranks' local maxima),
    int8 codes on a wire that carries 4x fewer bytes than f32;
  * :func:`event_psum` — event-driven gradient exchange: only entries
    whose magnitude reaches the top-k threshold *fire* into the
    collective; the rest accumulate in a local error-feedback residual and
    fire later.  The paper's fire phase applied to gradients.

As in the JAX package the fired values travel as the masked dense tensor
(an all-reduce), not as (value, index) events: the semantics are the
same.  The codes are summed as int32, so the sum is exact.
"""
from __future__ import annotations

import torch

__all__ = ["event_psum", "make_compressed_grad_fn", "quantized_psum",
           "topk_threshold"]


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    import torch.distributed as dist
    dist.all_reduce(x, op=op, group=group)
    return x


def quantized_psum(x: torch.Tensor, group=None, *, bits: int = 8):
    """The int-quantized sum of ``x`` over ``group``, in f32: each rank's
    ``round(x / scale)`` (half to even, as ``jnp.round``) clipped to
    ``bits`` bits, the codes summed as int32, times the shared scale
    ``max|x| / (2^(bits-1) - 1)`` (the max over the group)."""
    import torch.distributed as dist
    qmax = 2.0 ** (bits - 1) - 1
    amax = torch.clamp(x.abs().max().float(), min=1e-12)
    amax = _all_reduce(amax, dist.ReduceOp.MAX, group)
    scale = amax / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int32)
    total = _all_reduce(q, dist.ReduceOp.SUM, group)
    return total.float() * scale


def topk_threshold(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """The magnitude that keeps ~``k_frac`` of the entries: the k-th
    largest |x| (k = max(1, floor(numel * k_frac)))."""
    flat = x.reshape(-1).abs()
    k = max(1, int(flat.numel() * k_frac))
    return torch.topk(flat, k).values[-1]


def event_psum(x: torch.Tensor, residual: torch.Tensor, group=None, *,
               k_frac: float = 0.05):
    """Fire-phase gradient exchange with error feedback: (the sum over
    ``group`` of the fired entries of ``x + residual``, the new residual —
    what did not fire).  Fired plus residual is ``x + residual`` exactly,
    so the sum over steps is unbiased."""
    import torch.distributed as dist
    acc = x + residual
    theta = topk_threshold(acc, k_frac)
    fired = torch.where(acc.abs() >= theta, acc, 0.0)     # fire decision
    new_residual = acc - fired                            # error feedback
    total = _all_reduce(fired.clone(), dist.ReduceOp.SUM, group)
    return total, new_residual


def make_compressed_grad_fn(mode: str = "none", *, k_frac: float = 0.05,
                            bits: int = 8):
    """reduce(grad_leaf, residual_leaf, group) -> (summed grad,
    residual)."""
    import torch.distributed as dist
    if mode == "none":
        return lambda g, r, group: (
            _all_reduce(g.clone(), dist.ReduceOp.SUM, group), r)
    if mode == "int8":
        return lambda g, r, group: (quantized_psum(g, group, bits=bits), r)
    if mode == "event":
        return lambda g, r, group: event_psum(g, r, group, k_frac=k_frac)
    raise ValueError(mode)

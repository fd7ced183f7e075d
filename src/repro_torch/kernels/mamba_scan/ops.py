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

The kernel has no backward: on the card, a call that autograd would
differentiate (grad mode on and an input that requires grad) raises
:class:`B10BackwardMissing`, naming ROADMAP.md queue A item 18, instead
of running the plain version.  The plain version on the CPU is
differentiable.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kernel_wrapper, note_launch
from repro_torch.kernels.mamba_scan.kernel import (mamba_scan_cuda,
                                                   mamba_scan_fused_cuda)
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                mamba_scan_ref)

__all__ = ["B10BackwardMissing", "mamba_scan", "mamba_scan_fused",
           "mamba_scan_fused_work", "mamba_scan_work"]


class B10BackwardMissing(NotImplementedError):
    """A differentiable call of B10 on the card: the kernel has no
    backward yet."""


def _no_backward(tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise B10BackwardMissing(
            "B10 (the Mamba selective scan, csrc/mamba_scan.cu) has no "
            "backward kernel: training through it on the card waits for "
            "ROADMAP.md queue A item 18 (a B10 backward); on the CPU the "
            "plain version is differentiable")


def mamba_scan_work(da, dbx, c, h0=None) -> tuple[int, float]:
    """Bytes and operations one B10 launch needs: da and dbx read once
    (B, T, DI, N) f32, c read and y written, h0 (when given) read and h
    written once; per state element and step a multiply and an add (the
    update) and a multiply and an add (the readout)."""
    b, t, di, n = da.shape
    nbytes = 2 * b * t * di * n * 4 + b * t * n * 4 + b * t * di * 4 \
        + (2 if h0 is not None else 1) * b * di * n * 4
    return nbytes, 4.0 * b * t * di * n


def mamba_scan_fused_work(dt, x, a, bmat, cmat,
                          h0=None) -> tuple[int, float]:
    """Bytes and operations one launch of B10's fused entry needs: dt and
    x (B, T, DI) and B and C (B, T, N) read once in their own type, A
    (DI, N) f32, h0 (when given) read and h written once, y (B, T, DI) f32
    written; per channel and step dt x (a multiply), per state element and
    step dt A and its exp, the multiply by B, the update's multiply and
    add and the readout's multiply and add (7)."""
    b, t, di = dt.shape
    n = a.shape[-1]
    size = dt.element_size()
    nbytes = 2 * b * t * di * size + 2 * b * t * n * size + di * n * 4 \
        + b * t * di * 4 + (2 if h0 is not None else 1) * b * di * n * 4
    return nbytes, b * t * di * (7.0 * n + 1.0)


@kernel_wrapper(lambda out, *a, **kw: mamba_scan_work(*a, **kw))
def mamba_scan(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """da, dbx (B, T, DI, N); c (B, T, N); h0 (B, DI, N) or None (zeros);
    any float, cast to f32.  Returns (y (B, T, DI) f32, h (B, DI, N) f32):
    h bitwise the plain version's, y within f32 summation order."""
    if da.device.type == "cpu":
        return mamba_scan_ref(da, dbx, c, h0)
    _no_backward((da, dbx, c, h0))
    f32 = lambda t: None if t is None else t.float().contiguous()
    out = mamba_scan_cuda(f32(da), f32(dbx), f32(c), f32(h0))
    note_launch(mamba_scan, (da, dbx, c, h0), {})
    return out


@kernel_wrapper(lambda out, *a, **kw: mamba_scan_fused_work(*a, **kw))
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
    _no_backward((dt, x, a, bmat, cmat, h0))
    rows = (dt, x, bmat, cmat)
    if dt.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != dt.dtype for t in rows):
        rows = tuple(t.float() for t in rows)
    f32 = lambda t: None if t is None else t.float().contiguous()
    y, h = mamba_scan_fused_cuda(rows[0], rows[1], f32(a), rows[2], rows[3],
                                 f32(h0))
    note_launch(mamba_scan_fused, (dt, x, a, bmat, cmat, h0), {})
    return y, h

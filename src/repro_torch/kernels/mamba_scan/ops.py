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
(``ref.py``); a meta tensor gives empty outputs (``kernels.on_meta``).
The JAX wrapper's ``d_blk`` and ``chunk`` tile the TPU's grid and have no
counterpart: the kernel masks the ragged channels and loops to T.

The fused entry is differentiable: under autograd it runs as
:class:`_FusedScan`, whose backward is the wrapper
:func:`mamba_scan_fused_bwd` — on the card the backward kernel
(``mnf_mamba_scan_fused_bwd``: the walk and the ordered sums of its
partials, counted once a call under its own name), on the CPU the plain
reverse scan ``mamba_scan_fused_bwd_ref``.  It saves the inputs and h0,
not the states (the kernel recomputes them from checkpoints).
The streams entry is on no model's path and has no backward: on the card
a call that autograd would differentiate raises
:class:`B10BackwardMissing`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kernel_wrapper, note_launch, on_meta
from repro_torch.kernels.mamba_scan.kernel import (mamba_scan_cuda,
                                                   mamba_scan_fused_bwd_cuda,
                                                   mamba_scan_fused_cuda)
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_bwd_ref,
                                                mamba_scan_fused_ref,
                                                mamba_scan_ref)

__all__ = ["B10BackwardMissing", "mamba_scan", "mamba_scan_fused",
           "mamba_scan_fused_bwd", "mamba_scan_fused_bwd_work",
           "mamba_scan_fused_work", "mamba_scan_work"]


class B10BackwardMissing(NotImplementedError):
    """A differentiable call of B10's streams entry on the card: that
    entry has no backward."""


def _no_backward(tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise B10BackwardMissing(
            "B10's streams entry (mamba_scan: da and dbx in, "
            "csrc/mamba_scan.cu) has no backward kernel; the fused entry "
            "mamba_scan_fused, which the Mamba prefill calls, has one")


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


def mamba_scan_fused_bwd_work(dt, x, a, bmat, cmat, h0=None, gy=None,
                              gh=None) -> tuple[int, float]:
    """Bytes and operations one launch of B10's backward needs: dt and x
    (B, T, DI) and B and C (B, T, N) read once in their own type, A (DI,
    N) f32, gy (B, T, DI) f32, h0 and gh (when given) read once; the
    gradients of dt, x, B and C written in their inputs' type, of A f32
    and of h0 (when given) f32.  Per state element and step: the state
    recomputed (dt A, its exp, the multiply by B, the update's multiply
    and add: 5; the readout is not needed), then gy c and its add (2),
    lambda h and the product with da (2), dA's multiply and add (2), the
    terms of d(dt) and du (2) and their sums over N (2), lambda's carry
    by da (1), dB's and dC's multiply-adds (4): 20; per channel and step
    dt x, du x and its add, du dt (4)."""
    b, t, di = dt.shape
    n = a.shape[-1]
    size = dt.element_size()
    given = (h0 is not None) + (gh is not None)
    nbytes = 2 * (2 * b * t * di * size + 2 * b * t * n * size) \
        + 2 * di * n * 4 + b * t * di * 4 + given * b * di * n * 4 \
        + (h0 is not None) * b * di * n * 4
    return nbytes, b * t * di * (20.0 * n + 4.0)


def _fused_forward(dt, x, a, bmat, cmat, h0):
    """The fused entry on CUDA tensors (one counted launch), the plain
    version on CPU tensors, empty outputs on meta tensors."""
    if on_meta(dt):
        b, t, di = dt.shape
        return (torch.empty((b, t, di), dtype=torch.float32, device="meta"),
                torch.empty((b, di, a.shape[-1]), dtype=torch.float32,
                            device="meta"))
    if dt.device.type == "cpu":
        return mamba_scan_fused_ref(dt, x, a, bmat, cmat, h0)
    rows = _kernel_rows(dt, x, bmat, cmat)
    f32 = lambda t: None if t is None else t.float().contiguous()
    y, h = mamba_scan_fused_cuda(rows[0], rows[1], f32(a), rows[2], rows[3],
                                 f32(h0))
    note_launch(mamba_scan_fused, (dt, x, a, bmat, cmat, h0), {})
    return y, h


def _kernel_rows(dt, x, bmat, cmat) -> tuple:
    """dt, x, B and C as they lie where they are all f32 or all bf16, cast
    to f32 otherwise."""
    rows = (dt, x, bmat, cmat)
    if dt.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != dt.dtype for t in rows):
        rows = tuple(t.float() for t in rows)
    return rows


class _FusedScan(torch.autograd.Function):
    """The fused entry under autograd (module docstring)."""

    @staticmethod
    def forward(ctx, dt, x, a, bmat, cmat, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, x, a, bmat, cmat, h0)
        return _fused_forward(dt, x, a, bmat, cmat, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        grads = mamba_scan_fused_bwd(*ctx.saved_tensors, gy, gh)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


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
    summation order.  Differentiable in every input (module docstring)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (dt, x, a, bmat, cmat, h0)):
        return _FusedScan.apply(dt, x, a, bmat, cmat, h0)
    return _fused_forward(dt, x, a, bmat, cmat, h0)


@kernel_wrapper(lambda out, *a, **kw: mamba_scan_fused_bwd_work(*a, **kw))
def mamba_scan_fused_bwd(dt: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                         bmat: torch.Tensor, cmat: torch.Tensor,
                         h0: torch.Tensor | None, gy: torch.Tensor | None,
                         gh: torch.Tensor | None) -> tuple:
    """The gradients of :func:`mamba_scan_fused` given gy (B, T, DI) and gh
    (B, DI, N), either None for zeros: (d dt, d x, d A, d B, d C, d h0),
    each in its input's dtype (d h0 None where h0 is None).  On CUDA
    tensors one call of the backward kernel's C entry (N a power of two
    up to 32; two launches), within f32 summation order of the plain
    version."""
    if on_meta(dt):
        return tuple(None if t is None else torch.empty(
            t.shape, dtype=t.dtype, device="meta")
            for t in (dt, x, a, bmat, cmat, h0))
    if dt.device.type == "cpu":
        return mamba_scan_fused_bwd_ref(dt, x, a, bmat, cmat, h0, gy, gh)
    rows = _kernel_rows(dt, x, bmat, cmat)
    f32 = lambda t: None if t is None else t.float().contiguous()
    gy_ = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device) \
        if gy is None else f32(gy)
    grads = mamba_scan_fused_bwd_cuda(rows[0], rows[1], f32(a), rows[2],
                                      rows[3], f32(h0), gy_, f32(gh))
    note_launch(mamba_scan_fused_bwd, (dt, x, a, bmat, cmat, h0, gy, gh), {})
    return tuple(None if g is None else g.to(t.dtype)
                 for g, t in zip(grads, (dt, x, a, bmat, cmat, h0)))

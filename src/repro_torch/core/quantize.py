"""Int8 affine quantization (Jacob et al., CVPR'18) — paper §5.2.3 step 2,
port of ``repro.core.quantize``.

The MNF MAC cluster accumulates in 32 bits and requantizes the sum to 8
bits at every fire.  On the event path (``EngineConfig(int8_events=True)``)
the fire emits int8 event values with a symmetric :class:`QParams` on the
stream, and the consumers dequantize at tile load (DESIGN.md §12).

Every function repeats the JAX package's f32 arithmetic step for step —
division stays division (``round(x / scale)``, never ``x * (1 / scale)``)
and rounding is half to even — so both packages give the same codes and
scales on the same array.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["QParams", "calibrate", "dequantize", "dequantize_accumulator",
           "fake_quant", "quantize", "requantize_accumulator"]


@dataclasses.dataclass(frozen=True)
class QParams:
    """Affine quantization parameters: real = scale * (q - zero_point).
    Both are 0-d tensors on the data's device (f32 and int32), so a kernel
    reads them from device memory and the host never syncs on them."""

    scale: torch.Tensor
    zero_point: torch.Tensor

    @staticmethod
    def symmetric(scale) -> "QParams":
        scale = torch.as_tensor(scale, dtype=torch.float32)
        return QParams(scale=scale,
                       zero_point=torch.zeros((), dtype=torch.int32,
                                              device=scale.device))


def calibrate(x: torch.Tensor, *, symmetric: bool = True,
              bits: int = 8) -> QParams:
    """Min/max calibration of quantization parameters for tensor ``x``."""
    qmax = 2 ** (bits - 1) - 1
    if symmetric:
        amax = torch.clamp(x.abs().max(), min=1e-8)
        return QParams.symmetric(amax / qmax)
    lo = torch.clamp(x.min(), max=0.0)
    hi = torch.clamp(x.max(), min=1e-8)
    scale = (hi - lo) / (2 ** bits - 1)
    zp = torch.round(-lo / scale).to(torch.int32) - 2 ** (bits - 1)
    return QParams(scale=scale.to(torch.float32), zero_point=zp)


def quantize(x: torch.Tensor, qp: QParams, *, bits: int = 8) -> torch.Tensor:
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    q = torch.round(x / qp.scale) + qp.zero_point
    return torch.clamp(q, qmin, qmax).to(torch.int8 if bits == 8
                                         else torch.int32)


def dequantize(q: torch.Tensor, qp: QParams) -> torch.Tensor:
    """(q - zero_point) * scale in f32 — the exact floats the int8 kernels
    compute at tile load."""
    return (q.to(torch.float32) - qp.zero_point) * qp.scale


def fake_quant(x: torch.Tensor, qp: QParams, *, bits: int = 8) -> torch.Tensor:
    """Quantize-dequantize round trip."""
    return dequantize(quantize(x, qp, bits=bits), qp)


def dequantize_accumulator(acc: torch.Tensor, in_qp: QParams,
                           w_qp: QParams) -> torch.Tensor:
    """Real value of an accumulator of int8×int8 products whose input and
    weight scales are ``in_qp`` / ``w_qp``: acc * in_scale * w_scale."""
    return acc.to(torch.float32) * (in_qp.scale * w_qp.scale)


def requantize_accumulator(acc: torch.Tensor, in_qp: QParams, w_qp: QParams,
                           out_qp: QParams, *, bits: int = 8) -> torch.Tensor:
    """Paper §5.2.3: 32-bit accumulated sum -> 8-bit output activation under
    ``out_qp`` (the engine dequantizes at tile load, so its accumulators
    carry unit input and weight scales)."""
    return quantize(dequantize_accumulator(acc, in_qp, w_qp), out_qp,
                    bits=bits)

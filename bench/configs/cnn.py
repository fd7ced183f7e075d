"""The plain reference of the CNN configurations (``vgg16_224``,
``alexnet_224``), and the useful work of a forward counted from its own
activations.

Plain PyTorch: ``F.conv2d``, ``F.max_pool2d`` and a matmul, in float32
with TF32 off, over the layer list of the configuration's JSON.  Nothing
of the program is imported, and nothing the program made is read: the
weights (HWIO convs, (K, N) FCs, ``None`` for pools) and the NHWC images
are the benchmark's own, handed to both sides.  Each conv and each FC
but the last is followed by a ReLU (the fire at threshold 0); the FC
input is the NHWC map flattened, as the port flattens it.  No biases.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["forward", "count_work", "touched", "PRECISIONS"]

#: "f32": float32 with TF32 off (the configuration's precision);
#: "tf32": the control, the nearest precision below it (TF32 on the
#: card; on the CPU, which has no TF32, each operand of a conv or matmul
#: rounded to TF32's 10-bit mantissa, as the tensor cores read it).
PRECISIONS = ("f32", "tf32")


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round f32 values to the nearest TF32 value (10 mantissa bits),
    ties to even."""
    bits = t.contiguous().view(torch.int32)
    bits = bits + 0x0FFF + ((bits >> 13) & 1)
    return (bits & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _precision(precision: str, device: torch.device):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if device.type != "cuda":
        yield
        return
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def forward(cfg: dict, params: list, x: torch.Tensor, *,
            precision: str = "f32", hook=None) -> torch.Tensor:
    """Logits (B, classes) of NHWC images ``x`` (B, H, W, C) f32.

    ``hook(i, layer, a, w)``, if given, sees each layer's input
    activation before the layer runs: ``a`` NCHW for convs and pools,
    (B, K) for FCs (the NHWC flattening)."""
    emulate = precision == "tf32" and x.device.type != "cuda"
    rnd = _tf32_round if emulate else (lambda t: t)
    layers = cfg["layers"]
    a = x.permute(0, 3, 1, 2).contiguous()
    with _precision(precision, x.device):
        for i, (layer, w) in enumerate(zip(layers, params)):
            kind = layer["kind"]
            if kind == "fc" and a.dim() == 4:
                a = a.permute(0, 2, 3, 1).reshape(a.shape[0], -1)
            if hook is not None:
                hook(i, layer, a, w)
            if kind == "conv":
                a = F.conv2d(rnd(a), rnd(w.permute(3, 2, 0, 1)),
                             stride=layer["stride"],
                             padding=layer["padding"])
                a = torch.relu(a)
            elif kind == "pool":
                a = F.max_pool2d(a, layer["k"], layer["stride"])
            elif kind == "fc":
                a = torch.matmul(rnd(a), rnd(w))
                if i < len(layers) - 1:
                    a = torch.relu(a)
            else:
                raise ValueError(f"layer kind {kind!r}")
    return a


def touched(h: int, w: int, k: int, stride: int, padding: int,
            device=None) -> torch.Tensor:
    """(H, W) f64: the output positions each input pixel contributes to
    (borders counted exactly)."""
    def along(n):
        o = (n + 2 * padding - k) // stride + 1
        i = torch.arange(n, dtype=torch.float64, device=device)
        lo = torch.clamp(torch.ceil((i + padding - k + 1) / stride), min=0)
        hi = torch.clamp(torch.floor((i + padding) / stride), max=o - 1)
        return torch.clamp(hi - lo + 1, min=0)

    return along(h)[:, None] * along(w)[None, :]


def _tap_rows(nz: torch.Tensor, k: int, stride: int, padding: int,
              oh: int, ow: int) -> torch.Tensor:
    """(B, k*k*C) bool: weight row (ky, kx, ci) is needed by an image when
    some non-zero input of channel ci reaches a valid output through tap
    (ky, kx).  ``nz`` (B, C, H, W) bool."""
    b, c, h, w = nz.shape
    dev = nz.device
    rows = []
    for ky in range(k):
        ys = torch.arange(oh, device=dev) * stride + ky - padding
        ys = ys[(ys >= 0) & (ys < h)]
        for kx in range(k):
            xs = torch.arange(ow, device=dev) * stride + kx - padding
            xs = xs[(xs >= 0) & (xs < w)]
            sub = nz.index_select(2, ys).index_select(3, xs)
            rows.append(sub.any(dim=3).any(dim=2))
    return torch.stack(rows, 1).reshape(b, k * k * c)


def count_work(cfg: dict, params: list, x: torch.Tensor) -> list:
    """The useful work of each layer of the forward of ``x``, an image
    at a time, counted from the reference's own activations (f32, TF32
    off); the same whatever implements the layer.  One dict a layer:

    - ``macs`` (B,) f64: a conv's MACs are, at each output position, the
      non-zero inputs of its receptive field times C_out (the sum over
      non-zero inputs of the outputs they reach, times C_out); an FC's
      are its non-zero inputs times its outputs; a pool's are 0;
    - ``nnz`` (B,) f64: non-zero inputs, each read once as a value and
      an address;
    - ``outs``: outputs a image, each written once;
    - ``rows`` (B, R) bool or None: the weight rows (ky, kx, ci) of a
      conv, or the rows of an FC, that the image's events need; a batch
      reads the union once;
    - ``row_len``: the length of a weight row (C_out).
    """
    out: list = []

    def hook(i, layer, a, w):
        kind = layer["kind"]
        nz = a != 0
        b = a.shape[0]
        d = dict(kind=kind, macs=torch.zeros(b, dtype=torch.float64,
                                             device=a.device),
                 nnz=nz.reshape(b, -1).sum(1, dtype=torch.float64),
                 rows=None, row_len=0)
        if kind == "conv":
            _, c, h, wd = a.shape
            k, s, p = layer["k"], layer["stride"], layer["padding"]
            oh = (h + 2 * p - k) // s + 1
            ow = (wd + 2 * p - k) // s + 1
            per_pix = nz.sum(1, dtype=torch.float64)
            d["macs"] = (per_pix * touched(h, wd, k, s, p, a.device)
                         ).sum((1, 2)) * layer["out"]
            d["outs"] = oh * ow * layer["out"]
            d["rows"] = _tap_rows(nz, k, s, p, oh, ow)
            d["row_len"] = layer["out"]
        elif kind == "fc":
            d["macs"] = d["nnz"] * layer["out"]
            d["outs"] = layer["out"]
            d["rows"] = nz
            d["row_len"] = layer["out"]
        else:
            _, c, h, wd = a.shape
            oh = (h - layer["k"]) // layer["stride"] + 1
            ow = (wd - layer["k"]) // layer["stride"] + 1
            d["outs"] = oh * ow * c
        out.append(d)

    forward(cfg, params, x, hook=hook)
    return out

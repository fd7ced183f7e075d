"""The useful work of the traced stretch's batches, and the least time the
card could take for it (the roofline), from the reference's own
activations of the same images (``configs/<reference>.py``'s
``count_work``).  Independent of how the program tiles its events.

For each layer of a batch:

- operations: 2 x the MACs the non-zero inputs need;
- bytes: each non-zero input read once (a 4-byte value and a 4-byte
  address), each weight row (f32) that some event of the batch needs
  read once, each output (f32) written once;
- bound: max(operations / f32 peak, bytes / HBM bandwidth).

A batch's bound is the sum over its layers; the stretch's, the sum over
its batches.
"""
from __future__ import annotations

import torch

from mnfbench import peaks

__all__ = ["batch_work", "stretch_work"]

_VALUE, _ADDR = 4, 4


def batch_work(cfg: dict, params: list, images: torch.Tensor,
               reference) -> dict:
    """Work of one batch of NHWC images (on the device the params are
    on): ``flops``, ``bytes``, ``bound_s``, and ``layers`` (each
    layer's kind, flops, bytes and bound)."""
    layers = []
    for d in reference.count_work(cfg, params, images):
        n = images.shape[0]
        flops = 2.0 * float(d["macs"].sum())
        nbytes = float(d["nnz"].sum()) * (_VALUE + _ADDR) \
            + n * d["outs"] * _VALUE
        if d["rows"] is not None:
            nbytes += float(d["rows"].any(0).sum()) * d["row_len"] * _VALUE
        layers.append(dict(kind=d["kind"], flops=flops, bytes=nbytes,
                           bound_s=max(flops / peaks.F32_FLOPS,
                                       nbytes / peaks.HBM_BYTES)))
    return dict(flops=sum(x["flops"] for x in layers),
                bytes=sum(x["bytes"] for x in layers),
                bound_s=sum(x["bound_s"] for x in layers), layers=layers)


def stretch_work(run, cfg: dict, params: list, pool: torch.Tensor,
                 reference, ticks: tuple, device) -> dict:
    """The summed work of every batch served in ticks ``ticks[0] ..
    ticks[1]``.  Batches of the same images are counted once and
    reused."""
    lo, hi = ticks
    seen: dict = {}
    flops = bound = 0.0
    for b in run.batches:
        if not lo <= b.tick <= hi:
            continue
        key = tuple(r.pool_idx for r in b.reqs)
        if key not in seen:
            x = pool[list(key)].to(device)
            with torch.no_grad():
                seen[key] = batch_work(cfg, params, x, reference)
        w = seen[key]
        flops += w["flops"]
        bound += w["bound_s"]
    return dict(flops=flops, bound_s=bound)

"""Weights and request images made from ``--seed``: the benchmark's own,
handed alike to the program and to the reference.

- Weights: He-normal (std sqrt(2 / fan_in)) with a share
  ``weight_sparsity`` zeroed unstructured, in the layout the port's
  ``models.cnn`` takes (HWIO convs, (K, N) FCs, ``None`` for pools);
  drawn on the device by one ``torch.Generator`` in two calls over one
  flat f32 buffer, each layer a view of it starting on a 256-byte
  boundary.
- Images: relu-like NHWC f32, ``|normal|`` with a share
  ``activation_sparsity`` of the values zeroed (the arithmetic of the
  port's ``data/synthetic.cnn_batch``, drawn on the device for speed),
  then held on the host, where requests come from.
- The order in which requests take pool images: a permutation from the
  seed.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["subseed", "weight_shapes", "make_weights", "make_pool",
           "pool_order"]

_TAGS = {"weights": 1, "images": 2, "order": 3, "arrivals": 4}
_ALIGN = 64          # elements: 256 bytes of f32


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed (any
    integer) and the stream's tag."""
    ss = np.random.SeedSequence([int(seed) % 2**64, _TAGS[tag]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def weight_shapes(cfg: dict) -> list:
    """Each layer's weight shape (None for a pool), with its fan-in."""
    h = w = cfg["input_size"]
    c = cfg["in_ch"]
    out = []
    for layer in cfg["layers"]:
        kind = layer["kind"]
        if kind == "conv":
            k, s, p = layer["k"], layer["stride"], layer["padding"]
            out.append(((k, k, c, layer["out"]), k * k * c))
            h = (h + 2 * p - k) // s + 1
            w = (w + 2 * p - k) // s + 1
            c = layer["out"]
        elif kind == "pool":
            out.append(None)
            h = (h - layer["k"]) // layer["stride"] + 1
            w = (w - layer["k"]) // layer["stride"] + 1
        elif kind == "fc":
            out.append(((h * w * c, layer["out"]), h * w * c))
            h = w = 1
            c = layer["out"]
        else:
            raise ValueError(f"layer kind {kind!r}")
    return out


def make_weights(cfg: dict, seed: int, device) -> list:
    """The configuration's weights from ``seed``, on ``device``."""
    shapes = weight_shapes(cfg)
    offsets, total = [], 0
    for sf in shapes:
        offsets.append(total)
        if sf is not None:
            n = int(np.prod(sf[0]))
            total += -(-n // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    keep = torch.rand(total, generator=gen, device=device)
    flat.masked_fill_(keep < cfg["weight_sparsity"], 0.0)
    del keep
    params = []
    for sf, off in zip(shapes, offsets):
        if sf is None:
            params.append(None)
            continue
        shape, fan_in = sf
        n = int(np.prod(shape))
        wgt = flat[off:off + n].view(shape)
        wgt.mul_((2.0 / fan_in) ** 0.5)
        params.append(wgt)
    return params


def make_pool(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` request images (n, H, W, C) f32 on the host."""
    s = cfg["input_size"]
    shape = (n, s, s, cfg["in_ch"])
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "images"))
    x = torch.randn(shape, generator=gen, device=device).abs_()
    keep = torch.rand(shape, generator=gen, device=device)
    x.masked_fill_(keep < cfg["activation_sparsity"], 0.0)
    del keep
    return x.cpu()


def pool_order(n: int, seed: int) -> np.ndarray:
    """The pool index of request i is ``order[i % n]``."""
    return np.random.default_rng(subseed(seed, "order")).permutation(n)

"""Parameter creation — port of ``repro.models.param_utils``.

Params are plain nested dicts of tensors.  Each leaf draws from its own
``torch.Generator``, seeded from the module's seed and the CRC32 of the
leaf's name (:func:`fold_in`) — the image of the JAX package's
``fold_in(key, crc32(name))``.  The bits differ from ``jax.random``; tests
that compare the two packages carry the JAX weights across instead
(``models.transformer.params_from_numpy``).  The port has no logical-axis
specs: it runs on one device.
"""
from __future__ import annotations

import zlib

import torch

__all__ = ["Init", "fold_in", "stack_layer_params"]

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 finaliser
    of their combination): distinct leaves and layers draw independent
    streams from one run seed."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class Init:
    """Collects the params of one module tree.  ``seed`` is an int; leaves
    are made on ``device`` in ``dtype`` (on the ``meta`` device: shapes
    and dtypes only, nothing drawn or allocated)."""

    def __init__(self, seed: int, dtype: torch.dtype, device):
        self.seed = seed
        self.dtype = dtype
        self.device = torch.device(device)
        self.params: dict = {}

    def _generator(self, name: str) -> torch.Generator | None:
        if self.device.type == "meta":
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(fold_in(self.seed, zlib.crc32(name.encode())))
        return g

    def dense(self, name: str, shape: tuple, *,
              scale: float | None = None) -> None:
        """LeCun-normal weight (fan-in = shape[-2] by default)."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = (1.0 / fan_in) ** 0.5 if scale is None else scale
        w = torch.randn(shape, generator=self._generator(name),
                        dtype=self.dtype, device=self.device)
        self.params[name] = w.mul_(s)

    def zeros(self, name: str, shape: tuple) -> None:
        self.params[name] = torch.zeros(shape, dtype=self.dtype,
                                        device=self.device)

    def ones(self, name: str, shape: tuple) -> None:
        self.params[name] = torch.ones(shape, dtype=self.dtype,
                                       device=self.device)

    def const(self, name: str, shape: tuple,
              value: float | torch.Tensor) -> None:
        """A constant leaf: ``value`` (a float, or a tensor broadcast to
        ``shape``)."""
        if isinstance(value, torch.Tensor):
            self.params[name] = torch.broadcast_to(
                value.to(self.dtype), shape).to(self.device).clone()
        else:
            self.params[name] = torch.full(shape, value, dtype=self.dtype,
                                           device=self.device)

    def done(self) -> dict:
        return self.params


def stack_layer_params(init_layer_fn, seeds: list[int]) -> dict:
    """Stack per-layer params (``init_layer_fn(seed) -> dict``, nested
    dicts of tensors) along a leading L axis, leaf by leaf.  Fills a
    preallocated stack one layer at a time, so the peak is the stack plus
    one layer (a 7B model's f32 weights do not fit twice on one 80 GB
    card)."""
    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        return node.new_empty((len(seeds),) + tuple(node.shape))

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    first = init_layer_fn(seeds[0])
    out = alloc(first)
    for i, seed in enumerate(seeds):
        layer, first = (first if i == 0 else init_layer_fn(seed)), None
        fill(out, layer, i)
    return out

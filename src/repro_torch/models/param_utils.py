"""Parameter creation — port of ``repro.models.param_utils``.

Params are plain nested dicts of tensors.  Each leaf draws from its own
``torch.Generator``, seeded from the module's seed and the CRC32 of the
leaf's name (:func:`fold_in`) — the image of the JAX package's
``fold_in(key, crc32(name))``.  The bits differ from ``jax.random``; tests
that compare the two packages carry the JAX weights across instead
(``models.transformer.params_from_numpy``).

Every leaf also has its logical axes: a tuple of axis names, one per dim,
in a tree of the same keys (the JAX package's ``specs``), which
``repro_torch.parallel.sharding`` resolves to DTensor placements.  An init
function built with ``with_axes=True`` returns ``(params, axes)``;
``models.transformer.param_axes`` prepends ``"layers"`` to the stacked
layers' axes, as ``stack_layer_params`` does in the JAX package.
"""
from __future__ import annotations

import zlib

import torch

__all__ = ["Init", "fold_in", "stack_layer_params", "tree_leaves",
           "tree_map"]

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 finaliser
    of their combination): distinct leaves and layers draw independent
    streams from one run seed."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def tree_map(fn, tree, *rest):
    """``fn`` on the leaves of nested dicts (a tuple is a leaf), and on the
    matching leaves of ``rest``, trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple, in order (anything
    else is left out)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class Init:
    """Collects the params of one module tree and each leaf's logical axes.
    ``seed`` is an int; leaves are made on ``device`` in ``dtype`` (on the
    ``meta`` device: shapes and dtypes only, nothing drawn or allocated).
    :meth:`done` returns the params, or ``(params, axes)`` with
    ``with_axes``."""

    def __init__(self, seed: int, dtype: torch.dtype, device, *,
                 with_axes: bool = False):
        self.seed = seed
        self.dtype = dtype
        self.device = torch.device(device)
        self.with_axes = with_axes
        self.params: dict = {}
        self.axes: dict = {}

    def _put(self, name: str, value: torch.Tensor, axes: tuple) -> None:
        if len(axes) != value.ndim:
            raise ValueError(f"{name}: axes {axes} for shape "
                             f"{tuple(value.shape)}")
        self.params[name] = value
        self.axes[name] = tuple(axes)

    def _generator(self, name: str) -> torch.Generator | None:
        if self.device.type == "meta":
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(fold_in(self.seed, zlib.crc32(name.encode())))
        return g

    def dense(self, name: str, shape: tuple, axes: tuple, *,
              scale: float | None = None) -> None:
        """LeCun-normal weight (fan-in = shape[-2] by default)."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = (1.0 / fan_in) ** 0.5 if scale is None else scale
        w = torch.randn(shape, generator=self._generator(name),
                        dtype=self.dtype, device=self.device)
        self._put(name, w.mul_(s), axes)

    def zeros(self, name: str, shape: tuple, axes: tuple) -> None:
        self._put(name, torch.zeros(shape, dtype=self.dtype,
                                    device=self.device), axes)

    def ones(self, name: str, shape: tuple, axes: tuple) -> None:
        self._put(name, torch.ones(shape, dtype=self.dtype,
                                   device=self.device), axes)

    def const(self, name: str, shape: tuple, axes: tuple,
              value: float | torch.Tensor) -> None:
        """A constant leaf: ``value`` (a float, or a tensor broadcast to
        ``shape``)."""
        if isinstance(value, torch.Tensor):
            t = torch.broadcast_to(value.to(self.dtype),
                                   shape).to(self.device).clone()
        else:
            t = torch.full(shape, value, dtype=self.dtype, device=self.device)
        self._put(name, t, axes)

    def sub(self, name: str, child: tuple) -> None:
        """A child module's ``(params, axes)`` (an init function called
        with ``with_axes=True``) under ``name``."""
        self.params[name], self.axes[name] = child

    def done(self):
        return (self.params, self.axes) if self.with_axes else self.params


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

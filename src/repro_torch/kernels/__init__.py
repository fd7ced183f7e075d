"""Hand-written CUDA kernels for Hopper, one package per kernel:
ref.py (plain PyTorch version), kernel.py (CUDA launcher), ops.py
(counting wrapper).  Sources live in ../csrc; build.py builds and loads them.

Each wrapper carries ``launches``, a plain int it raises by one per kernel
launch (never on the CPU path), and ``capture``: None, or a list to which
each launch appends its ``(args, kwargs)`` so a caller can replay the
inputs a forward handed the kernel.  :func:`count_launches` counts the
launches of every wrapper over a block, as a CUDA graph's capture does
(``launch.graphs``).
"""
from __future__ import annotations

import contextlib

__all__ = ["count_launches", "note_launch"]

_SINKS: list[dict] = []


def note_launch(wrapper, args: tuple, kwargs: dict) -> None:
    """Count one launch of ``wrapper``'s kernel and capture its inputs."""
    wrapper.launches += 1
    if wrapper.capture is not None:
        wrapper.capture.append((args, kwargs))
    for sink in _SINKS:
        sink[wrapper] = sink.get(wrapper, 0) + 1


@contextlib.contextmanager
def count_launches():
    """Context manager yielding a dict {wrapper: launches} of the launches
    made inside it."""
    sink: dict = {}
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        # by identity: a nested sink can hold the same records (list.remove
        # compares by value and would drop the outer one)
        _SINKS[:] = [s for s in _SINKS if s is not sink]

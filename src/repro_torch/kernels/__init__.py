"""Hand-written CUDA kernels for Hopper, one package per kernel:
ref.py (plain PyTorch version), kernel.py (CUDA launcher), ops.py
(counting wrapper).  Sources live in ../csrc; build.py builds and loads them.

Each wrapper carries ``launches``, a plain int it raises by one per kernel
launch (never on the CPU path), and ``capture``: None, or a list to which
each launch appends its ``(args, kwargs)`` so a caller can replay the
inputs a forward handed the kernel.  :func:`count_launches` counts the
launches of every wrapper over a block, as a CUDA graph's capture does
(``launch.graphs``).

Each wrapper also carries ``work``: its kernel's formula for the bytes it
must move and the operations its inputs need (``work(out, *args,
**kwargs) -> (bytes, operations)``, beside each wrapper in its ``ops.py``).
Inside :func:`count_work` every call of a wrapper, on the card or on the
CPU, adds its formula's numbers to the sink, and the call runs with
PyTorch's dispatch modes (``launch.roofline``'s FLOP and byte counters)
switched off: a kernel's work reads the same whatever implements it, and
no counter sees the plain version's aten ops.  A wrapper called by
another (``event_matmul`` handing int8 codes to ``event_matmul_dequant``)
counts once, as the outer call.

The wrappers a dry-run cell reaches (``launch.dryrun``: B7, B8, B10's
fused entry and its backward), handed tensors on the ``meta`` device,
return empty outputs of their kernel's shapes and dtypes: they launch
nothing and count no launch, and inside :func:`count_work` they are
counted by their formulas like any other call (:func:`on_meta`; a
formula that reads the data, as the gated steps' live slots, counts the
most the shapes allow).
"""
from __future__ import annotations

import contextlib
import functools

__all__ = ["count_launches", "count_work", "kernel_wrapper", "note_launch",
           "on_meta"]

_SINKS: list[dict] = []
_WORK_SINKS: list[dict] = []
_DEPTH = [0]


def on_meta(t) -> bool:
    """Whether ``t`` lies on the ``meta`` device: shapes without data,
    where a wrapper returns empty outputs and launches nothing."""
    return t.device.type == "meta"


def note_launch(wrapper, args: tuple, kwargs: dict) -> None:
    """Count one launch of ``wrapper``'s kernel and capture its inputs."""
    wrapper.launches += 1
    if wrapper.capture is not None:
        wrapper.capture.append((args, kwargs))
    for sink in _SINKS:
        sink[wrapper] = sink.get(wrapper, 0) + 1


@contextlib.contextmanager
def _sink(sinks: list, sink: dict):
    sinks.append(sink)
    try:
        yield sink
    finally:
        # by identity: a nested sink can hold the same records (list.remove
        # compares by value and would drop the outer one)
        sinks[:] = [s for s in sinks if s is not sink]


def count_launches():
    """Context manager yielding a dict {wrapper: launches} of the launches
    made inside it."""
    return _sink(_SINKS, {})


def count_work():
    """Context manager yielding a dict {wrapper name: [calls, bytes,
    operations]} of the wrapper calls made inside it, each call's numbers
    its kernel's formula (the wrapper's ``work``)."""
    return _sink(_WORK_SINKS, {})


def kernel_wrapper(work):
    """Decorator of a kernel's counting wrapper: ``launches`` 0,
    ``capture`` None, ``work`` the kernel's formula, and inside
    :func:`count_work` each outermost call counted by it."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _WORK_SINKS or _DEPTH[0]:
                return fn(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes
            _DEPTH[0] += 1
            try:
                with _disable_current_modes():
                    out = fn(*args, **kwargs)
                    nbytes, ops = work(out, *args, **kwargs)
            finally:
                _DEPTH[0] -= 1
            for sink in _WORK_SINKS:
                rec = sink.setdefault(fn.__name__, [0, 0, 0.0])
                rec[0] += 1
                rec[1] += int(nbytes)
                rec[2] += float(ops)
            return out

        wrapper.launches = 0
        wrapper.capture = None
        wrapper.work = work
        return wrapper
    return deco

"""Dispatch tracing — make the engine's fallbacks visible (DESIGN.md §5.1),
port of ``repro.engine.trace`` with the same record schema::

    with engine.trace_dispatch() as records:
        y = engine.linear(stream, w, cfg=cfg)
    assert not any(r.get("fallback_decode") for r in records)

PyTorch runs eagerly, so a record is appended per dispatch as it runs.
"""
from __future__ import annotations

import contextlib

__all__ = ["record", "trace_dispatch"]

_SINKS: list[list] = []


def record(**fields) -> None:
    """Append one record to every active ``trace_dispatch`` context (no-op
    when none is active)."""
    if _SINKS:
        rec = dict(fields)
        for sink in _SINKS:
            sink.append(rec)


@contextlib.contextmanager
def trace_dispatch():
    """Context manager yielding the list of dispatch records."""
    sink: list = []
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        # by identity: a nested sink can hold the same records (list.remove
        # compares by value and would drop the outer one)
        _SINKS[:] = [s for s in _SINKS if s is not sink]

"""Backend registry — ``(op, backend) -> fn`` (DESIGN.md §4), port of
``repro.engine.registry``."""
from __future__ import annotations

from typing import Callable

__all__ = ["register_backend", "get_backend", "dispatch", "list_backends"]

_REGISTRY: dict[tuple[str, str], Callable] = {}


def register_backend(op: str, name: str, fn: Callable | None = None):
    """Register ``fn`` as backend ``name`` of ``op`` (direct or decorator);
    re-registration overwrites."""
    def _put(f: Callable) -> Callable:
        _REGISTRY[(op, name)] = f
        return f

    return _put if fn is None else _put(fn)


def get_backend(op: str, name: str) -> Callable:
    try:
        return _REGISTRY[(op, name)]
    except KeyError:
        avail = list_backends(op)
        raise KeyError(f"no backend {name!r} registered for op {op!r}; "
                       f"available: {avail or '(none)'}") from None


def dispatch(op: str, cfg, *tensors) -> Callable:
    """The implementation of ``op`` for ``cfg`` on the tensors' device."""
    return get_backend(op, cfg.resolve_backend(*tensors))


def list_backends(op: str) -> list[str]:
    return sorted(n for (o, n) in _REGISTRY if o == op)


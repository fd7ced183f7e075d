"""Compiled steps: a function captured once as a CUDA graph and replayed —
what ``jax.jit`` is to the JAX package, which has no module for it::

    g = graphs.capture(fn, params, x_static, pool=pool)
    x_static.copy_(x)
    y = g.replay()          # g.outputs, rewritten by every replay

:func:`capture` runs ``fn(*static)`` once eagerly on a side stream (the
warm-up: it builds and loads the kernels, triggers CUDA's lazy module load
at each kernel's first launch, fills the cached device plans and creates
the cuBLAS handles), then captures one more call with ``torch.cuda.graph``
(which first hands the blocks the warm-up left cached back to the device:
the capture allocates from its own pool, which could not reuse them).
What the capture saw — each kernel wrapper's launches
(``kernels.count_launches``) and the ``engine.trace`` records — is kept on
the graph: they are Python side effects, made at capture and never at
replay.  A replay reads the static inputs in place and rewrites the
outputs, so a caller copies new values into the inputs before and clones
the outputs it keeps after.  A capture that fails raises; there is no
eager fallback.  Graphs that share a ``pool`` (``torch.cuda.
graph_pool_handle()``) must replay in the order they were captured.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch import kernels
from repro_torch.engine import trace
from repro_torch.models.param_utils import tree_leaves

__all__ = ["Graph", "capture", "same_tensors"]


def same_tensors(a, b) -> bool:
    """Whether two trees hold the same tensors: the same storage, shape and
    dtype, leaf by leaf."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.data_ptr() == y.data_ptr() and x.shape == y.shape
        and x.dtype == y.dtype for x, y in zip(la, lb))


@dataclasses.dataclass(eq=False)
class Graph:
    """One captured call: ``static`` the inputs it reads, ``outputs`` what
    it returned (rewritten by each replay), ``launches`` {wrapper:
    launches} and ``records`` (trace records) as the capture saw them,
    ``warmup_s`` the eager warm-up's and ``capture_s`` the capture's host
    seconds, ``pool_bytes`` the device memory the capture left reserved
    (its pool's growth), ``replays`` the replays so far."""

    graph: torch.cuda.CUDAGraph
    static: tuple
    outputs: Any
    launches: dict
    records: list
    warmup_s: float
    capture_s: float
    pool_bytes: int
    replays: int = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        return self.outputs


def capture(fn, *static, pool=None) -> Graph:
    """Warm ``fn(*static)`` up once, then capture one call of it."""
    off = [tuple(t.shape) for t in tree_leaves(static)
           if t.device.type != "cuda"]
    if off:
        raise ValueError(f"a CUDA graph reads CUDA tensors only; inputs of "
                         f"shape {off} lie elsewhere")
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    side.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t1 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with kernels.count_launches() as launches, \
            trace.trace_dispatch() as records, \
            torch.cuda.graph(graph, pool=pool, stream=side):
        outputs = fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.cuda.empty_cache()
    return Graph(graph, static, outputs, dict(launches), records, t1 - t0,
                 t2 - t1, torch.cuda.memory_reserved() - reserved)

"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis — port of
``repro.parallel.pipeline``.

The layer stack splits into ``n_stages`` contiguous stages, one a rank of
the ``pipe`` axis; microbatches stream through the stages, each tick
handing its activation to the next stage with ``dist.batch_isend_irecv``
in the pipe group.  The tick schedule is the JAX package's: at tick t
stage s works on microbatch t - s, stage 0 injects, the last stage
records, and a final all-reduce SUM broadcasts the recorded outputs
(every other stage contributes zeros).
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis: str = "pipe",
                   n_microbatches: int | None = None) -> torch.Tensor:
    """``y = stages(x)`` with each stage on one rank of ``axis``.

    stage_fn(params_slice, microbatch) -> microbatch (same shape).
    stage_params: a dict tree whose leaves have a leading dim of
    ``n_stages``, or DTensors sharded on that dim over ``axis`` (one slice
    a stage).  x: (n_micro, mb, ...) pre-split microbatches, the same
    tensor on every rank; the result is too.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.models.param_utils import tree_map

    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    n_micro = x.shape[0] if n_microbatches is None else n_microbatches
    assert x.shape[0] == n_micro

    def local(a):
        if isinstance(a, DTensor):
            a = a.to_local()
            assert a.shape[0] == 1, "stage params: one slice a stage"
            return a[0]
        return a[stage]

    params_local = tree_map(local, stage_params)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (if any); the others take the
        # neighbour's output of the previous tick (already in buf)
        if stage == 0:
            cur = x[t] if t < n_micro else torch.zeros_like(buf)
        else:
            cur = buf
        live = 0 <= t - stage < n_micro
        y = stage_fn(params_local, cur) if live else torch.zeros_like(buf)
        if live and stage == n_stages - 1:
            outs[t - stage] += y
        # shift activations to the next stage
        if n_stages > 1:
            buf = torch.empty_like(y)
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                     dist.P2POp(dist.irecv, buf, prv, group)]):
                req.wait()
        else:
            buf = y
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs

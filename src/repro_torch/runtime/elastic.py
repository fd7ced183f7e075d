"""Elastic scaling: rebuild the mesh from surviving ranks and reshard —
port of ``repro.runtime.elastic``.

When a host drops (or capacity grows), the controller calls
:func:`elastic_remesh`: it picks the largest usable (data, model)
factorization of the surviving rank count and builds a ``DeviceMesh``
over those ranks; :func:`reshard_tree` re-places the state under the new
mesh's resolved placements.  Because shardings are re-resolved from
logical axes, restore onto any mesh is mechanical.  The data pipeline is
stateless-resumable (batch = f(step, host)), so re-entry needs only the
step counter.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.parallel.sharding import (ShardingRules, distribute_tree,
                                           make_rules)

__all__ = ["choose_mesh_shape", "elastic_remesh", "reshard_tree"]


def choose_mesh_shape(n_devices: int, *, model_parallel: int = 16,
                      max_pod: int = 256) -> tuple:
    """Largest (pod, data, model) grid using <= n_devices devices.

    Keeps model-parallel fixed (weights must still fit) and gives the rest
    to data; drops stragglers that break divisibility.
    """
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    rest = n_devices // mp
    if rest > max_pod // mp and rest % 2 == 0:
        return (2, rest // 2, mp)
    return (rest, mp)


def elastic_remesh(n_devices: int, *, model_parallel: int = 16,
                   ranks: Optional[Sequence[int]] = None,
                   device_type: str | None = None):
    """A ``DeviceMesh`` of :func:`choose_mesh_shape`'s shape over the
    surviving ``ranks`` (by default the world's first ranks), in order.
    Every rank of the world calls it (the mesh's groups are made
    collectively); a rank left out holds no shard of what is placed on
    it.  ``device_type`` as ``launch.mesh.checked_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import _device_type, world_size

    shape = choose_mesh_shape(n_devices, model_parallel=model_parallel)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    ranks = list(range(world_size()) if ranks is None else ranks)
    need = math.prod(shape)
    if len(ranks) < need:
        raise ValueError(f"mesh {shape} needs {need} ranks; {len(ranks)} "
                         f"survive")
    return DeviceMesh(_device_type(device_type),
                      torch.tensor(ranks[:need]).reshape(shape),
                      mesh_dim_names=axes)


def reshard_tree(tree, axes, new_mesh, *, fsdp: bool = False,
                 rules: ShardingRules | None = None):
    """Every leaf of ``tree`` (DTensors on the old mesh, or full tensors)
    re-placed under ``new_mesh``'s resolved placements of its logical
    ``axes``.  A DTensor is gathered whole on its old mesh first, so every
    rank of that mesh calls this."""
    rules = rules or make_rules(new_mesh, fsdp=fsdp)
    return distribute_tree(tree, axes, new_mesh, rules)

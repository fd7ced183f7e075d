"""Meshes — port of ``repro.launch.mesh`` onto ``torch.distributed``.

A mesh is a ``DeviceMesh`` over the ranks of a process group: NCCL over
``cuda`` on the card, gloo over the CPU.  Meshes are built by function
call only, never at import.

All mesh construction funnels through :func:`checked_mesh`:

  * **Capacity-checked.**  A shape that needs more ranks than the world
    has raises :class:`MeshCapacityError`, which says how many ranks
    exist, how many the shape needs, and how to get them (start that many
    processes with ``torchrun --nproc-per-node``, or ask for a smaller
    shape).  ``fallback=True`` warns and degrades to the all-ones mesh
    instead — what a single-device serving replica wants.
  * **Self-starting at one rank.**  With no process group initialised
    and an all-ones shape, it initialises a one-rank group itself
    (rank 0 of 1, on a ``file://`` store in a fresh temp directory), so a
    single process needs no launcher.  A larger shape needs a group that
    the caller (or ``torchrun``) started.

:func:`dry_mesh` builds the production meshes with no ranks at all, for
the dry run (``launch.dryrun``): a fake world (torch's testing backend
``"fake"``: this process is rank 0, every collective returns at once and
moves nothing) of the mesh's size, torn down when the block ends.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
import warnings

import torch

__all__ = ["MeshCapacityError", "checked_mesh", "dry_mesh", "init_world",
           "make_production_mesh", "make_serve_mesh", "make_small_mesh",
           "production_shape", "world_size"]


class MeshCapacityError(RuntimeError):
    """Requested mesh shape needs more ranks than the process group has."""


def _device_type(device_type) -> str:
    if device_type is not None:
        return str(device_type)
    from repro_torch.device import default_device
    return default_device().type


def world_size() -> int:
    """Ranks in the default process group (1 when none is initialised)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def init_world(device_type: str) -> int:
    """Join the process group a launcher describes, once: under
    ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) the default
    group starts from the environment (``env://``; NCCL on the card,
    each rank on GPU ``LOCAL_RANK``, gloo on the CPU).  Returns the world
    size: 1 for a process started alone."""
    import torch.distributed as dist
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method="env://")
    return world_size()


def _init_one_rank(device_type: str) -> None:
    import torch.distributed as dist
    if device_type == "cuda":
        torch.cuda.set_device(0)
    store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{store}", world_size=1,
                            rank=0)


def checked_mesh(shape, axes, *, fallback: bool = False, device_type=None):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the first
    ``prod(shape)`` ranks of the world, capacity-checked (see the module
    docstring).  ``device_type``: "cuda" or "cpu"; by default the card
    (``default_device``, which raises without one).  Every rank of the
    world must call it (the mesh's groups are made collectively)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    dev = _device_type(device_type)
    need, have = math.prod(shape), world_size()
    if need > have:
        msg = (f"mesh shape {shape} over axes {axes} needs {need} ranks but "
               f"only {have} exist. Either request a smaller mesh, or start "
               f"{need} processes (torchrun --nproc-per-node {need} ..., "
               f"one a GPU).")
        if not fallback:
            raise MeshCapacityError(msg)
        warnings.warn(f"{msg} Falling back to a 1x1 mesh.", RuntimeWarning,
                      stacklevel=2)
        shape, need = (1,) * len(shape), 1
    if not dist.is_initialized():
        _init_one_rank(dev)
    return DeviceMesh(dev, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def production_shape(multi_pod: bool = False) -> tuple:
    """(shape, axes) of the production mesh: 16x16 (data, model) for one
    pod, 2x16x16 (pod, data, model) for two."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 (data, model) single pod; 2x16x16 (pod, data, model) for
    two."""
    return checked_mesh(*production_shape(multi_pod),
                        device_type=device_type)


@contextlib.contextmanager
def dry_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` with no ranks behind it:
    a fake world of ``prod(shape)`` ranks (this process rank 0) started
    for the block and destroyed after it, so that nothing later in the
    process sees a world.  The mesh's device type is "cpu" (DTensor's
    sharding propagation asks the device type for a device count, which
    "meta" has not); the DTensors of a dry run hold meta tensors.
    Raises where a process group already exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dry_mesh needs a process with no process group "
                           "(one exists)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield checked_mesh(shape, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


def make_small_mesh(shape=(2, 4), axes=("data", "model"), *,
                    device_type=None):
    """Test-scale mesh (needs a world of at least ``prod(shape)`` ranks)."""
    return checked_mesh(shape, axes, device_type=device_type)


def make_serve_mesh(data: int | None = None, model: int = 1, *,
                    fallback: bool = True, device_type=None):
    """The serving tier's (data, model) mesh: the batch axis over every
    rank.  ``data=None`` spans the world (weights replicated, batch
    sharded on ``data``).  A shape past the world warns and degrades to
    1x1 (``fallback=True``: a replica must come up) or raises
    :class:`MeshCapacityError`."""
    if data is None:
        data = max(world_size() // model, 1)
    return checked_mesh((data, model), ("data", "model"), fallback=fallback,
                        device_type=device_type)

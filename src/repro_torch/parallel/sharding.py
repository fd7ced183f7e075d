"""Logical-axis sharding rules — port of ``repro.parallel.sharding`` onto
``torch.distributed``'s ``DeviceMesh`` and DTensor placements.

Every param leaf carries a tuple of logical axis names
(``models.transformer.param_axes``).  A rule table maps logical names to
mesh axes; the resolver drops any assignment that fails divisibility or
would reuse a mesh axis already consumed by an earlier dim of the same
leaf — so one rule table serves every (arch x shape) cell (qwen2's 12
heads are not 16-way shardable; its ff=8960 is).

A resolved spec is a tuple with one entry per tensor dim — ``None``, a
mesh axis name, or a tuple of names (major to minor) — trailing ``None``s
dropped: entry for entry the JAX package's ``PartitionSpec``.
:func:`to_placements` turns it into DTensor placements, one per mesh dim.
A dim that does not divide stays replicated, so no DTensor shard is ever
uneven.

The resolver reads only axis names and sizes: a :class:`MeshShape`
(the counterpart of ``abstract_mesh_compat``) resolves rules at 16x16 or
2x16x16 with no process behind it; a ``DeviceMesh`` places tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

__all__ = ["MeshShape", "ShardingRules", "data_axis_size",
           "distribute_tree", "local_map", "logical_to_pspec", "make_rules",
           "make_sharder", "mesh_axis_size", "mesh_sizes", "place",
           "batch_local", "replicated_call", "serve_batch_pspec",
           "shard_range", "sum_over_group", "to_placements", "whole"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes with no devices behind them."""

    sizes: tuple
    names: tuple

    def __post_init__(self):
        if len(self.sizes) != len(self.names):
            raise ValueError(f"{self.sizes} sizes for axes {self.names}")

    @property
    def axis_names(self) -> tuple:
        return tuple(self.names)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a :class:`MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.names, (int(s) for s in mesh.sizes)))
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _names(mesh) -> tuple:
    return tuple(mesh_sizes(mesh))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (str), tuple of axes, or None."""

    table: dict

    def get(self, name: Optional[str]):
        if name is None:
            return None
        return self.table.get(name)


def make_rules(mesh, *, fsdp: bool = False, seq_shard: bool = False,
               overrides: dict | None = None) -> ShardingRules:
    """Default rule table for a ("pod"?, "data", "model") mesh."""
    names = _names(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    dp = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)
    table = {
        "batch": dp,
        "seq": "model" if seq_shard else None,
        "attn_seq": "model",         # SP fallback inside attention when
                                     # heads don't divide the model axis
        "cache_seq": "model",        # decode caches: shard time over model
        "vocab": "model",
        "embed": "data" if fsdp else None,   # FSDP/ZeRO param+opt sharding
        "ff": "model",
        "ff_expert": None,
        "experts": "model",          # expert parallelism
        "q_heads": "model",
        "kv_heads": "model",
        "kv_lora": None,
        "lora": None,
        "heads": "model",
        "layers": None,
    }
    if overrides:
        table.update(overrides)
    return ShardingRules(table)


def mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


# When several logical axes of one leaf map to the same mesh axis, assign in
# priority order (lower = first claim): head-sharding when heads divide the
# model axis, sequence-sharding (attn_seq) when they do not.
_PRIORITY = {
    "vocab": 0, "experts": 0, "ff": 0, "ff_expert": 0, "embed": 0,
    "batch": 0, "q_heads": 1, "kv_heads": 1, "heads": 1,
    "cache_seq": 2, "attn_seq": 3, "seq": 4,
}


def logical_to_pspec(axes: tuple, shape: tuple, mesh,
                     rules: ShardingRules) -> tuple:
    """Resolve one leaf.  Divisibility-, reuse- and priority-checked."""
    n = len(axes)
    order = sorted(range(n), key=lambda i: (_PRIORITY.get(axes[i], 9), i))
    used: set = set()
    out = [None] * n
    for i in order:
        dim, name = shape[i], axes[i]
        mesh_ax = rules.get(name)
        if mesh_ax is None:
            continue
        ax_tuple = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        if any(a in used for a in ax_tuple):
            continue                 # mesh axis already consumed by this leaf
        if dim % mesh_axis_size(mesh, mesh_ax) != 0:
            continue                 # not divisible: keep replicated
        used.update(ax_tuple)
        out[i] = mesh_ax
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements of a resolved spec on ``mesh``: ``Shard(d)`` on
    each mesh dim that tensor dim ``d``'s entry names, ``Replicate()`` on
    the others.  A tuple entry shards its dim over several mesh dims major
    to minor, as JAX orders them, which is DTensor's order when the tuple
    follows the mesh's own axis order."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def place(x: torch.Tensor, mesh, placements):
    """``x`` under ``placements`` on ``mesh``: a DTensor redistributed, a
    plain tensor (the same full value on every rank) taken apart locally
    with no communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, placements)
        x = x.full_tensor()
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def _tree_map_axes(fn, axes, tree):
    """``fn(axes leaf, tree leaf)`` over the matching leaves, in
    ``tree``'s key order."""
    if isinstance(axes, dict):
        return {k: _tree_map_axes(fn, axes[k], tree[k]) for k in tree}
    return fn(tuple(axes), tree)


def distribute_tree(tree, axes, mesh, rules: ShardingRules):
    """Each leaf of ``tree`` a DTensor under the placements its logical
    axes resolve to (the counterpart of ``named_sharding_tree`` with the
    ``device_put``): ``axes`` is a tree of tuples of the same keys."""
    return _tree_map_axes(
        lambda ax, x: place(x, mesh, to_placements(
            logical_to_pspec(ax, tuple(x.shape), mesh, rules), mesh)),
        axes, tree)


def data_axis_size(mesh) -> int:
    """Total data-parallel width of a ("pod"?, "data", ...) mesh."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


def serve_batch_pspec(mesh, batch: int, ndim: int = 4,
                      rules: ShardingRules | None = None) -> tuple:
    """Batch-leading activation spec for a serve bucket: the leading axis
    shards over the data axes when ``batch`` divides them (bucket 1 on a
    multi-rank mesh stays replicated)."""
    rules = rules or make_rules(mesh)
    axes = ("batch",) + (None,) * (ndim - 1)
    return logical_to_pspec(axes, (batch,) + (1,) * (ndim - 1), mesh, rules)


def local_map(fn: Callable, mesh, out_placements, *args):
    """``fn`` on each rank's local shards (the counterpart of
    ``shard_map_compat``): every DTensor of ``args`` (a tree of dicts,
    lists and tuples) becomes its local tensor, and each tensor ``fn``
    returns (a tensor or a tuple of them) is wrapped as a DTensor on
    ``mesh`` under the matching entry of ``out_placements``, taken as
    stated (no check of replication, as ``shard_map_compat``)."""
    from torch.distributed.tensor import DTensor

    def local(node):
        if isinstance(node, DTensor):
            return node.to_local()
        if isinstance(node, dict):
            return {k: local(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(local(v) for v in node)
        return node

    out = fn(*(local(a) for a in args))
    wrap = lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(t, pl) for t, pl in zip(out, out_placements))
    return wrap(out, out_placements)


def whole(x):
    """A DTensor gathered whole (a plain tensor on every rank of its mesh;
    a collective); anything else as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _map(fn, node):
    """``fn`` on the tensors of nested dicts, lists and tuples."""
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map(fn, v) for v in node)
    return fn(node) if isinstance(node, torch.Tensor) else node


def _mesh_of(*trees):
    """The mesh of the first DTensor in ``trees``, or None."""
    from torch.distributed.tensor import DTensor
    found = []
    for t in trees:
        _map(lambda x: found.append(x) if isinstance(x, DTensor) else x, t)
    return found[0].device_mesh if found else None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM of a local tensor over ``group`` into one value
    replicated on its ranks (a psum): the backward hands each rank's
    share the output's gradient unchanged, as the transpose of a psum
    into a replicated output."""
    return _SumOverGroup.apply(x, group)


def shard_range(mesh, dims, size: int) -> tuple[int, int]:
    """(start, length) of this rank's block of a tensor dim of ``size``
    sharded evenly over the mesh dims ``dims``, major to minor (DTensor's
    order of a dim's ``Shard`` placements)."""
    start, n = 0, size
    for i in dims:
        n //= mesh.size(i)
        start += mesh.get_local_rank(i) * n
    return start, n


def replicated_call(fn: Callable, *args):
    """``fn(*args)`` for a computation that takes plain tensors (a
    kernel, or an op DTensor has no rule for): where an argument (or a
    tensor in a dict, list or tuple argument) is a DTensor, every DTensor
    is gathered whole, ``fn`` runs on the whole tensors on every rank of
    the mesh, and each tensor it returns (in the same nesting) comes back
    a DTensor replicated over the mesh.  Gradients flow back through the
    gathers.  With no DTensor argument, ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _mesh_of(args)
    if mesh is None:
        return fn(*args)
    out = fn(*_map(whole, args))
    rep = [Replicate()] * mesh.ndim
    return _map(lambda t: DTensor.from_local(t, mesh, rep, run_check=False),
                out)


def batch_local(fn: Callable, *args, batched: int, **kw):
    """``fn(*args, **kw)`` on each rank's rows, for a computation
    independent per batch row that DTensor cannot run sharded (einsums
    over a sharded head dim flatten it, which DTensor of some versions
    refuses).  The first ``batched`` args are batch-leading: each keeps
    the first one's batch placements (``Shard(0)`` over the data axes)
    and is gathered whole on every other dim; the other args are
    gathered whole.  ``fn`` runs on the local tensors and each tensor it
    returns (batch-leading) comes back a DTensor under those batch
    placements.  Gradients: the batch-leading args' are exact per row,
    the others' partial sums over the data axes (DTensor reduces them).
    With a plain first arg, ``fn(*args, **kw)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lead = args[0]
    if not isinstance(lead, DTensor):
        return fn(*args, **kw)
    mesh = lead.device_mesh
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in lead.placements]
    rest = [Replicate()] * mesh.ndim
    rest_grad = [Partial() if isinstance(pl, Shard) else pl for pl in rows]

    def local(t, pl, grad_pl):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    local_args = [_map(lambda t: local(t, rows, rows), a) if i < batched
                  else _map(lambda t: local(t, rest, rest_grad), a)
                  for i, a in enumerate(args)]
    out = fn(*local_args, **kw)
    return _map(lambda t: DTensor.from_local(t, mesh, rows, run_check=False),
                out)


def make_sharder(mesh, rules: ShardingRules):
    """``sc(x, logical_axes)``: a DTensor redistributed to the placements
    its axes resolve to (the counterpart of ``with_sharding_constraint``);
    a plain tensor returned unchanged."""
    from torch.distributed.tensor import DTensor

    def sc(x, axes):
        if not isinstance(x, DTensor):
            return x
        spec = logical_to_pspec(tuple(axes), tuple(x.shape), mesh, rules)
        return x.redistribute(mesh, to_placements(spec, mesh))

    return sc

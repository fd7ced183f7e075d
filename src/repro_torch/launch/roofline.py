"""Roofline analysis of one step from PyTorch's own counts — port of
``repro.launch.roofline``.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs / (chips x peak FLOP/s)
  memory     = bytes / (chips x HBM bytes/s)
  collective = collective bytes / (chips x link bytes/s)

The JAX package reads FLOPs and bytes from XLA (``cost_analysis()`` and
its HLO text); torch has no HLO, so :func:`count_cost` runs the step once
and counts it as it runs, per device:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the matmuls,
  convolutions and attention ops it has formulas for; elementwise ops
  count none, as in XLA's dot-dominated count);
- bytes: :class:`ByteCounter`, a ``TorchDispatchMode`` that sums the
  bytes of each aten op's distinct tensor inputs and outputs, leaving out
  views, allocations that write nothing and collectives.  It stands in
  for XLA's "bytes accessed", but in eager mode it counts every op's
  traffic, with nothing fused: an upper bound on what a fused step must
  move;
- collective bytes: :class:`CollectiveCounter`, the output bytes of
  every collective the step issues, by kind (JAX's
  ``collective_bytes_from_hlo`` sums the same: output shapes, by kind):
  DTensor's redistributions (``_c10d_functional.*``, the ops
  ``CommDebugMode`` sees) and the explicit ``torch.distributed`` calls
  (``c10d.*``: ``moe_apply_ep``'s all-reduce, ``optim.compression``'s,
  the pipeline's sends and receives);
- the hand-written kernels (B1-B10) launch through ctypes, and no
  dispatch mode sees them: each wrapper adds its kernel's formula
  (``kernels.count_work``), the same numbers ``chip_smoke.py`` bounds the
  kernels with, on the card, the CPU and the meta device alike.

**Per device.**  JAX's ``cost_analysis`` is of the partitioned module: one
device's share.  A dispatch mode above DTensor would see each op at its
global shape, so the counters run beneath :class:`_LocalOps`, which hands
every op on DTensors back to DTensor (``NotImplemented``, as
``CommDebugMode`` does): DTensor then runs the local ops on each rank's
shards and the collectives, which the counters see; DTensor's own shape
propagation on fake tensors is run past them.  A purely data-parallel
step over D ranks counts 1/D of the one-device FLOPs.  On one device
there is no collective and the term is 0.  ``collective_bytes_from_hlo``
and ``launch/hlo_analysis.py`` parse XLA's HLO and have no counterpart
here.  ``MODEL_FLOPS`` (6·N·D train, 2·N·D inference, N the active
params) gives the useful-compute ratio, which exposes recomputation
(remat) and other redundant work.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.param_utils import tree_leaves
from repro_torch.models.transformer import active_params

__all__ = ["COLLECTIVES", "HW", "ByteCounter", "CollectiveCounter", "Cost",
           "RooflineReport", "analyze", "count_cost", "counting",
           "format_row", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM at its published peaks (NVIDIA H100 Tensor Core
    GPU datasheet: dense rates, without sparsity, at the 700 W limit)."""

    peak_flops: float = 989e12       # bf16 dense tensor-core FLOP/s
    hbm_bw: float = 3.35e12          # HBM3 bytes/s
    link_bw: float = 900e9           # NVLink bytes/s, all to all
    hbm_bytes: float = 80e9          # HBM3 capacity, bytes


#: Aten ops that allocate without writing: no traffic.
_NO_TRAFFIC = frozenset((
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default))


#: JAX's collective kinds (``collective_bytes_from_hlo``), and
#: "broadcast" for the one-to-all copies (c10d's broadcast and scatter).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

#: The collective ops, by op packet name, and their kind.
_KINDS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
    "c10d.recv_any_source_": "collective-permute",
    "c10d.broadcast_": "broadcast",
    "c10d.scatter_": "broadcast",
}

#: Namespaces of the collective and process-group ops: no HBM traffic of
#: their own in :class:`ByteCounter` (their bytes are the collective term).
_COMM_NAMESPACES = ("_c10d_functional", "c10d", "_c10d_functional_autograd")

#: Aten ops that allocate without writing: no traffic.
_NO_TRAFFIC = frozenset((
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default))


def _bytes(tree) -> int:
    """Bytes of the distinct tensors of a tree (an op's arguments or
    result)."""
    return sum({id(t): t.numel() * t.element_size()
                for t in tree_leaves(tree)}.values())


class ByteCounter(TorchDispatchMode):
    """Sums, over the aten ops dispatched inside it, the bytes of each
    op's distinct tensor inputs and outputs (an in-place op's tensor
    once), leaving out views, allocations that write nothing and
    collectives: the total in ``bytes``."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_TRAFFIC \
                and func.namespace not in _COMM_NAMESPACES:
            self.bytes += _bytes((args, kwargs, out))
        return out


def _group_size(args) -> int | None:
    """The size of the process group a collective op names: c10d's ops
    take the group (a script object), the functional ones its name."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue                 # another script object (an op)
    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
    return None


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched inside it: ``by_kind`` {kind:
    [calls, bytes]}, the bytes each op's output (the tensors it writes;
    a send's, the tensors it sends), as JAX counts its HLO's; and
    ``by_shape`` {"kind shape dtype": [calls, bytes]}, the same split by
    the shapes it moves, which name the tensor (a (V, d) table, a chunk's
    (B, S, V) logits).  A collective over a group of one rank moves
    nothing and is left out."""

    def __init__(self):
        super().__init__()
        self.by_kind: dict = {}
        self.by_shape: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get(str(func.overloadpacket))
        if kind is not None and _group_size(args) != 1:
            moved = out if _bytes(out) else (args, kwargs)
            nbytes = _bytes(moved)
            what = " ".join(f"{tuple(t.shape)} {str(t.dtype)[6:]}"
                            for t in tree_leaves(moved))
            for rec in (self.by_kind.setdefault(kind, [0, 0]),
                        self.by_shape.setdefault(f"{kind} {what}", [0, 0])):
                rec[0] += 1
                rec[1] += nbytes
        return out


class _LocalOps(TorchDispatchMode):
    """The top of the counting stack: an op on DTensors goes back to
    DTensor (which runs the local ops and collectives through the
    counters beneath), and DTensor's shape propagation on fake tensors
    runs with every mode off, uncounted."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            with _disable_current_modes():
                return func(*args, **(kwargs or {}))
        return func(*args, **(kwargs or {}))


@dataclasses.dataclass
class Cost:
    """One step's counts on one device: ``flops`` and ``bytes`` in all;
    ``aten_flops`` and ``aten_bytes`` the dispatch modes' share;
    ``kernels`` {wrapper name: [calls, bytes, operations]} from the
    kernels' formulas; ``collectives`` {kind: [calls, bytes]};
    ``collective_shapes`` the same by the shapes moved
    (:class:`CollectiveCounter`); ``flops_by_op`` {aten op: FLOPs}, the
    dispatch modes' share by op."""

    flops: float
    bytes: float
    aten_flops: float
    aten_bytes: float
    kernels: dict
    collectives: dict = dataclasses.field(default_factory=dict)
    collective_shapes: dict = dataclasses.field(default_factory=dict)
    flops_by_op: dict = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return float(sum(v[1] for v in self.collectives.values()))


@contextlib.contextmanager
def counting(*modes):
    """The counters of :func:`count_cost` around a block, ``modes``
    (further dispatch modes, as the dry run's memory tracker) beneath
    :class:`_LocalOps` with them.  Yields a callable that returns the
    block's :class:`Cost` once the block has run."""
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc, \
            CollectiveCounter() as cc, contextlib.ExitStack() as stack, \
            kernels.count_work() as work:
        for m in modes:
            stack.enter_context(m)
        stack.enter_context(_LocalOps())

        def cost() -> Cost:
            aten_flops = float(fc.get_total_flops())
            kflops = sum(v[2] for v in work.values())
            kbytes = sum(v[1] for v in work.values())
            return Cost(flops=aten_flops + kflops,
                        bytes=float(bc.bytes + kbytes),
                        aten_flops=aten_flops, aten_bytes=float(bc.bytes),
                        kernels={k: list(v) for k, v in work.items()},
                        collectives={k: list(v)
                                     for k, v in cc.by_kind.items()},
                        collective_shapes={k: list(v)
                                           for k, v in cc.by_shape.items()},
                        flops_by_op={str(op): float(n) for op, n in
                                     fc.get_flop_counts()
                                     .get("Global", {}).items()})
        yield cost


def count_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, eagerly, under the FLOP, byte and
    collective counters and the kernels' work sink, each op counted on
    its local shards (module docstring).  Returns (its result, Cost)."""
    with counting() as cost:
        out = fn(*args, **kwargs)
    return out, cost()


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D for train, 2·N·D for inference (N active, D tokens processed)."""
    n = active_params(cfg)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    d = shape.global_batch * 1            # decode: one token per sequence
    return 2.0 * n * d


@dataclasses.dataclass
class RooflineReport:
    """The JAX package's report fields.  ``hlo_gflops`` and ``hlo_gbytes``
    are the counted step on one device (:class:`Cost`'s ``flops`` and
    ``bytes``), ``xla_raw_gflops`` and ``xla_raw_gbytes`` the dispatch
    modes' share without the kernels' formulas, ``coll_gbytes`` and
    ``coll_breakdown`` ({kind: bytes}) the collectives' (0 and {} on one
    device)."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float                 # per-device GFLOP (counted step)
    hlo_gbytes: float                 # per-device GB (counted step)
    coll_gbytes: float                # per-device collective GB
    xla_raw_gflops: float             # the aten ops' share
    xla_raw_gbytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_gflops: float               # global useful GFLOP (6ND / 2ND)
    useful_ratio: float               # MODEL / (counted x chips)
    roofline_frac: float              # useful share of the binding term
    bytes_per_device: int
    coll_breakdown: dict

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def analyze(arch: str, cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
            chips: int, cost: Cost, bytes_per_device: int,
            hw: HW = HW()) -> RooflineReport:
    """The roofline of one step counted by :func:`count_cost` on one
    device of ``chips``; ``bytes_per_device`` what the step holds on a
    device (the caller's measure: peak allocated memory on the card, the
    dry run's count on the meta device).  The collective term is the
    device's collective bytes over the link rate, as the JAX package's."""
    flops, bts = cost.flops, cost.bytes
    coll = cost.collective_bytes
    t_c = flops / hw.peak_flops
    t_m = bts / hw.hbm_bw
    t_x = coll / hw.link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = mf / max(flops * chips, 1.0)
    # Roofline fraction: time the useful math would take at peak, over the
    # binding term's time.
    t_useful = mf / chips / hw.peak_flops
    frac = t_useful / max(terms[bottleneck], 1e-30)
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=bts / 1e9,
        coll_gbytes=coll / 1e9,
        xla_raw_gflops=cost.aten_flops / 1e9,
        xla_raw_gbytes=cost.aten_bytes / 1e9,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, model_gflops=mf / 1e9,
        useful_ratio=useful, roofline_frac=frac,
        bytes_per_device=int(bytes_per_device),
        coll_breakdown={k: float(v[1]) for k, v in cost.collectives.items()})


def format_row(r: RooflineReport) -> str:
    return (f"{r.arch:22s} {r.shape:12s} {r.mesh:10s} "
            f"comp={r.t_compute*1e3:9.3f}ms mem={r.t_memory*1e3:9.3f}ms "
            f"coll={r.t_collective*1e3:9.3f}ms  [{r.bottleneck:10s}] "
            f"roofline={r.roofline_frac:6.3f} useful={r.useful_ratio:6.3f} "
            f"dev_mem={r.bytes_per_device/2**30:6.2f}GiB")

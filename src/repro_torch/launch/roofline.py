"""Roofline analysis of one step from PyTorch's own counts — port of
``repro.launch.roofline`` on one device.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs / (chips x peak FLOP/s)
  memory     = bytes / (chips x HBM bytes/s)
  collective = collective bytes / (chips x link bytes/s)

The JAX package reads FLOPs and bytes from XLA (``cost_analysis()`` and
its HLO text); torch has no HLO, so :func:`count_cost` runs the step once
and counts it as it runs:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the matmuls,
  convolutions and attention ops it has formulas for; elementwise ops
  count none, as in XLA's dot-dominated count);
- bytes: :class:`ByteCounter`, a ``TorchDispatchMode`` that sums the
  bytes of each aten op's distinct tensor inputs and outputs, leaving out
  views and allocations that write nothing.  It stands in for XLA's
  "bytes accessed", but in eager mode it counts every op's traffic, with
  nothing fused: an upper bound on what a fused step must move;
- the hand-written kernels (B1-B10) launch through ctypes, and no
  dispatch mode sees them: each wrapper adds its kernel's formula
  (``kernels.count_work``), the same numbers ``chip_smoke.py`` bounds the
  kernels with, on the card and on the CPU alike.

The collective term is 0 on one device; the sharded steps
(``launch.steps`` with a mesh) are not counted yet: their collective term
is ROADMAP.md queue A item 13b.  ``collective_bytes_from_hlo`` and
``launch/hlo_analysis.py`` parse XLA's HLO and have no counterpart
here.  ``MODEL_FLOPS`` (6·N·D train, 2·N·D
inference, N the active params) gives the useful-compute ratio, which
exposes recomputation (remat) and other redundant work.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.param_utils import tree_leaves
from repro_torch.models.transformer import active_params

__all__ = ["HW", "ByteCounter", "Cost", "RooflineReport", "analyze",
           "count_cost", "format_row", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM at its published peaks (NVIDIA H100 Tensor Core
    GPU datasheet: dense rates, without sparsity, at the 700 W limit)."""

    peak_flops: float = 989e12       # bf16 dense tensor-core FLOP/s
    hbm_bw: float = 3.35e12          # HBM3 bytes/s
    link_bw: float = 900e9           # NVLink bytes/s (item 13b's term)
    hbm_bytes: float = 80e9          # HBM3 capacity, bytes


#: Aten ops that allocate without writing: no traffic.
_NO_TRAFFIC = frozenset((
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default))


class ByteCounter(TorchDispatchMode):
    """Sums, over the aten ops dispatched inside it, the bytes of each
    op's distinct tensor inputs and outputs (an in-place op's tensor
    once), leaving out views and allocations that write nothing: the
    total in ``bytes``."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_TRAFFIC:
            seen = {}
            for t in tree_leaves((args, kwargs, out)):
                seen[id(t)] = t.numel() * t.element_size()
            self.bytes += sum(seen.values())
        return out


@dataclasses.dataclass
class Cost:
    """One step's counts: ``flops`` and ``bytes`` in all; ``aten_flops``
    and ``aten_bytes`` the dispatch modes' share; ``kernels`` {wrapper
    name: [calls, bytes, operations]} from the kernels' formulas."""

    flops: float
    bytes: float
    aten_flops: float
    aten_bytes: float
    kernels: dict


def count_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, eagerly, under the FLOP and byte
    counters and the kernels' work sink.  Returns (its result, Cost)."""
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc, \
            kernels.count_work() as work:
        out = fn(*args, **kwargs)
    aten_flops = float(fc.get_total_flops())
    kflops = sum(v[2] for v in work.values())
    kbytes = sum(v[1] for v in work.values())
    return out, Cost(flops=aten_flops + kflops,
                     bytes=float(bc.bytes + kbytes),
                     aten_flops=aten_flops, aten_bytes=float(bc.bytes),
                     kernels={k: list(v) for k, v in work.items()})


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
    are the counted step (:class:`Cost`'s ``flops`` and ``bytes``),
    ``xla_raw_gflops`` and ``xla_raw_gbytes`` the dispatch modes' share
    without the kernels' formulas; ``coll_gbytes`` is 0 on one device."""

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
    """The roofline of one step counted by :func:`count_cost`;
    ``bytes_per_device`` what the step holds on a device (the caller's
    measure: peak allocated memory on the card).  No collective runs on
    one device: its term is 0."""
    flops, bts = cost.flops, cost.bytes
    t_c = flops / hw.peak_flops
    t_m = bts / hw.hbm_bw
    t_x = 0.0
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
        coll_gbytes=0.0,
        xla_raw_gflops=cost.aten_flops / 1e9,
        xla_raw_gbytes=cost.aten_bytes / 1e9,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, model_gflops=mf / 1e9,
        useful_ratio=useful, roofline_frac=frac,
        bytes_per_device=int(bytes_per_device), coll_breakdown={})


def format_row(r: RooflineReport) -> str:
    return (f"{r.arch:22s} {r.shape:12s} {r.mesh:10s} "
            f"comp={r.t_compute*1e3:9.3f}ms mem={r.t_memory*1e3:9.3f}ms "
            f"coll={r.t_collective*1e3:9.3f}ms  [{r.bottleneck:10s}] "
            f"roofline={r.roofline_frac:6.3f} useful={r.useful_ratio:6.3f} "
            f"dev_mem={r.bytes_per_device/2**30:6.2f}GiB")

"""EngineConfig — the one knob bundle for MNF compute (DESIGN.md §3), port
of ``repro.engine.config``.

The backend resolves from the device of the tensors handed in: ``"auto"``
gives ``"cuda"`` (the hand-written kernels) for CUDA tensors and
``"block"`` (the same dataflow through the kernels' plain versions) for
CPU tensors.  An explicit ``"cuda"`` on a CPU tensor raises, and so does an
explicit ``"block"`` on a CUDA tensor: a CUDA tensor launches the kernels
or raises.  The two oracles, ``"dense"`` and ``"scalar"``, resolve on
either device and never from ``"auto"``.  There is no interpret mode.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["BACKENDS", "RECURRENT_BLK_K", "EngineConfig"]

#: Default K-block width of the fire-gated recurrent decode (DESIGN.md
#: §13).  A per-token drive is one row (blk_m == 1), so the useful event
#: granularity is narrow K blocks over the channel axis: 16 channels give a
#: head_dim-64 wkv6 state four independently skippable row-blocks.
#: ``for_recurrent`` clamps to min(cfg.blk_k, RECURRENT_BLK_K, D).
RECURRENT_BLK_K = 16

#: Execution backends (DESIGN.md §4): dense — the oracle (F.conv2d /
#: torch.matmul); scalar — the paper's Algorithms 1 and 2 event by event,
#: a second oracle; block — the block-event dataflow through the kernels'
#: plain versions, CPU tensors only; cuda — the same dataflow through the
#: hand-written Hopper kernels, CUDA tensors only.
BACKENDS = ("dense", "scalar", "block", "cuda")


def _device_type(t) -> str:
    if isinstance(t, torch.Tensor):
        return t.device.type
    return torch.device(t).type


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """backend: one of BACKENDS or "auto"; blk_m/blk_k: event tile rows and
    K width (the CUDA kernels pick their own CTA width over N and mask the
    ragged edge, so there is no N tile); capacity: static event slots per
    row group (None = lossless); threshold/magnitude/signed: the fire rule; route: boundary routing
    policy (DESIGN.md §11) — "auto", "adaptive" or a forced route label;
    occupancy_hint: static occupancy for adaptive routing; int8_events:
    fire emits int8 event values with a symmetric per-layer ``QParams`` on
    the stream, and the consumers dequantize at tile load (DESIGN.md §12);
    int8_bits: the code width, kept for parity with the JAX package and
    refused unless 8 — the int8 kernels take int8 tiles only."""

    backend: str = "auto"
    blk_m: int = 8
    blk_k: int = 128
    capacity: int | None = None
    threshold: float = 0.0
    magnitude: bool = False
    signed: bool = False
    route: str = "auto"
    occupancy_hint: float | None = None
    int8_events: bool = False
    int8_bits: int = 8

    def __post_init__(self):
        if self.int8_bits != 8:
            raise ValueError(f"int8_bits={self.int8_bits}: the int8 kernels "
                             f"take 8-bit codes only")

    def resolve_backend(self, *tensors) -> str:
        """Concrete backend for operands on the devices of ``tensors``
        (tensors or devices).  "auto" -> cuda for CUDA operands, block
        otherwise; "cuda" with a CPU operand and "block" with a CUDA
        operand raise."""
        types = {_device_type(t) for t in tensors}
        if self.backend == "cuda" and types - {"cuda"}:
            raise ValueError(f"backend 'cuda' needs CUDA tensors, got "
                             f"tensors on {sorted(types)}")
        if self.backend == "block" and "cuda" in types:
            raise ValueError(f"backend 'block' needs CPU tensors, got "
                             f"tensors on {sorted(types)}; CUDA tensors "
                             f"take backend 'cuda'")
        if self.backend != "auto":
            return self.backend
        return "cuda" if "cuda" in types else "block"

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_mnf(cls, mnf) -> "EngineConfig":
        """Build from a ``configs.base.MNFConfig`` (the model-stack knobs).
        The backend is "auto" — the device of the tensors picks it;
        ``mnf.use_pallas`` has no meaning in the port."""
        return cls(backend="auto", blk_m=mnf.blk_m, blk_k=mnf.blk_k,
                   threshold=mnf.threshold, magnitude=mnf.magnitude)

    def for_recurrent(self, k: int) -> "EngineConfig":
        """The config a fire-gated recurrent decode step runs under: one
        row per (batch x head) — ``blk_m`` 1 — narrow K blocks
        (``RECURRENT_BLK_K``, clamped by the drive width and any smaller
        ``blk_k``), and ``signed`` on: recurrent deltas are two-sided."""
        return dataclasses.replace(
            self, blk_m=1,
            blk_k=min(self.blk_k, RECURRENT_BLK_K, max(k, 1)), signed=True)

    def for_width(self, m: int, k: int) -> "EngineConfig":
        """Clamp tile sizes to an (M, K) operand."""
        return dataclasses.replace(self, blk_m=min(self.blk_m, max(m, 1)),
                                   blk_k=min(self.blk_k, max(k, 1)))

    def for_conv(self, ci: int) -> "EngineConfig":
        """Clamp blk_k to a conv's input-channel depth (a wider K tile would
        only pad)."""
        return dataclasses.replace(self, blk_k=min(self.blk_k, max(ci, 1)))

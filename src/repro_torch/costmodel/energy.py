"""Dataflow energy model (Fig. 1, Table 5), Timeloop/Accelergy-style —
port of ``repro.costmodel.energy``, number for number.

Per-access energies are the paper's Table 5 values.  For each dataflow the
accesses at every memory level of one conv layer (Table 1 shapes) are
counted at a given activation density and multiplied by the per-access
energy (standard loop-nest accounting, Sze et al. tutorial [35]):

  weight-stationary  — weights read once from DRAM, inputs re-read per
                       filter position, psums spilled per input pass;
  input-stationary   — inputs read once, weights re-streamed per input
                       tile, psums spilled;
  output-stationary  — psums pinned in registers, inputs+weights
                       re-streamed per output;
  MNF event-driven   — weights resident in local SRAM (no DRAM in steady
                       state), each event reads its weight rows once from
                       local SRAM, accumulators read+written per event in
                       the two-port accumulate SRAM; zero activations cost
                       nothing anywhere.

These are energies of the paper's 28 nm ASIC model, not of any GPU.
"""
from __future__ import annotations

import dataclasses

__all__ = ["AccessEnergy", "TABLE5_OTHERS", "TABLE5_MNF", "ConvShape",
           "TABLE1", "dataflow_energy", "mnf_energy", "compare_dataflows"]


@dataclasses.dataclass(frozen=True)
class AccessEnergy:
    """pJ per access + access width in bits (Table 5)."""

    dram_pj: float
    dram_bits: int
    sram_pj: float
    sram_bits: int
    buf_pj: float
    buf_bits: int
    reg_pj: float
    reg_bits: int
    mac_pj: float = 0.56         # 8-bit MAC @ 22-28nm (Accelergy/Aladdin)


TABLE5_OTHERS = AccessEnergy(dram_pj=512.0, dram_bits=64,
                             sram_pj=74.0, sram_bits=64,
                             buf_pj=1.59, buf_bits=16,
                             reg_pj=0.97, reg_bits=16 * 3)

#: MNF column of Table 5: narrower DRAM port, small local SRAMs (3.87 pJ),
#: 216-bit wide weight-vector buffer reads + 32-bit accumulator access.
TABLE5_MNF = AccessEnergy(dram_pj=256.0, dram_bits=32,
                          sram_pj=3.87, sram_bits=32,
                          buf_pj=12.35, buf_bits=216,
                          reg_pj=0.018, reg_bits=8 * 3)


@dataclasses.dataclass(frozen=True)
class ConvShape:
    in_ch: int
    out_ch: int
    in_size: int
    out_size: int
    k: int

    @property
    def stride(self) -> int:
        return max(1, self.in_size // self.out_size)

    @property
    def macs(self) -> int:
        return self.out_size ** 2 * self.k ** 2 * self.in_ch * self.out_ch

    @property
    def weights(self) -> int:
        return self.k ** 2 * self.in_ch * self.out_ch

    @property
    def inputs(self) -> int:
        return self.in_size ** 2 * self.in_ch

    @property
    def outputs(self) -> int:
        return self.out_size ** 2 * self.out_ch


#: Table 1 workloads.
TABLE1 = {
    "layer1": ConvShape(256, 384, 56, 56, 3),
    "layer2": ConvShape(384, 256, 13, 13, 3),
    "layer3": ConvShape(64, 128, 224, 224, 3),
}


def _energy(counts: dict, e: AccessEnergy) -> float:
    """counts: accesses (in elements, 8-bit acts/weights, 32-bit psums)."""
    pj = 0.0
    pj += counts.get("dram", 0) * 8 / e.dram_bits * e.dram_pj
    pj += counts.get("dram32", 0) * 32 / e.dram_bits * e.dram_pj
    pj += counts.get("sram", 0) * 8 / e.sram_bits * e.sram_pj
    pj += counts.get("sram32", 0) * 32 / e.sram_bits * e.sram_pj
    pj += counts.get("buf", 0) * 8 / e.buf_bits * e.buf_pj
    pj += counts.get("buf32", 0) * 32 / e.buf_bits * e.buf_pj
    pj += counts.get("reg", 0) * e.reg_pj
    pj += counts.get("mac", 0) * e.mac_pj
    return pj


def dataflow_energy(shape: ConvShape, dataflow: str, d_act: float = 1.0,
                    d_w: float = 1.0, e: AccessEnergy = TABLE5_OTHERS
                    ) -> float:
    """Energy (pJ) of one conv layer under a classic dataflow ("ws", "is"
    or "os").  Sparse operands still transit DRAM in compressed form
    (d_act/d_w scale the streamed volumes); MACs scale with the d_act·d_w
    intersection."""
    macs = shape.macs * d_act * d_w
    w, a, o = shape.weights * d_w, shape.inputs * d_act, shape.outputs
    reuse_a = shape.k ** 2 / shape.stride ** 2     # positions touching a pixel
    if dataflow == "ws":
        counts = dict(
            dram=w + a + o,                        # stream everything once
            sram=w + a * reuse_a + o,              # inputs re-read per k²
            buf=macs * 2,                          # operand feeds
            sram32=2 * o * shape.in_ch * d_act,    # psum spills per channel
            reg=macs, mac=macs)
    elif dataflow == "is":
        counts = dict(
            dram=w + a + o,
            sram=a + w * (shape.out_size ** 2 / 64) + o,  # weights restream
            buf=macs * 2,
            sram32=2 * o * shape.in_ch * d_act,
            reg=macs, mac=macs)
    elif dataflow == "os":
        counts = dict(
            dram=w + a + o,
            sram=a * reuse_a + w * (shape.out_size ** 2 / 64),
            buf=macs * 2,
            sram32=2 * o,                          # psums stay local
            reg=macs, mac=macs)
    else:
        raise ValueError(dataflow)
    return _energy(counts, e)


def mnf_energy(shape: ConvShape, d_act: float = 1.0, d_w: float = 1.0,
               e: AccessEnergy = TABLE5_MNF) -> float:
    """Energy (pJ) of the MNF event-driven dataflow on the same layer.
    Weights live in local SRAM (loaded once at deployment, §1 "fit all
    parameters on-chip"); every event reads k²/s² weight vectors and
    read-modify-writes k²/s²·c_out accumulators; non-events cost nothing.
    (``d_w`` is accepted for symmetry and, as in the JAX package, unused.)"""
    events = shape.inputs * d_act
    reuse = shape.k ** 2 / shape.stride ** 2
    macs = events * reuse * shape.out_ch
    counts = dict(
        dram=0,                                     # no steady-state DRAM
        sram=events * reuse * shape.out_ch,         # weight vector reads
        buf32=2 * macs / 27,                        # accum vector r/w bursts
        reg=macs,
        mac=macs)
    return _energy(counts, e)


def compare_dataflows(shape: ConvShape, d_act: float, d_w: float = 1.0):
    """{"ws", "inp", "os", "mnf"}: pJ of each dataflow on ``shape``."""
    return dict(
        ws=dataflow_energy(shape, "ws", d_act, d_w),
        inp=dataflow_energy(shape, "is", d_act, d_w),
        os=dataflow_energy(shape, "os", d_act, d_w),
        mnf=mnf_energy(shape, d_act, d_w),
    )

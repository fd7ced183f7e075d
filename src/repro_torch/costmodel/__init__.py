"""The paper's cost model (port of ``repro.costmodel``): cycle models of MNF
and its baselines (``accelerators``), dataflow energy (``energy``), Table
4's frames/s, power and frames/J (``table4``), Fig. 2's utilization
(``utilization``), analytic per-layer stats (``workloads``) and the
event-vs-dense routing decision (``crossover``).  Every number is a model
number of the paper's 200 MHz ASIC (Table 3), equal to the JAX package's."""
from repro_torch.costmodel.accelerators import (PAPER_HW, UTIL_CURVES,
                                                HWBudget,
                                                baseline_layer_cycles,
                                                dense_layer_cycles,
                                                mnf_layer_cycles,
                                                mnf_utilization,
                                                network_cycles)
from repro_torch.costmodel.energy import (TABLE1, TABLE5_MNF, TABLE5_OTHERS,
                                          AccessEnergy, ConvShape,
                                          compare_dataflows, dataflow_energy,
                                          mnf_energy)
from repro_torch.costmodel.table4 import (ALEXNET_DENSITY_PROFILE,
                                          PAPER_TABLE4,
                                          VGG16_DENSITY_PROFILE,
                                          frames_per_joule,
                                          frames_per_second, power_mw,
                                          table4_row)
from repro_torch.costmodel.utilization import (mnf_utilization_at_density,
                                               snap_utilization_at_density,
                                               utilization_sweep)

__all__ = [
    "PAPER_HW", "UTIL_CURVES", "HWBudget", "baseline_layer_cycles",
    "dense_layer_cycles", "mnf_layer_cycles", "mnf_utilization",
    "network_cycles", "TABLE1", "TABLE5_MNF", "TABLE5_OTHERS",
    "AccessEnergy", "ConvShape", "compare_dataflows", "dataflow_energy",
    "mnf_energy", "ALEXNET_DENSITY_PROFILE", "PAPER_TABLE4",
    "VGG16_DENSITY_PROFILE", "frames_per_joule", "frames_per_second",
    "power_mw", "table4_row", "mnf_utilization_at_density",
    "snap_utilization_at_density", "utilization_sweep",
]

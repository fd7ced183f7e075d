"""The fault-tolerant training loop and the elastic re-mesh — port of
``repro.runtime``."""
from repro_torch.runtime.elastic import (choose_mesh_shape, elastic_remesh,
                                         reshard_tree)
from repro_torch.runtime.fault_tolerance import (LoopConfig, ResilientLoop,
                                                 StragglerDetector)

__all__ = ["LoopConfig", "ResilientLoop", "StragglerDetector",
           "choose_mesh_shape", "elastic_remesh", "reshard_tree"]

"""The fault-tolerant training loop (port of ``repro.runtime``; the
elastic re-mesh of ``elastic.py`` belongs to ROADMAP.md queue A item
13)."""
from repro_torch.runtime.fault_tolerance import (LoopConfig, ResilientLoop,
                                                 StragglerDetector)

__all__ = ["LoopConfig", "ResilientLoop", "StragglerDetector"]

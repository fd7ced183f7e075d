"""Optimizer and learning-rate schedules — port of ``repro.optim``
(AdamW and the schedules; the gradient compression of ``compression.py``
belongs to ROADMAP.md queue A item 13)."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, clip_by_global_norm,
                                     global_norm)
from repro_torch.optim.schedule import constant, warmup_cosine, warmup_linear

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "constant", "warmup_cosine",
           "warmup_linear"]

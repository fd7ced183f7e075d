"""Checkpoints in the JAX package's layout (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (all_steps, latest_step,
                                                 restore, save, save_async)

__all__ = ["all_steps", "latest_step", "restore", "save", "save_async"]

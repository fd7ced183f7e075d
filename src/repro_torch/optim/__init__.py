"""Optimizer, learning-rate schedules and gradient compression — port of
``repro.optim``: AdamW, the schedules, and the compressed all-reduces of
``compression.py`` (``quantized_psum``, ``event_psum``) over a process
group."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, adamw_update_,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.compression import (event_psum,
                                           make_compressed_grad_fn,
                                           quantized_psum, topk_threshold)
from repro_torch.optim.schedule import constant, warmup_cosine, warmup_linear

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "adamw_update_", "clip_by_global_norm", "global_norm", "constant",
           "warmup_cosine", "warmup_linear", "event_psum", "make_compressed_grad_fn",
           "quantized_psum", "topk_threshold"]

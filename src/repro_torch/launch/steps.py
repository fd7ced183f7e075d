"""Step factories — port of ``repro.launch.steps.make_prefill_step`` and
``make_serve_step``.  PyTorch runs eagerly on one device, so a step is a
plain callable: no jit, no mesh, no shardings, no donation."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.engine.config import EngineConfig
from repro_torch.models import transformer as tfm

__all__ = ["StepPlan", "cell_engine_config", "make_prefill_step",
           "make_serve_step"]


def cell_engine_config(cfg: ModelConfig) -> EngineConfig:
    """The MNF engine configuration a cell runs under (backend "auto": the
    device of the tensors resolves it)."""
    return EngineConfig.from_mnf(cfg.mnf)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    cfg: ModelConfig
    shape: ShapeConfig
    fn: Callable
    engine: EngineConfig


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig) -> StepPlan:
    """fn(params, batch) -> (last-position logits, filled cache)."""
    def prefill_step(params, batch):
        return tfm.prefill(params, batch["tokens"], cfg,
                           max_len=shape.seq_len)
    return StepPlan(cfg, shape, prefill_step, cell_engine_config(cfg))


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig) -> StepPlan:
    """fn(params, cache, batch, decode_pos) -> (logits, new cache): one new
    token against the cache."""
    def serve_step(params, cache, batch, decode_pos):
        return tfm.decode_step(params, cache, batch["tokens"], decode_pos,
                               cfg)
    return StepPlan(cfg, shape, serve_step, cell_engine_config(cfg))

"""Fault-tolerant training loop: restart, stragglers, graceful preemption
— port of ``repro.runtime.fault_tolerance`` on one device.

``ResilientLoop`` wraps a train-step callable with:
  * step-atomic async checkpointing every ``ckpt_every`` steps, and a
    synchronous final one,
  * auto-resume from the latest complete checkpoint (``LATEST``),
  * garbage collection that keeps the last ``keep_last`` checkpoints,
  * SIGTERM/SIGINT handling: a preemption notice ends the loop after the
    running step, and the final checkpoint is written before it returns,
  * a straggler detector: a per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x the EWMA are flagged.

Each step is timed up to a ``torch.cuda.synchronize()`` where the state
lies on the card (the JAX loop's ``block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import signal
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.checkpoint.checkpointer import _flatten_with_path

__all__ = ["LoopConfig", "ResilientLoop", "StragglerDetector"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep_last: int = 3
    straggler_factor: float = 2.5
    ewma_alpha: float = 0.1


class StragglerDetector:
    """Flags steps that exceed factor x the EWMA of the step time."""

    def __init__(self, factor: float = 2.5, alpha: float = 0.1):
        self.factor = factor
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.flagged: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.factor * self.ewma
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
        # Straggler samples do not poison the EWMA.
        if not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


def _sync(state) -> None:
    """Wait for the card, where a leaf of ``state`` lies on it."""
    for _, leaf in _flatten_with_path(state):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class ResilientLoop:
    def __init__(self, cfg: LoopConfig, step_fn: Callable,
                 batch_fn: Callable[[int], Any]):
        """step_fn(state, batch) -> (state, metrics); ``state`` is a tree
        of tensors (the train driver's (params, opt_state)), batch_fn(step)
        the step's batch."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.detector = StragglerDetector(cfg.straggler_factor,
                                          cfg.ewma_alpha)
        self._preempted = False
        self._pending_save = None
        self.metrics_log: list[dict] = []

    def _handle_signal(self, signum, frame):
        self._preempted = True

    def _maybe_gc(self):
        steps = ckpt_lib.all_steps(self.cfg.ckpt_dir)
        for s in steps[:-self.cfg.keep_last]:
            shutil.rmtree(os.path.join(self.cfg.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def run(self, init_state):
        """Returns (state, the step reached, whether it was preempted)."""
        cfg = self.cfg
        state = init_state
        start = 0
        latest = ckpt_lib.latest_step(cfg.ckpt_dir)
        if latest is not None:
            state, start = ckpt_lib.restore(state, cfg.ckpt_dir, latest)
        old_term = signal.signal(signal.SIGTERM, self._handle_signal)
        old_int = signal.signal(signal.SIGINT, self._handle_signal)
        try:
            step = start
            while step < cfg.total_steps and not self._preempted:
                batch = self.batch_fn(step)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, batch)
                _sync(state)
                dt = time.monotonic() - t0
                straggle = self.detector.observe(step, dt)
                metrics = dict(metrics, step=step, step_time_s=dt,
                               straggler=straggle)
                self.metrics_log.append(
                    {k: (float(v) if isinstance(v, (torch.Tensor, int,
                                                    float)) else v)
                     for k, v in metrics.items()})
                step += 1
                if step % cfg.ckpt_every == 0:
                    if self._pending_save is not None:
                        self._pending_save.join()
                    self._pending_save = ckpt_lib.save_async(
                        state, cfg.ckpt_dir, step)
                    self._maybe_gc()
            # Final / preemption checkpoint: synchronous, never skipped.
            if self._pending_save is not None:
                self._pending_save.join()
            ckpt_lib.save(state, cfg.ckpt_dir, step)
            return state, step, self._preempted
        finally:
            signal.signal(signal.SIGTERM, old_term)
            signal.signal(signal.SIGINT, old_int)

"""Prefetching, resumable data loader — port of
``repro.data.loader.PrefetchLoader`` on one device.

Wraps a pure ``batch_fn(step) -> dict of tensors`` (``data.synthetic``,
made on the CPU) with a background prefetch thread and device placement:
where the JAX loader takes a sharding, this one takes a device, and puts
each batch there from pinned host memory with a ``non_blocking`` copy.
The state is the step counter — checkpointable as one int.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable

import torch

__all__ = ["PrefetchLoader"]


class PrefetchLoader:
    """Iterator of ``(step, batch)`` from ``start_step`` on, ``prefetch``
    batches made ahead on a worker thread.  ``device`` None leaves the
    batches where ``batch_fn`` made them.  An exception of ``batch_fn``
    is raised by the ``next`` that would have returned its batch."""

    def __init__(self, batch_fn: Callable[[int], dict], *,
                 start_step: int = 0, prefetch: int = 2, device=None):
        self._batch_fn = batch_fn
        self._step = start_step
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        if self._device is None:
            return batch
        pin = self._device.type == "cuda"
        return {k: (v.pin_memory() if pin and v.device.type == "cpu"
                    else v).to(self._device, non_blocking=True)
                for k, v in batch.items()}

    def _work(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self._place(self._batch_fn(step)))
            except Exception as e:            # surfaced by __next__
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        step, batch = item
        self._step = step + 1
        return step, batch

    @property
    def state(self) -> dict:
        """Checkpointable loader state: the next step it yields."""
        return dict(step=self._step)

    def close(self) -> None:
        """Stop the worker, drop the batches made ahead, and join the
        worker."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)

"""The control of the comparison: the plain reference put in the
program's place, computed in the nearest precision below the
configuration's (TF32 for float32 with TF32 off).  It serves the same
traffic through the same interface as the system of ``systems/cnn_serve.py``
(a FIFO queue drained each tick in batches of at most the largest
bucket), so a run with it goes through every step a benchmark run does.
``calibrate.py`` reads it; the benchmark's own runs never do."""
from __future__ import annotations

import time
from collections import deque

import torch

from mnfbench.records import Batch, Run

__all__ = ["ReferenceServe"]

clock = time.perf_counter


class ReferenceServe:
    def __init__(self, cfg: dict, params: list, buckets, device,
                 rec: Run, *, reference, precision: str = "tf32"):
        self.cfg, self.params, self.rec = cfg, params, rec
        self.max_batch = max(buckets)
        self.device = torch.device(device)
        self.ref, self.precision = reference, precision
        self._queue: deque = deque()

    def submit(self, req, image) -> None:
        req.submit = clock()
        self._queue.append((req, image))

    def pending(self) -> int:
        return len(self._queue)

    def run_tick(self, tick: int) -> list:
        done = []
        while self._queue:
            take = [self._queue.popleft()
                    for _ in range(min(self.max_batch, len(self._queue)))]
            b = Batch(start=clock(), bucket=len(take), tick=tick,
                      reqs=[r for r, _ in take])
            t = clock()
            x = torch.stack([img for _, img in take]).to(self.device)
            b.stage_s = clock() - t
            y = self.ref.forward(self.cfg, self.params, x,
                                 precision=self.precision).cpu()
            now = clock()
            b.end = now
            for i, (r, _) in enumerate(take):
                r.done, r.logits, r.batch = now, y[i], len(self.rec.batches)
            self.rec.batches.append(b)
            done.extend(r for r, _ in take)
        return done

    def close(self) -> None:
        self.params = None

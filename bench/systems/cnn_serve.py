"""The system under test of the CNN configurations: the port's serving
tier, ``repro_torch.serving.ServeEngine``, driven as its users drive it
(``submit``, then ``run_tick``).  A configuration names it under
``system``; the modules under ``systems/`` are the only ones of the
benchmark that import the program (``repro_torch``).

Every time is read from the benchmark's own clock, never from a stamp of
the program's: a request is submitted when the benchmark calls
``ServeEngine.submit``, and its logits are on the host once ``run_tick``
has returned it, the logits brought to the host if they were not, and
the card synchronised, so no work queued for them is still in flight.

The spans inside a tick wrap the engine's public ``forward`` (one
batch: staged, copied, replayed, its logits read) and ``stage`` (the pad
and copy into the staging buffer).  A batch's members are the next
requests in submission order (the tier is FIFO), taken only where the
images ``forward`` was handed are those very requests' images.  A span
that never fires, or does not match, stays None, and a reader that needs
it reads nothing; the end-to-end metrics need none.
"""
from __future__ import annotations

import time
from collections import deque

import torch

from mnfbench.records import Batch, Run

__all__ = ["System"]

clock = time.perf_counter


def _spec(cfg: dict):
    from repro_torch.models import cnn

    layers = []
    for layer in cfg["layers"]:
        kind = layer["kind"]
        if kind == "conv":
            layers.append(cnn.ConvSpec(layer["out"], layer["k"],
                                       layer["stride"], layer["padding"]))
        elif kind == "pool":
            layers.append(cnn.PoolSpec(layer["k"], layer["stride"]))
        elif kind == "fc":
            layers.append(cnn.FCSpec(layer["out"]))
        else:
            raise ValueError(f"layer kind {kind!r}")
    return cnn.CNNSpec(cfg["name"], cfg["input_size"], cfg["in_ch"],
                       tuple(layers), cfg["num_classes"])


def _images_arg(args: tuple, kwargs: dict):
    images = kwargs.get("images", args[1] if len(args) > 1 else None)
    return images if isinstance(images, (list, tuple)) else None


class System:
    """``ServeEngine`` over the configuration's network, one CUDA graph a
    bucket (captured when it is built).  Offers ``submit(req, image)``,
    ``pending()``, ``run_tick(tick) -> [Req]`` and ``close()``, and
    records its batches into ``rec``."""

    def __init__(self, cfg: dict, params: list, buckets, device, rec: Run):
        from repro_torch import engine as mnf_engine
        from repro_torch import serving

        if cfg["dtype"] != "float32":
            raise ValueError(f"dtype {cfg['dtype']!r}: the CNN serving "
                             f"path serves float32")
        self.rec = rec
        self.device = torch.device(device)
        self.eng = serving.ServeEngine(
            _spec(cfg), params,
            serving.ServeEngineConfig(buckets=tuple(buckets)),
            engine_cfg=mnf_engine.EngineConfig(**cfg["engine"]),
            device=device)
        self._by_rid: dict = {}        # the engine's rid -> Req
        self._fifo: deque = deque()    # (Req, image) not yet in a batch
        self._open: Batch | None = None
        self._tick = -1
        forward, stage = self.eng.forward, self.eng.stage

        def forward_spanned(*args, **kwargs):
            b = Batch(start=clock(), tick=self._tick)
            self._open = b
            try:
                with torch.profiler.record_function("bench.forward"):
                    out = forward(*args, **kwargs)
                self._sync()
                t = clock()
            finally:
                self._open = None
            self._match(b, _images_arg(args, kwargs), out, t)
            return out

        def stage_spanned(*args, **kwargs):
            t = clock()
            with torch.profiler.record_function("bench.stage"):
                out = stage(*args, **kwargs)
            b = self._open
            if b is not None:
                b.stage_s = (b.stage_s or 0.0) + clock() - t
                if isinstance(out, torch.Tensor) and out.dim() > 0:
                    b.bucket = int(out.shape[0])
            return out

        self.eng.forward = forward_spanned
        self.eng.stage = stage_spanned

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _match(self, b: Batch, images, out, t: float) -> None:
        """Record ``b`` as the batch of the next requests in submission
        order, if ``images`` are theirs."""
        if images is None or not 0 < len(images) <= len(self._fifo):
            return
        head = [self._fifo[i] for i in range(len(images))]
        if any(img is not own for img, (_, own) in zip(images, head)):
            return
        for _ in head:
            self._fifo.popleft()
        b.reqs = [req for req, _ in head]
        if isinstance(out, torch.Tensor) and out.device.type == "cpu" \
                and out.dim() > 0 and out.shape[0] == len(images):
            b.end = t
        idx = len(self.rec.batches)
        for req in b.reqs:
            req.batch = idx
        self.rec.batches.append(b)

    def submit(self, req, image) -> None:
        req.submit = clock()
        r = self.eng.submit(image)
        self._by_rid[r.rid] = req
        self._fifo.append((req, image))

    def pending(self) -> int:
        """Requests submitted and not yet returned."""
        return len(self._by_rid)

    def run_tick(self, tick: int) -> list:
        self._tick = tick
        with torch.profiler.record_function("bench.tick"):
            done = self.eng.run_tick()
        out = []
        for r in done:
            req = self._by_rid.pop(r.rid)
            logits = r.result
            if isinstance(logits, torch.Tensor) and \
                    logits.device.type != "cpu":
                logits = logits.cpu()
            req.logits = logits
            out.append(req)
        self._sync()
        t = clock()
        for req in out:
            req.done = t
        if out and self._fifo:
            gone = {id(req) for req in out}
            self._fifo = deque(x for x in self._fifo if id(x[0]) not in gone)
        return out

    def close(self) -> None:
        self.eng = None

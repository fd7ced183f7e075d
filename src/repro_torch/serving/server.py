"""ServeEngine — the serving tier over the event-resident CNN and MLP, port
of ``repro.serving.server`` on one device.

One engine = one replica: one pipeline per batch bucket (a CUDA graph on
the card, ``launch.steps.make_cnn_serve_step``), and a continuous batcher
routing the FIFO request queue into the smallest admissible bucket each
tick (DESIGN.md §10).  The three invariants of the JAX tier, each enforced
or measured:

  * **No steady-state capture.**  Every bucket is warmed at startup: its
    pipeline's first call on a zero batch, which on the card is the eager
    warm-up plus the graph capture (``launch.graphs``).  ``recompiles``
    counts every capture the engine's pipelines ever made (on the CPU
    their first calls); a flat count after the warm-up proves no tick
    captured anything.  A capture that fails raises: no bucket ever runs
    eagerly on the card.
  * **Padding is bitwise-free.**  Short batches are zero-padded to the
    bucket shape in an engine-owned staging buffer (pinned host memory on
    the card, its padding rows re-zeroed every batch); zero rows ride the
    pipeline as event-free streams and their logits are sliced off, so a
    real request's logits are bitwise the unpadded forward's.
  * **No silent event-path degradation.**  ``boundary_report`` reads a
    bucket's trace records: on the card those its graph's capture saw
    (routes are static per shape, DESIGN.md §11), on the CPU those of an
    eager call on a zero batch; an eligible boundary reporting
    ``fallback_decode`` is a serving bug, not a slow path.

Each batch is copied host → device into the graph's static input
(asynchronously, from the pinned buffer), replayed with no host sync
(``torch.cuda.set_sync_debug_mode("error")`` holds it so), and its logits
read back: that read is the one sync a batch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import engine as mnf_engine
from repro_torch.core.fire import FireConfig
from repro_torch.device import default_device
from repro_torch.launch.steps import make_cnn_serve_step
from repro_torch.serving.batcher import (DEFAULT_BUCKETS, ContinuousBatcher,
                                         Request, pad_bucket)

__all__ = ["ServeEngineConfig", "ServeEngine", "percentile"]


@dataclasses.dataclass(frozen=True)
class ServeEngineConfig:
    """Replica-level knobs of the serving tier (the CLI maps onto this).

    buckets:      captured batch shapes, ascending (requests are padded up
                  to the smallest admissible one).
    mnf:          event-resident pipeline (False = dense oracle serving).

    The fire threshold, backend and route come from the engine's
    ``engine_cfg`` alone.  Every bucket is warmed at startup, and each
    tick drains the queue.  The JAX tier's ``cache_dir`` has no
    counterpart: a CUDA graph holds one process's device addresses and
    cannot be written to disk, and the kernel library is already built
    once per source hash (``kernels/build.py``) and reloaded on restart.
    """

    buckets: tuple = DEFAULT_BUCKETS
    mnf: bool = True


def percentile(values: list, q: float) -> float:
    """q-th percentile of a latency list (0 for an empty window)."""
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """On the card, raise at any host sync inside the block."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class ServeEngine:
    """One serving replica: continuously batched, one captured pipeline a
    bucket.  Runs on the card unless ``device`` says otherwise.  With a
    ``mesh`` (``launch.mesh.make_serve_mesh``; every rank of it runs the
    engine on the same requests) each bucket that divides the data axes
    is served batch-parallel over them (``launch.steps.BatchParallel``),
    the weights replicated."""

    def __init__(self, spec, params, cfg: ServeEngineConfig | None = None, *,
                 engine_cfg=None, device=None, mesh=None):
        self.cfg = cfg or ServeEngineConfig()
        self.spec = spec
        self.device = default_device() if device is None \
            else torch.device(device)
        self.mesh = mesh
        self.engine_cfg = engine_cfg or mnf_engine.EngineConfig()
        self.fire_cfg = FireConfig(threshold=self.engine_cfg.threshold)
        self.plans = {
            b: make_cnn_serve_step(spec, b, mnf=self.cfg.mnf,
                                   engine_cfg=self.engine_cfg,
                                   fire_cfg=self.fire_cfg,
                                   device=self.device, mesh=mesh)
            for b in self.cfg.buckets}
        self.batcher = ContinuousBatcher(self.cfg.buckets)
        # placed once: every bucket's pipeline is bound to these tensors
        self.params = [None if p is None else p.to(self.device)
                       for p in params]
        self._stage: dict[int, torch.Tensor] = {}
        #: {bucket: {"warmup_s", "capture_s"}}: the warm-up's eager call
        #: and the graph capture, host seconds (on the CPU the first call,
        #: capture 0).
        self.warmup_s: dict[int, dict] = {}
        #: {bucket: {"pool_gib", "peak_gib"}} on the card: the memory the
        #: bucket's graph keeps reserved, and the peak its warm-up and
        #: capture allocated, both above what was allocated before.
        self.graph_gib: dict[int, dict] = {}
        self.completed: list[Request] = []
        self.ttfr_s: float | None = None   # time to first response
        self._born = time.perf_counter()
        self._serve_window = 0.0
        self.warm()

    @property
    def recompiles(self) -> int:
        """Every capture the engine's pipelines ever made (on the CPU,
        their first calls).  Flat after the warm-up == no steady-state
        tick captured anything."""
        return sum(p.fn.captures for p in self.plans.values())

    # -- warm-up -------------------------------------------------------------

    def _compiled(self, bucket: int):
        """The bucket's pipeline, warmed at its first use (at startup):
        captured, and run once through the request path (its staging
        buffer allocated, the copy, the replay and the logits read), so no
        request pays a first use."""
        plan = self.plans[bucket]
        if bucket in self.warmup_s:
            return plan.fn
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            allocated = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        plan.fn(self.params, self._buffer(bucket)).cpu()
        if cuda:
            g = plan.fn.graph
            self.warmup_s[bucket] = dict(warmup_s=round(g.warmup_s, 4),
                                         capture_s=round(g.capture_s, 4))
            peak = torch.cuda.max_memory_allocated(self.device) - allocated
            torch.cuda.empty_cache()
            pool = torch.cuda.memory_reserved(self.device) - reserved
            self.graph_gib[bucket] = dict(pool_gib=pool / 2**30,
                                          peak_gib=peak / 2**30)
        else:
            self.warmup_s[bucket] = dict(
                warmup_s=round(time.perf_counter() - t0, 4), capture_s=0.0)
        return plan.fn

    def warm(self) -> dict:
        """Warm every bucket (startup); returns the per-bucket warm-up and
        capture seconds."""
        for b in self.cfg.buckets:
            self._compiled(b)
        return self.warmup_s

    # -- introspection -------------------------------------------------------

    def boundary_report(self, bucket: int | None = None) -> dict:
        """One bucket's chain accounting from its trace records:
        chained/pool/fallback counts plus each boundary's routing decision.
        On the card the records the bucket graph's capture saw; on the CPU
        those of an eager call on a zero batch.  ``fallback_decodes`` must
        be 0 on an eligible network."""
        bucket = self.cfg.buckets[0] if bucket is None else bucket
        plan = self.plans[bucket]
        fn = self._compiled(bucket)
        if self.device.type == "cuda":
            recs = fn.graph.records
        else:
            with mnf_engine.trace_dispatch() as recs:
                fn.fwd(self.params, torch.zeros(plan.input_shape))
        routes = [dict(op=r.get("op"), route=r.get("route"),
                       occupancy=r.get("occupancy"),
                       source=r.get("route_source"),
                       shape_class=r.get("shape_class"))
                  for r in recs if r.get("route") is not None]
        route_counts: dict[str, int] = {}
        for r in routes:
            route_counts[r["route"]] = route_counts.get(r["route"], 0) + 1
        return dict(
            bucket=bucket,
            chained=sum(1 for r in recs if r.get("chained")),
            pool_events=sum(1 for r in recs if r.get("pool_events")),
            fallback_decodes=sum(
                1 for r in recs if r.get("fallback_decode")),
            routed_dense=sum(1 for r in recs if r.get("routed_dense")),
            routes=routes, route_counts=route_counts,
            boundaries=plan.boundaries)

    # -- request path --------------------------------------------------------

    def submit(self, image) -> Request:
        """Enqueue one request (a (H, W, C) image, or (in_features,))."""
        return self.batcher.submit(image, submit_time=time.perf_counter())

    def _buffer(self, bucket: int) -> torch.Tensor:
        """The bucket's host staging buffer (pinned on the card), zeros at
        first."""
        if bucket not in self._stage:
            self._stage[bucket] = torch.zeros(
                self.plans[bucket].input_shape,
                pin_memory=self.device.type == "cuda")
        return self._stage[bucket]

    def stage(self, bucket: int, images: list) -> torch.Tensor:
        """The bucket's staging buffer holding ``images`` in its first rows
        and zeros in the rest (re-zeroed on every call, so no earlier
        batch's rows survive as padding)."""
        return pad_bucket(images, bucket, out=self._buffer(bucket))

    def forward(self, bucket: int, images: list) -> torch.Tensor:
        """Logits (len(images), classes) on the host of one padded batch:
        staged, copied into the bucket graph's static input, replayed with
        no host sync, the padding rows sliced off."""
        fn = self._compiled(bucket)
        x = self.stage(bucket, images)
        with _no_host_sync(self.device):
            y = fn(self.params, x)
        return y[:len(images)].cpu()

    def run_tick(self) -> list[Request]:
        """Drain this tick's queue through the bucket pipelines: routing,
        padding, replay, unpadding.  Completions carry their latency
        (submit → logits on the host) and tick.  Returns the requests
        completed this tick, in FIFO order."""
        t_tick0 = time.perf_counter()
        done: list[Request] = []
        while (batch := self.batcher.next_batch()) is not None:
            bucket, reqs = batch
            logits = self.forward(bucket, [r.image for r in reqs])
            now = time.perf_counter()
            for i, r in enumerate(reqs):
                r.result = logits[i]
                r.latency_s = now - r.submit_time
                r.completion_tick = self.batcher.tick
            if self.ttfr_s is None:
                self.ttfr_s = now - self._born
            done.extend(reqs)
        self.batcher.end_tick()
        self._serve_window += time.perf_counter() - t_tick0
        self.completed.extend(done)
        return done

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        """requests/s + p50/p99 latency, overall and per bucket."""
        lats = [r.latency_s for r in self.completed]
        per_bucket = {}
        for b in self.cfg.buckets:
            bl = [r.latency_s for r in self.completed if r.bucket == b]
            per_bucket[b] = dict(
                requests=len(bl),
                p50_ms=round(percentile(bl, 50) * 1e3, 3),
                p99_ms=round(percentile(bl, 99) * 1e3, 3))
        return dict(
            requests=len(lats),
            requests_s=round(len(lats) / max(self._serve_window, 1e-9), 2),
            p50_ms=round(percentile(lats, 50) * 1e3, 3),
            p99_ms=round(percentile(lats, 99) * 1e3, 3),
            per_bucket=per_bucket,
            recompiles=self.recompiles,
            warmup_s=self.warmup_s,
            ttfr_s=round(self.ttfr_s, 4) if self.ttfr_s is not None
            else None,
            devices=1 if self.mesh is None else self.mesh.size(),
            data_shards={b: p.data_shards for b, p in self.plans.items()})

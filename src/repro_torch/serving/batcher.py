"""Continuous batcher: a FIFO request queue routed into padded batch
buckets — port of ``repro.serving.batcher`` (a copy: the port imports
nothing of ``repro``).

The serving tier captures one pipeline per **bucket** shape (DESIGN.md
§10): a CUDA graph per batch size, since capturing per request batch
size would put a warm-up and a capture on the request path.  Requests
accumulate in a FIFO queue between ticks; each tick drains the queue head
into the *smallest admissible bucket* (the smallest captured batch size
that fits what is pending, capped at the largest bucket), pads the short
batch with all-zero rows, and hands the padded buffer to the bucket's
graph.

Padding is exact: a zero row rides the event pipeline as an event-free
stream (ReLU fires nothing), every block event's row group sums its own
rows' events in a fixed order with exact-zero terms for the rows that
hold none, and each output row of a multiply sums only its own row — so a
real row's logits are bitwise independent of what the padding rows hold.
The engine slices the padded rows back off before completing requests.

Fairness falls out of the head-of-queue policy: batches are always taken
from the front, so completion order is submission order (FIFO across
ticks) and no request starves behind later arrivals.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import torch

__all__ = ["DEFAULT_BUCKETS", "Request", "ContinuousBatcher",
           "smallest_bucket", "pad_bucket"]

#: The captured batch shapes: singles, small interactive batches, and two
#: throughput tiers.
DEFAULT_BUCKETS = (1, 8, 32, 128)


@dataclasses.dataclass
class Request:
    """One inference request riding the queue.

    ``submit_time`` (host clock at submission) and ``arrival_tick`` are
    stamped by the batcher; ``latency_s``, ``completion_tick`` and
    ``result`` by the engine on completion.
    """

    rid: int
    image: Any                         # (H, W, C) or (in_features,) array
    submit_time: float = 0.0
    arrival_tick: int = -1
    completion_tick: int = -1
    bucket: int = 0
    latency_s: float = 0.0
    result: Optional[Any] = None


def smallest_bucket(n: int, buckets: tuple) -> int:
    """Smallest captured bucket admitting ``n`` requests (n <= max bucket)."""
    assert n >= 1, n
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


def pad_bucket(images: list, bucket: int, *,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Stack ``images`` into a (bucket, ...) f32 CPU tensor, zero rows for
    the padding: they fire no event anywhere in the pipeline and their
    logits rows are sliced off before completion.  ``out``, a (bucket,
    ...) f32 buffer, is written in place (its padding rows re-zeroed, so
    no earlier batch survives there) and returned."""
    n = len(images)
    assert 1 <= n <= bucket, (n, bucket)
    if out is None:
        first = torch.as_tensor(images[0], dtype=torch.float32)
        out = torch.empty((bucket,) + tuple(first.shape),
                          dtype=torch.float32)
    assert out.shape[0] == bucket and out.dtype == torch.float32, \
        (tuple(out.shape), out.dtype, bucket)
    for i, img in enumerate(images):
        out[i].copy_(torch.as_tensor(img, dtype=torch.float32))
    out[n:].zero_()
    return out


class ContinuousBatcher:
    """FIFO queue + bucket routing (the policy half of the serving tier):
    host-side state only, so every invariant the tier relies on (smallest
    admissible bucket, FIFO across ticks, no starvation) is testable
    without a device."""

    def __init__(self, buckets: tuple = DEFAULT_BUCKETS, *,
                 max_batches_per_tick: int | None = None):
        assert buckets == tuple(sorted(set(buckets))) and len(buckets) > 0, \
            ("buckets must be sorted unique batch sizes", buckets)
        self.buckets = tuple(int(b) for b in buckets)
        self.max_batches_per_tick = max_batches_per_tick
        self._queue: deque[Request] = deque()
        self._next_rid = 0
        self.tick = 0

    # -- intake --------------------------------------------------------------

    def submit(self, image, *, submit_time: float = 0.0) -> Request:
        """Enqueue one request; returns the stamped Request."""
        req = Request(rid=self._next_rid, image=image,
                      submit_time=submit_time, arrival_tick=self.tick)
        self._next_rid += 1
        self._queue.append(req)
        return req

    def pending(self) -> int:
        return len(self._queue)

    # -- routing -------------------------------------------------------------

    def plan_tick(self, pending: int | None = None) -> list[tuple[int, int]]:
        """[(bucket, take)] decisions draining ``pending`` head-of-queue
        requests under this tick's batch budget — planning only, no state.
        Each step takes ``min(remaining, max_bucket)`` requests from the
        queue head and routes them to the smallest admissible bucket."""
        pending = self.pending() if pending is None else pending
        plan = []
        budget = self.max_batches_per_tick
        while pending > 0 and (budget is None or len(plan) < budget):
            take = min(pending, self.buckets[-1])
            plan.append((smallest_bucket(take, self.buckets), take))
            pending -= take
        return plan

    def next_batch(self) -> tuple[int, list[Request]] | None:
        """Pop the next (bucket, requests) batch off the queue head, or
        None.  FIFO: requests leave in arrival order, oldest first."""
        if not self._queue:
            return None
        take = min(len(self._queue), self.buckets[-1])
        bucket = smallest_bucket(take, self.buckets)
        reqs = [self._queue.popleft() for _ in range(take)]
        for r in reqs:
            r.bucket = bucket
        return bucket, reqs

    def end_tick(self) -> int:
        """Advance the tick counter (the engine calls this once per tick)."""
        self.tick += 1
        return self.tick

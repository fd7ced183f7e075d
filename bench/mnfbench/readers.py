"""Arithmetic the metrics' readers share (``metrics/*.py``)."""
from __future__ import annotations

from mnfbench import peaks
from mnfbench.records import Run, percentile

__all__ = ["latencies_ms", "latency_pct_ms", "p50_by_part_ms", "queue_waits_ms",
           "stage_mean_ms", "stretch_requests", "idle_pct", "mfu_pct",
           "roofline_pct", "kernels_per_request"]


def latencies_ms(run: Run) -> list:
    """Each served request's latency, from when it was due to its logits
    on the host (a closed loop's requests are due when submitted)."""
    return [1e3 * (r.done - r.due) for r in run.requests
            if r.done is not None]


def p50_by_part_ms(run: Run, parts: int) -> list:
    """The median latency of the requests due in each of ``parts`` equal
    parts of the window: whether the system held one level through it."""
    out = []
    for k in range(parts):
        lo = run.t0 + k * run.seconds / parts
        hi = lo + run.seconds / parts
        out.append(percentile([1e3 * (r.done - r.due) for r in run.requests
                               if r.done is not None and lo <= r.due < hi],
                              50))
    return out


def latency_pct_ms(run: Run, q: float) -> float | None:
    return percentile(latencies_ms(run), q)


def queue_waits_ms(run: Run) -> list | None:
    """From when each request was due to the start of its batch; None if
    a served request has no batch span (the span never fired)."""
    served = run.completed()
    if not served or any(r.batch is None for r in served):
        return None
    return [1e3 * (run.batches[r.batch].start - r.due) for r in served]


def stage_mean_ms(run: Run) -> float | None:
    """The mean staging span a batch; None if a request was served in no
    batch span or a batch has no staging span."""
    spans = [b.stage_s for b in run.batches]
    if not spans or None in spans \
            or any(r.batch is None for r in run.completed()):
        return None
    return 1e3 * sum(spans) / len(spans)


def stretch_requests(run: Run) -> int:
    p = run.profile
    if p is None or p["first_tick"] is None:
        return 0
    return sum(len(b.reqs) for b in run.batches
               if p["first_tick"] <= b.tick <= p["last_tick"])


def _traced(run: Run) -> bool:
    return run.profile is not None and run.profile["busy_s"] > 0


def idle_pct(run: Run) -> float | None:
    """The share of a tick in which the device does nothing, in percent:
    1 - (device busy time a tick, from the traced stretch) / (host time a
    tick, over the window's ticks before the stretch).  The host time is
    read before the profiler's first start in the run: once CUPTI is
    loaded every launch costs the host more, for the rest of the run.
    The device's busy time is read from the kernels' own intervals.  For
    a closed loop only, whose ticks carry equal work."""
    p = run.profile
    if run.loop != "closed" or not _traced(run) \
            or not p["first_tick"]:
        return None
    before = run.tick_spans[:p["first_tick"]]
    busy = p["busy_s"] / (p["last_tick"] - p["first_tick"] + 1)
    host = sum(b - a for a, b in before) / len(before)
    return 100.0 * (1.0 - busy / host)


def mfu_pct(run: Run) -> float | None:
    if not _traced(run) or run.work is None or run.work["flops"] <= 0:
        return None
    return 100.0 * run.work["flops"] / (run.profile["window_s"]
                                        * peaks.F32_FLOPS)


def roofline_pct(run: Run) -> float | None:
    if not _traced(run) or run.work is None or run.work["bound_s"] <= 0:
        return None
    return 100.0 * run.work["bound_s"] / run.profile["busy_s"]


def kernels_per_request(run: Run) -> float | None:
    n = stretch_requests(run)
    if not _traced(run) or n == 0:
        return None
    return run.profile["kernels"] / n

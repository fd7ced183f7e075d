"""The run's own records, which every metric's reader reads: one entry a
request, one a batch, the window's bounds, set-up, and what the traced
stretch found.  Times are ``time.perf_counter()`` seconds."""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Req", "Batch", "Run", "percentile"]


@dataclasses.dataclass
class Req:
    pool_idx: int            # the image it carries
    due: float               # when it was due (open loop: its arrival)
    submit: float | None = None  # the harness handed it to the system
    done: float | None = None    # the harness holds its logits on the host
    batch: int | None = None     # index into Run.batches (its span)
    logits: object = None        # (classes,) f32 host tensor


@dataclasses.dataclass
class Batch:
    """One batch's spans, on the harness's clock.  A span that never fired
    stays None, and a reader that needs it reads nothing."""
    start: float | None = None    # the system began to serve it
    end: float | None = None      # its logits on the host
    stage_s: float | None = None  # the staging span (pad and copy in)
    bucket: int | None = None     # the padded batch shape
    reqs: list = dataclasses.field(default_factory=list)   # Req, ...
    tick: int = -1


@dataclasses.dataclass
class Run:
    cell: str
    loop: str                # "closed" or "open"
    seconds: float
    trace: bool
    setup_s: float = 0.0
    t0: float = 0.0          # the window opens
    t_close: float = 0.0     # no request is due after this
    t_end: float = 0.0       # the last logits of the window on the host
    requests: list = dataclasses.field(default_factory=list)
    batches: list = dataclasses.field(default_factory=list)
    ticks: int = 0
    #: (start, end) of each tick of the window, harness clock
    tick_spans: list = dataclasses.field(default_factory=list)
    #: the traced stretch (``trace.reduce``'s dict) and the useful work of
    #: its requests (``work.stretch_work``'s dict); None untraced
    profile: dict | None = None
    work: dict | None = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    def completed(self) -> list:
        return [r for r in self.requests if r.done is not None]


def percentile(values, q: float) -> float | None:
    """q-th percentile (numpy's linear rule) of a sample, None if empty."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))

"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and drives a system through a window.  How
requests come is found by name, each in a file of its own:

- ``loop``: ``loops/<loop>.py``'s ``drive(window, traffic, seed,
  seconds)``.  ``closed``: before every tick exactly ``batch`` requests are
  submitted, and the next tick starts when the last one's logits are on
  the host (``batch`` 1 is one client, frame by frame); each request is
  due when it is submitted.  ``open``: requests are due on a schedule
  whatever the system does, are submitted at the first generator step
  after they are due (the lateness is recorded), each tick drains what is
  pending, and the run ends when every request due in the window has its
  logits, or a minute after the window closed.
- ``arrival`` (open loops): ``arrivals/<arrival>.py``'s ``offsets(traffic,
  seed, seconds)``, the due times in the window, sorted.

Parameters every mix has:

- ``buckets``: the batch shapes the system captures.
- ``warmup_s``: the same traffic runs that long, unrecorded, at the end of
  set-up: the host's first seconds under load ran ~12 % slower per frame
  on the card's machine, and the window opens after them.
- ``pool``: request images made from the seed; request i carries image
  ``order[i % pool]``.
- ``profile``: the traced stretch: ``{"skip_ticks": s, "ticks": n}`` (the
  ticks s .. s+n-1 of the window) or ``{"last_s": x}`` (from the first
  tick that starts x seconds before the window closes to the end).
"""
from __future__ import annotations

import time

import numpy as np

from mnfbench import spec
from mnfbench.records import Req, Run

__all__ = ["Window", "schedule", "drive"]

clock = time.perf_counter


def schedule(traffic: dict, seed: int, seconds: float) -> np.ndarray:
    """Due offsets (s) of an open loop's window, sorted; empty where the
    mix names no arrival process (a closed loop)."""
    if "arrival" not in traffic:
        return np.zeros(0)
    return np.asarray(spec.arrival(traffic["arrival"])(traffic, seed,
                                                        seconds), np.float64)


class Window:
    """What a loop drives the system with.  ``submit(due)`` hands the next
    request to the system (due when submitted, if ``due`` is None);
    ``tick()`` runs one tick and records its span (from the first
    submission since the last tick to the tick's return); ``pending()``
    counts requests submitted and not yet returned."""

    def __init__(self, system, rec: Run, pool, order, stretch=None):
        self.system, self.rec, self.stretch = system, rec, stretch
        self.pool, self.order = pool, order
        self.ticks = 0
        self._cycle = None

    def open(self, seconds: float) -> None:
        self.rec.t0 = clock()
        self.rec.t_close = self.rec.t0 + seconds

    def submit(self, due: float | None = None) -> None:
        i = len(self.rec.requests)
        j = int(self.order[i % len(self.order)])
        req = Req(pool_idx=j, due=0.0)
        if self._cycle is None:
            self._cycle = clock()
        self.system.submit(req, self.pool[j])
        req.due = req.submit if due is None else due
        self.rec.requests.append(req)

    def pending(self) -> int:
        return self.system.pending()

    def tick(self) -> None:
        t = clock() if self._cycle is None else self._cycle
        if self.stretch is not None:
            self.stretch.before_tick(self.ticks)
        self.system.run_tick(self.ticks)
        self.rec.tick_spans.append((t, clock()))
        if self.stretch is not None:
            self.stretch.after_tick(self.ticks)
        self._cycle = None
        self.ticks += 1

    def close(self) -> None:
        if self.stretch is not None:
            self.stretch.finish()
        self.rec.ticks = self.ticks
        done = [r.done for r in self.rec.requests if r.done is not None]
        self.rec.t_end = max(done) if done else clock()


def drive(system, rec: Run, traffic: dict, pool, order, seed: int,
          seconds: float, stretch=None) -> None:
    """Run the window: requests into ``rec.requests``; ``stretch``
    (``trace.Stretch``) is told each tick's start and end."""
    win = Window(system, rec, pool, order, stretch)
    spec.loop(traffic["loop"])(win, traffic, seed, seconds)
    win.close()

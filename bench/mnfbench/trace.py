"""The traced stretch of a window: ``torch.profiler`` (CUPTI on the card)
over a fixed run of ticks, and its reduction to what the device did.

The arithmetic follows the port's ``chip_smoke.profile()`` (device
events by name from ``prof.events()``), with the busy time taken as
the union of the device's kernel and copy intervals rather than their
sum, so overlapping work is not counted twice:

- ``busy_s``: the union of device intervals inside the stretch;
- ``window_s``: the stretch's length on the host's clock, from a
  synchronised start to a synchronised stop;
- ``kernels``: device kernels launched (copies and memsets apart);
  the benchmark's own ranges, which the profiler mirrors on the
  device's timeline, are no device work and are left out;
- ``device_ops``: device seconds by name, the 10 largest;
- ``idle_gaps``: the device's idle time inside the stretch by what the
  host was doing at each gap's middle (the benchmark's innermost
  ``bench.*`` span, and the innermost host op under it), the 10
  largest.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Stretch", "reduce"]

clock = time.perf_counter
_COPY = ("Memcpy", "Memset", "memcpy", "memset")


class Stretch:
    """Starts and stops the profiler at tick boundaries, as the traffic's
    ``profile`` says; records the ticks it covered."""

    def __init__(self, spec: dict, rec, device: torch.device):
        self.spec, self.rec, self.device = spec, rec, device
        self.prof = None
        self.first_tick = self.last_tick = None
        self.t_start = self.t_stop = 0.0
        self._rf = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _due(self, tick: int) -> bool:
        if "skip_ticks" in self.spec:
            return tick >= self.spec["skip_ticks"]
        return clock() >= self.rec.t_close - self.spec["last_s"]

    def before_tick(self, tick: int) -> None:
        if self.prof is not None or self.first_tick is not None \
                or not self._due(tick):
            return
        self.prof = start(self.device)
        self._sync()
        self._rf = torch.profiler.record_function("bench.stretch")
        self._rf.__enter__()
        self.first_tick = tick
        self.t_start = clock()

    def after_tick(self, tick: int) -> None:
        if self.prof is None or self.stopped:
            return
        self.last_tick = tick
        if "ticks" in self.spec and \
                tick >= self.first_tick + self.spec["ticks"] - 1:
            self.stop()

    @property
    def stopped(self) -> bool:
        return self.t_stop != 0.0

    def stop(self) -> None:
        self._sync()
        self.t_stop = clock()
        self._rf.__exit__(None, None, None)
        self.prof.stop()

    def finish(self) -> None:
        if self.prof is not None and not self.stopped:
            self.stop()


def start(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _short(name: str) -> str:
    return name.split("(")[0].replace("void ", "").strip()[:64]


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge (n, 2) intervals sorted by start into disjoint ones."""
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, np.float64).reshape(-1, 2)


def reduce(stretch: Stretch) -> dict | None:
    """What the device did in the stretch; None if nothing was traced."""
    if stretch.prof is None:
        return None
    dev_type = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    lo = hi = None
    for e in stretch.prof.events():
        tr = e.time_range
        if e.device_type == dev_type:
            # a host range mirrored on the device's timeline is no work
            if not getattr(e, "is_user_annotation", False) \
                    and not e.name.startswith("bench."):
                dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
            if e.name == "bench.stretch":
                lo, hi = tr.start, tr.end
    out = dict(window_s=stretch.t_stop - stretch.t_start, busy_s=0.0,
               kernels=0, device_ops=[], idle_gaps=[],
               first_tick=stretch.first_tick, last_tick=stretch.last_tick)
    if not dev:
        return out
    if lo is None:
        lo = min(a for a, _, _ in dev)
        hi = max(b for _, b, _ in dev)
    by_name: dict = {}
    for a, b, name in dev:
        n = _short(name)
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    out["kernels"] = sum(1 for *_, name in dev
                         if not name.startswith(_COPY))
    out["device_ops"] = [[n, s] for n, s in
                         sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    iv = np.asarray(sorted((max(a, lo), min(b, hi)) for a, b, _ in dev
                           if b > lo and a < hi), np.float64).reshape(-1, 2)
    busy = _union(iv)
    out["busy_s"] = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6
    edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    hs = np.asarray([h[0] for h in host], np.float64)
    he = np.asarray([h[1] for h in host], np.float64)
    names = [h[2] for h in host]
    bench = np.asarray([n.startswith("bench.") and n != "bench.stretch"
                        for n in names], bool)
    idle: dict = {}
    for a, b in gaps:
        m = 0.5 * (a + b)
        inside = (hs <= m) & (he >= m)
        label = "none"
        if inside.any():
            idx = np.flatnonzero(inside)
            inner = idx[np.argmax(hs[idx])]
            label = names[inner]
            bidx = idx[bench[idx]]
            if len(bidx):
                outer = names[bidx[np.argmax(hs[bidx])]]
                if outer != label:
                    label = f"{outer}>{label}"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    out["idle_gaps"] = [[n, s] for n, s in
                        sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
    return out

"""Occupancy-adaptive routing: the event-vs-dense decision per boundary
(DESIGN.md §11) — port of ``repro.costmodel.crossover``.

``decide_route`` is the one decision point the engine's ``route_*``
functions call.  Under ``route="auto"`` it routes by geometry alone (the
event path whenever one exists); under "adaptive" it takes the argmin of
the event and dense costs at the static occupancy hint; any other mode
forces a route.  Two cost sources, in authority order:

  * a measured ``CrossoverTable`` — ``kind == "crossover"`` entries of a
    benchmark file, read by ``load_crossover_table`` and installed
    explicitly with ``set_active_table`` (the engine never reads a file
    on its own; ``launch.serve --route adaptive --bench FILE`` does it);
  * the analytic seed (``boundary_costs``, the paper's cycle models),
    used where no table covers the boundary and always recorded in the
    ``est_*_cost`` trace fields.

The table a file gives is what was measured where it says (its
``device`` field): ``BENCH_engine.json``'s entries are CPU interpret-mode
times of the JAX package, not an H100 calibration.  ``route_conflicts``
is the gate that holds served routes against a table, with the
``ROUTE_HYSTERESIS`` band around ratio 1.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.costmodel.accelerators import (PAPER_HW, dense_layer_cycles,
                                                mnf_layer_cycles)

__all__ = ["ROUTE_HYSTERESIS", "EVENT_ROUTES", "LAUNCH_OVERHEAD_CYCLES",
           "RouteDecision", "CrossoverTable", "active_table",
           "boundary_costs", "decide_route", "linear_shape_class",
           "load_crossover_table", "route_conflicts", "set_active_table"]

#: Tolerance band of the route-vs-table gate (``route_conflicts``): a route
#: is against the table only when the measured event/dense ratio at its
#: occupancy leaves [1/(1+h), 1+h] on the losing side.  Decisions take the
#: argmin; the band keeps near-crossover boundaries from flapping on
#: timing noise.
ROUTE_HYSTERESIS = 0.25

#: Route labels that consume the event stream; "dense" consumes the twin.
EVENT_ROUTES = ("strip", "pixel", "window", "event")

#: Per-launch overhead of the event path in model cycles (seed model only).
LAUNCH_OVERHEAD_CYCLES = 64.0


def linear_shape_class(m: int, k: int, n: int) -> str:
    """FC boundary shape class: output width and a power-of-two K bucket."""
    kb = 1 << max(int(k) - 1, 0).bit_length()
    return f"n{n}kb{kb}"


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One boundary's route plus the estimates that explain it; ``source``
    is "forced" | "geometry" | "table" | "model"."""

    route: str
    est_event_cost: float
    est_dense_cost: float
    occupancy: float
    ratio: float
    source: str

    @property
    def is_event(self) -> bool:
        return self.route in EVENT_ROUTES


def boundary_costs(kind: str, occupancy: float, *, dense_macs: float,
                   avg_touched: float, c_out: int,
                   hw=PAPER_HW) -> tuple[float, float]:
    """Analytic (event_cycles, dense_cycles) seed for one boundary."""
    occ = min(max(float(occupancy), 0.0), 1.0)
    in_elems = dense_macs / max(avg_touched * c_out, 1e-9)
    ev = mnf_layer_cycles(occ * in_elems, avg_touched, c_out, hw)
    return ev + LAUNCH_OVERHEAD_CYCLES, dense_layer_cycles(dense_macs, hw)


class CrossoverTable:
    """Measured event/dense time ratios per (boundary, backend, shape
    class, event flavor), interpolated piecewise-linearly in occupancy.
    Built from ``kind == "crossover"`` entries of a benchmark file; keys
    fall back most-specific first.  ``device`` names where the entries
    were measured (None: not stated), ``entries`` how many were used."""

    def __init__(self, entries: list[dict], *, device: str | None = None):
        self.device = device
        self.entries = 0
        buckets: dict[tuple, dict[float, list[float]]] = {}
        for e in entries:
            if e.get("kind") != "crossover":
                continue
            us = e.get("us") or {}
            dense = us.get("dense")
            flavors = {r: v for r, v in us.items()
                       if r in EVENT_ROUTES and v is not None}
            if not dense or not flavors:
                continue
            self.entries += 1
            ratios = {None: min(flavors.values()) / dense}
            ratios.update({r: v / dense for r, v in flavors.items()})
            occ = round(float(e.get("occupancy", 1.0)), 6)
            keys = [(e.get("boundary"),)]
            if e.get("backend"):
                keys.append((e.get("boundary"), e.get("backend")))
                if e.get("shape_class"):
                    keys.append((e.get("boundary"), e.get("backend"),
                                 e.get("shape_class")))
            for key in keys:
                for flavor, ratio in ratios.items():
                    buckets.setdefault((key, flavor), {}).setdefault(
                        occ, []).append(ratio)
        self._curves = {key: sorted((o, sum(rs) / len(rs))
                                    for o, rs in anchors.items())
                        for key, anchors in buckets.items()}

    def __len__(self) -> int:
        return len(self._curves)

    def ratio(self, boundary: str, occupancy: float, *,
              backend: str | None = None, shape_class: str | None = None,
              flavor: str | None = None) -> float | None:
        """Interpolated event/dense ratio; None = no coverage."""
        flavors = (flavor, None) if flavor is not None else (None,)
        for key in ((boundary, backend, shape_class), (boundary, backend),
                    (boundary,)):
            if None in key[1:]:
                continue
            for fl in flavors:
                curve = self._curves.get((key, fl))
                if curve:
                    return _interp(curve, float(occupancy))
        return None


def _interp(curve: list[tuple[float, float]], x: float) -> float:
    if x <= curve[0][0]:
        return curve[0][1]
    for (x0, y0), (x1, y1) in zip(curve, curve[1:]):
        if x <= x1:
            return y0 + (x - x0) / max(x1 - x0, 1e-12) * (y1 - y0)
    return curve[-1][1]


def load_crossover_table(path: str) -> CrossoverTable:
    """The table of a benchmark file (an empty table if the file is
    absent): the raw entry list, or the ``{"device": ..., "entries":
    [...]}`` wrapper, whose ``device`` the table keeps."""
    if not os.path.exists(path):
        return CrossoverTable([])
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        return CrossoverTable(data.get("entries", []),
                              device=data.get("device"))
    return CrossoverTable(data)


#: Process-global table consulted by adaptive dispatch (None = seed only).
_ACTIVE_TABLE: CrossoverTable | None = None


def set_active_table(table: CrossoverTable | None) -> CrossoverTable | None:
    """Install (or clear) the process-global table; returns the previous."""
    global _ACTIVE_TABLE
    prev, _ACTIVE_TABLE = _ACTIVE_TABLE, table
    return prev


def active_table() -> CrossoverTable | None:
    return _ACTIVE_TABLE


def decide_route(mode: str, boundary: str, *, occupancy: float | None,
                 event_route: str | None, dense_macs: float,
                 avg_touched: float, c_out: int, backend: str | None = None,
                 shape_class: str | None = None,
                 table: CrossoverTable | None = None) -> RouteDecision:
    """Route one boundary.  ``event_route`` is the event flavor geometry
    allows (None = no event path: dense whatever the mode)."""
    occ = 1.0 if occupancy is None else min(max(float(occupancy), 0.0), 1.0)
    est_ev, est_de = boundary_costs(boundary, occ, dense_macs=dense_macs,
                                    avg_touched=avg_touched, c_out=c_out)
    tab = table if table is not None else _ACTIVE_TABLE
    flavor = event_route if event_route in EVENT_ROUTES else None
    t_ratio = tab.ratio(boundary, occ, backend=backend,
                        shape_class=shape_class, flavor=flavor) if tab \
        else None
    ratio = t_ratio if t_ratio is not None else est_ev / max(est_de, 1e-12)
    if event_route is None:
        route, source = "dense", "geometry"
    elif mode == "auto":
        route, source = event_route, "geometry"
    elif mode == "adaptive":
        route = "dense" if ratio > 1.0 else event_route
        source = "table" if t_ratio is not None else "model"
    else:
        route = event_route if mode == "event" else mode
        source = "forced"
    return RouteDecision(route=route, est_event_cost=est_ev,
                         est_dense_cost=est_de, occupancy=occ,
                         ratio=float(ratio), source=source)


def route_conflicts(records: list[dict], table: CrossoverTable, *,
                    hysteresis: float = ROUTE_HYSTERESIS) -> list[dict]:
    """Routes that contradict ``table`` beyond the hysteresis band: a trace
    record routed onto the event path while the table says dense wins by
    more than the band (ratio > 1 + h), or routed dense (not a visible
    fallback) while events win by more than it (ratio < 1 / (1 + h)).
    Records the table does not cover are never conflicts (the analytic
    seed owns them).  Each conflict is its record plus ``table_ratio``."""
    out = []
    for r in records:
        route = r.get("route")
        if route is None or r.get("occupancy") is None:
            continue
        boundary = {"conv2d": "conv", "maxpool2d": "pool",
                    "linear": "linear"}.get(r.get("op"))
        if boundary is None:
            continue
        event_taken = route in EVENT_ROUTES
        ratio = table.ratio(boundary, float(r["occupancy"]),
                            backend=r.get("backend"),
                            shape_class=r.get("shape_class"),
                            flavor=route if event_taken else None)
        if ratio is None:
            continue
        if (event_taken and ratio > 1.0 + hysteresis) or \
                (not event_taken and not r.get("fallback_decode")
                 and ratio < 1.0 / (1.0 + hysteresis)):
            out.append(dict(r, table_ratio=ratio))
    return out

"""Occupancy-adaptive routing: the event-vs-dense decision per boundary
(DESIGN.md §11) — port of ``repro.costmodel.crossover``.

``decide_route`` is the one decision point the engine's ``route_*``
functions call.  Under ``route="auto"`` it routes by geometry alone (the
event path whenever one exists); under "adaptive" it compares the analytic
seed (or an installed measured ``CrossoverTable``) at the static occupancy
hint; any other mode forces a route.  No H100 table exists yet (ROADMAP:
routing calibration), so adaptive routing runs on the analytic seed.
"""
from __future__ import annotations

import dataclasses

from repro_torch.costmodel.accelerators import (PAPER_HW, dense_layer_cycles,
                                                mnf_layer_cycles)

__all__ = ["EVENT_ROUTES", "LAUNCH_OVERHEAD_CYCLES", "RouteDecision",
           "CrossoverTable", "active_table", "boundary_costs",
           "decide_route", "linear_shape_class", "set_active_table"]

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
    fall back most-specific first."""

    def __init__(self, entries: list[dict]):
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

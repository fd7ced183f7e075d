"""What a cell is made of, found by name: ``BENCHMARK.json`` names the
cell's configuration, traffic mix and metrics; each lives in a file of
its own under the benchmark's folder.

- ``configs/<config>.json``: the network's sizes, how its weights and
  inputs are drawn, and the limit of the comparison that decides
  ``correct``; its ``reference`` names the plain forward beside it
  (``configs/<reference>.py``), and its ``system`` the adapter that
  drives the program (``systems/<system>.py``'s ``System``).
- ``traffic/<mix>.json``: the parameters of one traffic mix, read by the
  one general generator (:mod:`mnfbench.loads`); its ``loop`` names
  ``loops/<loop>.py`` and an open loop's ``arrival``
  ``arrivals/<arrival>.py``.
- ``metrics/<metric>.py``: one reader a metric, ``read(run) -> float |
  None`` over the run's own records (:mod:`mnfbench.records`).

A new cell, configuration, mix or metric is new files and entries; no
file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    moves: str | None = None
    workloads: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple       # Metric, ...
    per_layer: tuple        # Metric, ...


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_config(name: str) -> dict:
    cfg = load_json(BENCH_DIR / "configs" / f"{name}.json")
    cfg.setdefault("name", name)
    return cfg


def load_traffic(name: str) -> dict:
    t = load_json(BENCH_DIR / "traffic" / f"{name}.json")
    t.setdefault("name", name)
    return t


_MODULES: dict = {}


def _module(path: pathlib.Path, name: str):
    """The module in ``path``, loaded once a process."""
    if path in _MODULES:
        return _MODULES[path]
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _MODULES[path] = mod
    return mod


def _found(folder: str, name: str):
    return _module(BENCH_DIR / folder / f"{name}.py",
                   f"mnfbench_{folder}_" + name.replace(".", "_"))


def reader(metric: str):
    """The metric's reader: ``metrics/<metric>.py``'s ``read``."""
    return _found("metrics", metric).read


def reference(name: str):
    """The plain reference module a configuration names
    (``configs/<name>.py``)."""
    return _found("configs", name)


def system(name: str):
    """The system class a configuration names (``systems/<name>.py``'s
    ``System``): ``System(cfg, params, buckets, device, rec)``."""
    return _found("systems", name).System


def loop(name: str):
    """A mix's loop (``loops/<name>.py``'s ``drive``)."""
    return _found("loops", name).drive


def arrival(name: str):
    """An open loop's arrival process (``arrivals/<name>.py``'s
    ``offsets``)."""
    return _found("arrivals", name).offsets


def _metrics(entries: list) -> list:
    return [Metric(name=m["name"], unit=m["unit"], moves=m.get("moves"),
                   workloads=tuple(m["workloads"]) if "workloads" in m
                   else None)
            for m in entries]


def cell_metrics(bench: dict, cell: str) -> tuple[tuple, tuple]:
    """The end-to-end and per-layer metrics a cell reports: each that
    lists the cell under ``workloads``, or has no such key (a per-layer
    metric without one goes with every cell that reports what it
    moves)."""
    e2e = [m for m in _metrics(bench["end_to_end"])
           if m.workloads is None or cell in m.workloads]
    names = {m.name for m in e2e}
    per = [m for m in _metrics(bench["per_layer"])
           if (cell in m.workloads if m.workloads is not None
               else m.moves in names)]
    return tuple(e2e), tuple(per)


def resolve(cell: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``cell`` in ``BENCHMARK.json``, its files loaded."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == cell]
    if not found:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json "
                       f"({[w['name'] for w in bench['workloads']]})")
    w = found[0]
    e2e, per = cell_metrics(bench, cell)
    return Cell(name=cell, config=load_config(w["config"]),
                traffic=load_traffic(w["traffic"]), chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per)

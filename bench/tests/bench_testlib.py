"""Shared by the benchmark's CPU tests: the harness on ``sys.path``, and a
tiny cell that runs on the CPU in a second (the port's ``block`` backend
in place of the card)."""
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from mnfbench import spec  # noqa: E402

#: conv→conv, conv→pool→conv and conv→FC seams, as the port's MINI
TINY_LAYERS = [
    {"kind": "conv", "out": 8, "k": 3, "stride": 1, "padding": 1},
    {"kind": "conv", "out": 8, "k": 3, "stride": 1, "padding": 1},
    {"kind": "pool", "k": 2, "stride": 2},
    {"kind": "conv", "out": 8, "k": 3, "stride": 1, "padding": 1},
    {"kind": "fc", "out": 10},
]


def tiny_config(base: str = "vgg16_224") -> dict:
    """``base``'s configuration (its reference, precision, sparsities and
    limit) on an 8x8 net."""
    cfg = spec.load_config(base)
    return dict(cfg, name="tiny", input_size=8, layers=TINY_LAYERS,
                num_classes=10)


def tiny_cell(cell: str = "vgg16_224.offline", *, batch: int = 4,
              base: str = "vgg16_224") -> spec.Cell:
    """``cell``'s traffic and metrics on the tiny net, a pool of 16 images,
    a closed loop's batch cut to ``batch`` (one bucket) or an open loop's
    buckets to (1, 2, 4)."""
    bench = spec.benchmark()
    w = [w for w in bench["workloads"] if w["name"] == cell][0]
    t = dict(spec.load_traffic(w["traffic"]), pool=16, warmup_s=0.2)
    if t["loop"] == "closed":
        t.update(batch=batch, buckets=[batch],
                 profile={"skip_ticks": 0, "ticks": 2})
    else:
        t.update(rate_per_s=100.0, buckets=[1, 2, 4],
                 profile={"last_s": 0.2})
    e2e, per = spec.cell_metrics(bench, cell)
    return spec.Cell(cell, tiny_config(base), t, 1, e2e, per)

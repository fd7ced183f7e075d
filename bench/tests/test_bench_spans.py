"""The benchmark's clock and spans: every time is the harness's own, each
span fires on every batch of a run of the port, and a reader whose span
never fired reads nothing rather than a wrong number."""
import types

import pytest

from bench_testlib import tiny_cell
from mnfbench import cell as cell_mod
from mnfbench import readers, spec
from mnfbench.records import Run

SECONDS = 0.3
CELLS = ["vgg16_224.offline", "vgg16_224.server", "alexnet_224.stream"]


def run(cell, make_system=None, seed=2**31 + 5):
    return cell_mod.run_cell(cell, seed, SECONDS, False, device="cpu",
                             make_system=make_system)


@pytest.mark.parametrize("cell", CELLS)
def test_every_span_fires_on_every_batch(cell):
    got = run(tiny_cell(cell, base=cell.split(".")[0]))
    rec, out = got["run"], got["result"]
    assert out["correct"] and rec.batches
    for r in rec.requests:
        assert r.submit is not None and r.done is not None
        assert r.batch is not None and r in rec.batches[r.batch].reqs
        assert r.due <= r.submit <= rec.batches[r.batch].start <= r.done
    for b in rec.batches:
        assert None not in (b.start, b.end, b.stage_s, b.bucket), b
        assert b.bucket in tiny_cell(cell).traffic["buckets"]
        assert b.start <= b.end
    assert "none" not in out["traffic"]["buckets"]
    assert sum(out["traffic"]["buckets"].values()) == len(rec.batches)
    assert len(rec.tick_spans) == rec.ticks > 0
    for name in ("stage_ms.offline", "queue_wait_p95_ms.server"):
        assert spec.reader(name)(rec) is not None


def test_latencies_do_not_read_the_programs_clock(monkeypatch):
    """With the engine's clock frozen at 0 its own stamps say nothing;
    the benchmark's latencies are unchanged in kind."""
    from repro_torch.serving import server

    monkeypatch.setattr(server, "time",
                        types.SimpleNamespace(perf_counter=lambda: 0.0))
    got = run(tiny_cell("vgg16_224.server"))
    rec = got["run"]
    assert got["result"]["correct"]
    lat = readers.latencies_ms(rec)
    assert len(lat) == len(rec.requests) and min(lat) > 0
    assert got["result"]["metrics"]["latency_p95_ms"]["value"] > 0


def test_a_span_that_never_fires_reads_nothing():
    """A program that no longer serves through ``forward`` (the spans'
    hook) still has its end-to-end metrics read and judged; the
    per-layer readers that need the spans read nothing."""
    base = spec.system("cnn_serve")

    class Unhooked(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.eng.forward = type(self.eng).forward.__get__(self.eng)

    got = run(tiny_cell("vgg16_224.server"), Unhooked)
    rec, out = got["run"], got["result"]
    assert out["correct"] and not rec.batches
    assert out["metrics"]["latency_p95_ms"]["value"] > 0
    for name in ("stage_ms.offline", "queue_wait_p95_ms.server"):
        assert spec.reader(name)(rec) is None


def test_a_missing_stage_span_reads_nothing():
    rec = run(tiny_cell("vgg16_224.offline"))["run"]
    assert readers.stage_mean_ms(rec) is not None
    rec.batches[-1].stage_s = None
    assert readers.stage_mean_ms(rec) is None


def test_idle_share_reads_host_time_before_the_stretch():
    rec = Run(cell="c", loop="closed", seconds=1.0, trace=True)
    # ticks 0-1 untraced at 10 ms, 2-3 traced and 4 after the stretch
    # slower (the profiler's cost on the host); device busy 8 ms a tick
    rec.tick_spans = [(0.0, 0.010), (0.010, 0.020), (0.020, 0.040),
                      (0.040, 0.060), (0.060, 0.072)]
    rec.profile = dict(busy_s=0.016, window_s=0.040, first_tick=2,
                       last_tick=3, kernels=10)
    assert readers.idle_pct(rec) == pytest.approx(20.0)
    rec.profile["first_tick"], rec.profile["last_tick"] = 0, 1
    assert readers.idle_pct(rec) is None
    rec.loop = "open"
    assert readers.idle_pct(rec) is None

"""The port's roofline rows (``benchmarks/torch_roofline_table.py``)
against the JAX harness's (``benchmarks/roofline_table.py``): records of
each status the port's dry run writes (``repro_torch.launch.dryrun``:
ok, skipped, error), in a temporary directory that each module reads as
its own ``RESULTS``, give identical rows, and ``benchmarks.torch_run``
prints them; an empty directory gives the row naming the port's dry
run."""
import contextlib
import importlib
import io
import json
import pathlib
import sys

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, roofline

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, str(ROOT))
    try:
        yield (importlib.import_module("benchmarks.roofline_table"),
               importlib.import_module("benchmarks.torch_roofline_table"),
               importlib.import_module("benchmarks.torch_run"))
    finally:
        sys.path.remove(str(ROOT))


def _ok_record(arch, shape_name, mesh, chips, tag=""):
    """A record as ``dryrun.run_cell`` writes one for a traced cell."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    cost = roofline.Cost(flops=3.1e15, bytes=2.7e12, aten_flops=3.0e15,
                         aten_bytes=2.6e12,
                         kernels={"mamba_scan_fused": [64, 1e9, 2e9]},
                         collectives={"all-reduce": [48, 9.5e10]})
    mem = dict(temp=31 * 2**30, args=7 * 2**30, output=6 * 2**30, alias=0)
    rep = roofline.analyze(arch, cfg, shape, mesh, chips, cost,
                           mem["temp"] + mem["args"] + mem["output"])
    return dict(arch=arch, shape=shape_name, mesh=mesh, tag=tag,
                status="ok", lower_s=17.8, compile_s=0.0, memory=mem,
                roofline=rep.to_json(), kernels=cost.kernels,
                collectives=cost.collectives, collective_shapes={},
                flops_by_op={"aten.mm": 2.9e15})


def _records(tmp_path):
    # a skipped cell, written by the dry run itself (no trace)
    dryrun.run_cell("qwen2-0.5b", "long_500k", out_dir=str(tmp_path),
                    verbose=False)
    recs = [_ok_record("hymba-1.5b", "train_4k", "16x16", 256),
            _ok_record("qwen2-1.5b", "train_4k", "2x16x16", 512,
                       tag="fsdp"),
            dict(arch="gemma2-27b", shape="decode_32k", mesh="16x16",
                 tag="", status="error",
                 error="RuntimeError: " + "x" * 120,
                 traceback="Traceback (most recent call last): ...")]
    for rec in recs:
        suffix = f"__{rec['tag']}" if rec["tag"] else ""
        (tmp_path / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
                    f"{suffix}.json").write_text(json.dumps(rec))


def test_port_rows_equal_the_jax_harness_rows(bench, tmp_path,
                                              monkeypatch):
    jmod, tmod, run = bench
    _records(tmp_path)
    monkeypatch.setattr(jmod, "RESULTS", str(tmp_path))
    monkeypatch.setattr(tmod, "RESULTS", str(tmp_path))
    want, got = jmod.rows(), tmod.rows()
    assert got == want
    derived = [d for _, _, d in got]
    assert len(got) == 4
    assert sum(d.startswith("skipped:") for d in derived) == 1
    assert sum(d.startswith("ERROR:") for d in derived) == 1
    assert sum(d.startswith("bottleneck=") for d in derived) == 2
    assert any(n.endswith("_fsdp") for n, _, _ in got)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run.main()
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("roofline_")]
    assert lines == [f"{n},{us:.1f},{d}" for n, us, d in want]


def test_no_records_names_the_ports_dry_run(bench, tmp_path, monkeypatch):
    _, tmod, _ = bench
    monkeypatch.setattr(tmod, "RESULTS", str(tmp_path))
    (row,) = tmod.rows()
    assert row[0] == "roofline_table" and row[1] == 0.0
    assert "python -m repro_torch.launch.dryrun" in row[2]

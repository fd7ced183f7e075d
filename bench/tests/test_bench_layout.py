"""BENCHMARK.json against the benchmark's files: every cell resolves to
its configuration and traffic, every metric to its reader, and every name
keeps to the contract's characters."""
import ast
import json
import re

import pytest

from bench_testlib import BENCH, ROOT
from mnfbench import spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["bench"]
    assert BENCHMARK["command"][1] == "bench/run.py"
    assert (ROOT / BENCHMARK["command"][1]).is_file()
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_resolves(cell):
    c = spec.resolve(cell)
    assert c.chips == 1
    assert (BENCH / "configs" / f"{c.config['reference']}.py").is_file()
    for key in ("loop", "buckets", "pool", "profile"):
        assert key in c.traffic
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m.moves in e2e, (m.name, m.moves)
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m.name))


def test_entries_keep_to_the_contract():
    names = []
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert spec.load_config(c["name"])["source"] == c["source"]
        names.append(c["name"])
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names
        assert w["name"] == f"{w['config']}.{w['name'].split('.', 1)[1]}"
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCHMARK["configs"] + BENCHMARK["workloads"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for m in BENCHMARK["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in BENCHMARK[k]]
    assert len(all_names) == len(set(all_names))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path


def test_only_the_port_adapter_imports_the_program():
    """The yardstick (references, traffic, counting, verdict, readers)
    imports nothing of repro_torch."""
    for path in BENCH.rglob("*.py"):
        rel = path.relative_to(BENCH)
        if rel.parts[0] in ("tests", "systems") or rel.as_posix() == "run.py":
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "repro_torch" not in tops, rel


def test_forbidden_modules_seen_by_whole_top_level_name():
    import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.serving",
                                  "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["repro.models", "jaxlib.xla_client",
                                  "repro_torch"]) == ["jaxlib", "repro"]

"""The examples of the paper's workload run as scripts on the CPU:

- ``examples/torch_serve_cnn_events.py --device cpu`` exits 0 at its
  defaults and prints the served frames and the priced row;
- ``examples/torch_quickstart.py --device cpu`` exits 0.

(``tests/test_torch_paper_workloads.py`` holds their bodies against the
JAX package.)
"""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.mark.parametrize("name", ["torch_serve_cnn_events",
                                  "torch_quickstart"])
def test_example_runs_on_cpu(name):
    res = subprocess.run([sys.executable, f"examples/{name}.py", "--device",
                          "cpu"], cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    if name == "torch_serve_cnn_events":
        assert "served 16 frames" in res.stdout
        assert "modeled on MNF ASIC (Table 3 hw)" in res.stdout
    else:
        assert "multiply phase == dense: True" in res.stdout

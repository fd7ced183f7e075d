"""The paper's workload in the port, end to end on the CPU, against the JAX
package's: synthetic data, AlexNet's boundary plan, its event accounting
and the priced example.

- ``data.synthetic``: ``cnn_batch``, ``lm_batch`` and ``markov_lm_batch``
  bitwise the JAX package's (the same numpy draws), on the device asked;
- ``chain_boundary_summary(ALEXNET, batch=b)`` at 224 for b in (1, 4, 8):
  every count and every route record the JAX package's;
- ``run_with_stats`` on ALEXNET.scaled(64) with JAX's weights
  (``params_from_numpy``) on a ``cnn_batch`` frame: every count exactly
  JAX's, the logits within 5e-3 (the tolerance of the JAX package's own
  run_with_stats test);
- ``examples/torch_serve_cnn_events.py``: at its defaults with
  ``--device cpu`` it exits 0; with JAX's weights its priced row is
  ``table4_row`` of JAX's stats of the same frame, exactly;
- ``examples/torch_quickstart.py --device cpu`` exits 0.
"""
import functools
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.costmodel import network_cycles as jnetwork_cycles
from repro.costmodel import table4_row as jtable4_row
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro_torch import data as tdata
from repro_torch.costmodel import network_cycles, table4_row
from repro_torch.data import synthetic as tsyn
from repro_torch.models import cnn as tcnn

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

def test_data_exports():
    assert tdata.__all__ == ["TokenStreamConfig", "cnn_batch", "lm_batch",
                             "markov_lm_batch"]
    assert tsyn.__all__ == jsyn.__all__


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.6, 0.95])
@pytest.mark.parametrize("batch,size,ch,step,seed", [(1, 64, 3, 0, 0),
                                                     (2, 8, 5, 7, 3),
                                                     (4, 17, 1, 123, 11)])
def test_cnn_batch_bitwise_jax(batch, size, ch, step, seed, sparsity):
    want = np.asarray(jsyn.cnn_batch(batch, size, ch, step, seed=seed,
                                     activation_sparsity=sparsity))
    got = tsyn.cnn_batch(batch, size, ch, step, seed=seed,
                         activation_sparsity=sparsity, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2), (3, 4)])
@pytest.mark.parametrize("step", [0, 5])
def test_lm_batches_bitwise_jax(step, host_index, host_count):
    jcfg = jsyn.TokenStreamConfig(vocab_size=97, seq_len=16, global_batch=8,
                                  seed=4)
    tcfg = tsyn.TokenStreamConfig(vocab_size=97, seq_len=16, global_batch=8,
                                  seed=4)
    for jfn, tfn in ((jsyn.lm_batch, tsyn.lm_batch),
                     (jsyn.markov_lm_batch, tsyn.markov_lm_batch)):
        want = jfn(jcfg, step, host_index=host_index, host_count=host_count)
        got = tfn(tcfg, step, host_index=host_index, host_count=host_count,
                  device="cpu")
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
        assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_synthetic_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tsyn.cnn_batch(1, 4, 3, 0).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="GPU"):
        tsyn.cnn_batch(1, 4, 3, 0)


# ---------------------------------------------------------------------------
# AlexNet: the boundary plan at 224, the event accounting at 64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 4, 8])
def test_alexnet_boundary_summary_equals_jax(batch):
    got = tcnn.chain_boundary_summary(tcnn.ALEXNET, batch=batch,
                                      device="cpu")
    want = jcnn.chain_boundary_summary(jcnn.ALEXNET, batch=batch)
    assert got == want
    assert got["densify"] == 0 and got["pool_events"] == 3


@functools.lru_cache(maxsize=None)
def _alexnet64():
    """JAX's AlexNet@64 weights (the JAX example's key), a cnn_batch frame,
    and both packages' run_with_stats on it."""
    spec_j = jcnn.ALEXNET.scaled(64)
    params = jcnn.init_cnn_params(jax.random.PRNGKey(0), spec_j,
                                  weight_sparsity=0.5)
    frame = np.array(jsyn.cnn_batch(1, 64, 3, 0, activation_sparsity=0.6))
    yj, jstats = jcnn.run_with_stats(params, jnp.asarray(frame), spec_j)
    tparams = tcnn.params_from_numpy([None if p is None else np.asarray(p)
                                      for p in params])
    yt, tstats = tcnn.run_with_stats(tparams, torch.from_numpy(frame),
                                     tcnn.ALEXNET.scaled(64), device="cpu")
    return tparams, frame, np.asarray(yj), jstats, yt, tstats


def test_alexnet64_run_with_stats_equals_jax():
    _, _, yj, jstats, yt, tstats = _alexnet64()
    assert len(tstats) == len(jstats) == 8
    for i, (t, j) in enumerate(zip(tstats, jstats)):
        assert set(t) == set(j), i
        for key in j:
            assert t[key] == j[key], (i, key, t[key], j[key])
    np.testing.assert_allclose(yt.numpy(), yj, atol=5e-3, rtol=5e-3)
    for design in ("mnf", "scnn_dense", "scnn", "sparten", "gospa"):
        assert network_cycles(tstats, design, d_w=0.5) == \
            jnetwork_cycles(jstats, design, d_w=0.5)


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_cnn_events_prices_jax_stats_exactly():
    tparams, frame, _, jstats, _, tstats = _alexnet64()
    ex = _example("torch_serve_cnn_events")
    run = ex.serve_cnn_events(device="cpu", params=tparams)
    assert run["stats"]["requests"] == 16
    assert torch.equal(run["frames"][:1], torch.from_numpy(frame))
    assert run["layer_stats"] == tstats
    assert run["row"] == jtable4_row(jstats, w_density=0.5)
    assert run["cycles"] == jnetwork_cycles(jstats, "mnf", d_w=0.5)
    assert run["row"] == table4_row(tstats, w_density=0.5)
    assert all(torch.allclose(r.result, run["oracle"][r.rid], atol=5e-3,
                              rtol=5e-3) for r in run["engine"].completed)


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

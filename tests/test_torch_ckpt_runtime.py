"""The port's checkpoints, resilient loop and prefetching loader against
the JAX package's, on the CPU:

- each package restores the other's checkpoint of the same train state —
  (params, AdamW state) with f32 and bf16 leaves and the int32 count —
  bitwise, bf16 leaves from their uint16 bits, and both write the same
  ``meta.json`` (keys, shapes, dtypes);
- ``save`` publishes atomically (a leftover tmp dir never shadows a step)
  and ``save_async`` copies its tree before it returns;
- the loop runs, checkpoints, resumes from ``LATEST`` with no re-applied
  or skipped batch, keeps ``keep_last`` checkpoints, and on SIGTERM ends
  after the running step with a final checkpoint (the twins of
  ``tests/test_runtime.py``'s single-device cases);
- ``StragglerDetector`` flags the same steps as JAX's, with the same
  EWMA, on the same list of step times;
- ``PrefetchLoader`` yields the same steps and batches in the same order
  as JAX's, with the same ``state``, and raises ``batch_fn``'s error;
- the example twins ``examples/torch_train_lm.py`` and
  ``examples/torch_serve_lm_decode.py`` run on the CPU.
"""
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import optim as jopt
from repro.data import PrefetchLoader as JLoader
from repro.runtime import StragglerDetector as JDetector
from repro_torch import checkpoint as tck
from repro_torch import optim as topt
from repro_torch.data import PrefetchLoader
from repro_torch.models.param_utils import tree_map
from repro_torch.runtime import LoopConfig, ResilientLoop, StragglerDetector

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _state_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"embed": {"tok": rng.normal(size=(6, 4)).astype(np.float32)},
            "layers": {"w": rng.normal(size=(2, 4, 3)).astype(np.float32),
                       "b": rng.normal(size=(2, 3)).astype(np.float32)}}


def _jax_state(seed=0):
    p = jax.tree.map(jnp.asarray, _state_np(seed))
    p["layers"]["b"] = p["layers"]["b"].astype(jnp.bfloat16)
    opt = jopt.adamw_init(p)
    opt = opt._replace(
        mu=jax.tree.map(lambda a: a + 0.5, opt.mu),
        nu=jax.tree.map(lambda a: a + 0.25, opt.nu),
        count=jnp.asarray(7, jnp.int32))
    return (p, opt)


def _torch_state(seed=0):
    raw = _state_np(seed)
    p = {"embed": {"tok": torch.from_numpy(raw["embed"]["tok"])},
         "layers": {"w": torch.from_numpy(raw["layers"]["w"]),
                    "b": torch.from_numpy(raw["layers"]["b"]).to(
                        torch.bfloat16)}}
    opt = topt.adamw_init(p)
    opt = opt._replace(
        mu=tree_map(lambda a: a + 0.5, opt.mu),
        nu=tree_map(lambda a: a + 0.25, opt.nu),
        count=torch.tensor(7, dtype=torch.int32))
    return (p, opt)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def _pairs(tstate, jstate):
    """(torch leaf, jax leaf) pairs in the JAX package's leaf order."""
    jleaves = jax.tree.leaves(jstate)
    tleaves = [leaf for _, leaf in
               tck.checkpointer._flatten_with_path(tstate)]
    assert len(tleaves) == len(jleaves)
    return zip(tleaves, jleaves)


def test_same_keys_and_meta_as_jax(tmp_path):
    jck.save(_jax_state(), str(tmp_path / "j"), 3)
    tck.save(_torch_state(), str(tmp_path / "t"), 3)
    metas = [json.loads((tmp_path / d / "step_00000003" / "meta.json")
                        .read_text()) for d in ("j", "t")]
    assert metas[0] == metas[1]
    assert "1::.mu::layers::b" in metas[0]["leaves"]
    assert metas[0]["leaves"]["0::layers::b"]["dtype"] == "uint16"
    assert metas[0]["leaves"]["1::.count"] == dict(shape=[], dtype="int32")


def test_port_restores_jax_checkpoint_bitwise(tmp_path):
    d = str(tmp_path / "ck")
    jstate = _jax_state(1)
    jck.save(jstate, d, 5)
    got, step = tck.restore(_torch_state(0), d)
    assert step == 5
    for t, j in _pairs(got, jstate):
        assert np.array_equal(_bits(t), _bits(j))
    assert got[0]["layers"]["b"].dtype == torch.bfloat16
    assert got[1].count.dtype == torch.int32 and int(got[1].count) == 7


def test_jax_restores_port_checkpoint_bitwise(tmp_path):
    d = str(tmp_path / "ck")
    tstate = _torch_state(2)
    tck.save(tstate, d, 9)
    got, step = jck.restore(_jax_state(0), d)
    assert step == 9
    for t, j in _pairs(tstate, got):
        assert np.array_equal(_bits(t), _bits(j))
    assert got[0]["layers"]["b"].dtype == jnp.bfloat16


def test_checkpoint_atomicity_and_async_snapshot(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.ones(8)
    t = tck.save_async({"x": x}, d, 5)
    x.add_(1.0)                          # after the host copy was taken
    t.join(timeout=60)
    assert not t.is_alive()
    assert tck.latest_step(d) == 5
    assert not any(p.endswith(".tmp") for p in os.listdir(d))
    # a leftover tmp dir of a later step never shadows a published one
    os.makedirs(os.path.join(d, "step_00000007.tmp"))
    assert tck.all_steps(d) == [5]
    got, step = tck.restore({"x": torch.zeros(8)}, d)
    assert step == 5 and torch.equal(got["x"], torch.ones(8))
    with pytest.raises(ValueError, match="shape"):
        tck.restore({"x": torch.zeros(4)}, d)
    with pytest.raises(FileNotFoundError):
        tck.restore({"x": torch.zeros(8)}, str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def _make_loop(tmp_path, total=20, ckpt_every=5, keep_last=3, kill_at=None):
    def step_fn(state, batch):
        (w,) = state
        if kill_at is not None and int(batch) == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        w = w + batch
        return (w,), dict(loss=float(w.sum()))

    def batch_fn(step):
        return torch.tensor(float(step))

    return ResilientLoop(LoopConfig(total_steps=total,
                                    ckpt_dir=str(tmp_path / "ck"),
                                    ckpt_every=ckpt_every,
                                    keep_last=keep_last),
                         step_fn, batch_fn)


def test_loop_runs_and_checkpoints(tmp_path):
    loop = _make_loop(tmp_path)
    (w,), final, preempted = loop.run((torch.zeros(()),))
    assert final == 20 and not preempted
    assert float(w) == sum(range(20))
    assert [m["step"] for m in loop.metrics_log] == list(range(20))


def test_loop_resumes_from_checkpoint(tmp_path):
    _make_loop(tmp_path, total=10, ckpt_every=5).run((torch.zeros(()),))
    loop2 = _make_loop(tmp_path, total=15, ckpt_every=5)
    (w,), final, _ = loop2.run((torch.zeros(()),))
    assert final == 15
    assert float(w) == sum(range(15))     # no re-applied or skipped batches
    assert [m["step"] for m in loop2.metrics_log] == list(range(10, 15))


def test_loop_gc_keeps_last(tmp_path):
    _make_loop(tmp_path, total=12, ckpt_every=2, keep_last=2).run(
        (torch.zeros(()),))
    # the GC after the save at 12's predecessor keeps 2 published, the
    # pending one and the final checkpoint are added after it
    steps = tck.all_steps(str(tmp_path / "ck"))
    assert steps[-1] == 12 and len(steps) <= 3 and 2 not in steps


def test_loop_preemption_checkpoints_and_resumes(tmp_path):
    loop = _make_loop(tmp_path, total=20, ckpt_every=100, kill_at=6)
    (w,), final, preempted = loop.run((torch.zeros(()),))
    assert preempted and final == 7
    assert tck.latest_step(str(tmp_path / "ck")) == 7
    got, _ = tck.restore((torch.zeros(()),), str(tmp_path / "ck"))
    assert torch.equal(got[0], w)
    assert signal.getsignal(signal.SIGTERM) is not loop._handle_signal
    loop2 = _make_loop(tmp_path, total=10, ckpt_every=100)
    (w2,), final2, preempted2 = loop2.run((torch.zeros(()),))
    assert final2 == 10 and not preempted2
    assert float(w2) == sum(range(10))


def test_straggler_detector_equals_jax():
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.9, 1.1, size=40))
    for i in (3, 17, 18, 30):
        times[i] *= 4.0
    jd, td = JDetector(factor=2.0, alpha=0.3), StragglerDetector(factor=2.0,
                                                                 alpha=0.3)
    flags = [(jd.observe(i, t), td.observe(i, t)) for i, t in
             enumerate(times)]
    assert all(a == b for a, b in flags)
    assert td.flagged == jd.flagged and len(td.flagged) == 4
    assert td.ewma == jd.ewma


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------

def _batch_fn(step):
    if step == 9:
        raise RuntimeError("no batch 9")
    rng = np.random.default_rng(step)
    return {"tokens": rng.integers(0, 50, (2, 4)).astype(np.int32)}


def test_prefetch_loader_equals_jax():
    jl = JLoader(_batch_fn, start_step=3, prefetch=2)
    tl = PrefetchLoader(lambda s: {k: torch.from_numpy(v) for k, v in
                                   _batch_fn(s).items()},
                        start_step=3, prefetch=2, device="cpu")
    try:
        for _ in range(6):
            js, jb = next(jl)
            ts, tb = next(tl)
            assert ts == js and tl.state == jl.state
            assert np.array_equal(tb["tokens"].numpy(), jb["tokens"])
            assert tb["tokens"].device.type == "cpu"
        assert tl.state == {"step": 9}
        with pytest.raises(RuntimeError, match="no batch 9"):
            next(tl)
    finally:
        jl.close()
        tl.close()
    assert not tl._thread.is_alive()


# ---------------------------------------------------------------------------
# The example twins
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_example_runs_on_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example("torch_train_lm").main(
            ["--steps", "3", "--device", "cpu", "--ckpt-dir",
             str(tmp_path / "ck"), "--log-every", "1"])
    summary = json.loads(buf.getvalue().splitlines()[1])
    assert summary["final_step"] == 3 and np.isfinite(summary["last_loss"])


def test_serve_lm_decode_example_runs_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example("torch_serve_lm_decode").main(["--device", "cpu"])
    stats = json.loads(buf.getvalue().splitlines()[-1])
    assert stats["arch"] == "qwen2-0.5b" and stats["generated"] == 16
    assert stats["device"] == "cpu"

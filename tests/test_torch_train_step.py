"""The port's optimizer, schedules and train step against the JAX
package's, on the CPU, and the training driver end to end:

- ``constant``, ``warmup_cosine`` (two settings) and ``warmup_linear``
  equal JAX's within 1e-6 of the peak rate at every step from 0 to 120;
- ``adamw_update`` over five steps of a small tree (an f32 matrix, a bf16
  vector, clipping binding, a schedule) against JAX's: params, moments,
  count and metrics within 1e-6 of max|JAX| (the bf16 leaf within one
  bf16 step of it);
- ``global_norm`` and ``clip_by_global_norm`` against JAX's;
- ``launch.steps.make_train_step`` with ``accum_steps`` 1 and 2 on a
  reduced Qwen2 at an f32 compute dtype, two steps from the same params
  against the JAX package's ``make_train_step`` on a one-device mesh:
  the loss, ``grad_norm`` and ``lr`` within 1e-5, the moments (the
  gradients' record) within 1e-4 of max|JAX|, every param within 1e-2
  of max|JAX's update| (Adam divides each gradient element by its own
  RMS, so an element whose gradient is near zero — the key bias's, which
  softmax nearly cancels — moves by O(lr) on rounding noise alone); and
  inside the port accum 2's moments within 1e-5 of accum 1's;
- the twin of ``tests/test_system.py::test_lm_training_loss_decreases``:
  a 2-layer reduced Qwen2 (vocab 64) on the Markov corpus, 30 steps, the
  mean of the last 5 losses below the mean of the first 5 by 0.2;
- ``python -m repro_torch.launch.train --device cpu`` prints the JAX
  driver's summary keys and the roofline row, and a second run resumes
  from its checkpoint.
"""
import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import checked_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as jtfm
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import TokenStreamConfig, markov_lm_batch
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as ttfm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32)
                      if t.dtype == jnp.bfloat16 else t)


def _flat(tree, path=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


SCHEDULES = [
    ("constant", (0.5,), {}),
    ("warmup_cosine", (1.0, 10, 100), {}),
    ("warmup_cosine", (3e-4, 20, 30), dict(final_frac=0.2)),
    ("warmup_linear", (2e-3, 7, 90), {}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES,
                         ids=[f"{s[0]}{s[1]}" for s in SCHEDULES])
def test_schedules_equal_jax(name, args, kw):
    js, ts = getattr(jopt, name)(*args, **kw), getattr(topt, name)(*args,
                                                                   **kw)
    steps = np.arange(121)
    want = np.array([float(js(jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.array([float(ts(torch.tensor(s, dtype=torch.int32)))
                    for s in steps])
    assert np.abs(got - want).max() <= 1e-6 * args[0]
    assert ts(torch.tensor(3)).dtype == torch.float32


def _opt_pair(**kw):
    """Both packages' AdamWConfig: ``kw``, and without an ``lr`` the
    schedule warmup_cosine(1e-2, 2, 5)."""
    if "lr" in kw:
        return jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    return (jopt.AdamWConfig(schedule=jopt.warmup_cosine(1e-2, 2, 5), **kw),
            topt.AdamWConfig(schedule=topt.warmup_cosine(1e-2, 2, 5), **kw))


@pytest.mark.parametrize("kw", [dict(grad_clip=0.5),
                                dict(lr=3e-3, weight_decay=0.0,
                                     grad_clip=1e9)])
def test_adamw_update_equals_jax(kw):
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    jp = {"w": jnp.asarray(p0["w"]),
          "b": {"c": jnp.asarray(p0["b"]["c"]).astype(jnp.bfloat16)}}
    tp = {"w": torch.from_numpy(p0["w"]),
          "b": {"c": torch.from_numpy(p0["b"]["c"]).to(torch.bfloat16)}}
    jc, tc = _opt_pair(**kw)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(5):
        g = {"w": rng.normal(size=(4, 3)).astype(np.float32),
             "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
        jp, js, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                       jc)
        tp, ts, tm = topt.adamw_update(
            {"w": torch.from_numpy(g["w"]),
             "b": {"c": torch.from_numpy(g["b"]["c"])}}, ts, tp, tc)
        assert int(ts.count) == int(js.count) == step + 1
        assert ts.count.dtype == torch.int32
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                1e-6 * abs(float(jm[key])), key
        for name, leaf in _flat(tp):
            want = dict(_flat(jp))[name]
            assert str(leaf.dtype).split(".")[-1] == str(want.dtype)
            tol = 2 ** -7 if leaf.dtype == torch.bfloat16 else 1e-6
            assert _rel(_np(leaf), _np(want)) <= tol, (step, name)
        for part in ("mu", "nu"):
            for (name, a), (_, b) in zip(_flat(getattr(ts, part)),
                                         _flat(getattr(js, part))):
                assert _rel(a.numpy(), np.asarray(b)) <= 1e-6, (step, part,
                                                                 name)


def test_global_norm_and_clip_equal_jax():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(7,)).astype(np.float32),
            "b": {"c": rng.normal(size=(3, 2)).astype(np.float32)}}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = {"a": torch.from_numpy(tree["a"]),
          "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    gn = float(jopt.global_norm(jt))
    assert abs(float(topt.global_norm(tt)) - gn) <= 1e-6 * gn
    for max_norm in (0.5, 100.0):
        jc, jn = jopt.clip_by_global_norm(jt, max_norm)
        tc, tn = topt.clip_by_global_norm(tt, max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * gn
        for (_, a), (_, b) in zip(_flat(tc), _flat(jc)):
            assert _rel(a.numpy(), np.asarray(b)) <= 1e-6


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

ARCH = "qwen2-0.5b"
SHAPE = (32, 4)                         # seq, batch


def _step_both(accum):
    """Two steps of each package's train step from JAX's params, on
    Markov batches 0 and 1."""
    jc = jget_config(ARCH).reduced(compute_dtype="float32")
    tc = get_config(ARCH).reduced(compute_dtype="float32")
    params, _ = jtfm.init_params(jax.random.PRNGKey(0), jc)
    params = jax.tree.map(np.array, params)
    seq, bsz = SHAPE
    jopt_cfg = jopt.AdamWConfig(schedule=jopt.warmup_cosine(1e-3, 1, 10))
    topt_cfg = topt.AdamWConfig(schedule=topt.warmup_cosine(1e-3, 1, 10))
    plan = jmake_train_step(jc, JShape("t", seq, bsz, "train"),
                            checked_mesh((1, 1), ("data", "model")),
                            opt=jopt_cfg, accum_steps=accum)
    tplan = make_train_step(tc, ShapeConfig("t", seq, bsz, "train"),
                            opt=topt_cfg, accum_steps=accum)
    ds = TokenStreamConfig(vocab_size=jc.vocab_size, seq_len=seq,
                           global_batch=bsz)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.adamw_init(jp)
    tp = ttfm.params_from_numpy(params, tc, "cpu")
    ts = topt.adamw_init(tp)
    jm_all, tm_all = [], []
    for step in range(2):
        tb = markov_lm_batch(ds, step, device="cpu")
        jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
        jp, js, jm = plan.fn(jp, js, jb)
        tp, ts, tm = tplan.fn(tp, ts, tb)
        jm_all.append({k: float(v) for k, v in jm.items()})
        tm_all.append({k: float(v) for k, v in tm.items()})
    return (jax.tree.map(np.array, jp), js, jm_all), (tp, ts, tm_all), params


@functools.lru_cache(maxsize=None)
def _cached(accum):
    return _step_both(accum)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_equals_jax(accum):
    (jp, js, jm), (tp, ts, tm), p0 = _cached(accum)
    for step in range(2):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(tm[step][key] - jm[step][key]) <= \
                1e-5 * abs(jm[step][key]), (step, key)
    assert int(ts.count) == int(js.count) == 2
    for part in ("mu", "nu"):
        for (name, a), (_, b) in zip(_flat(getattr(ts, part)),
                                     _flat(jax.tree.map(
                                         np.array, getattr(js, part)))):
            assert _rel(a.numpy(), b) <= 1e-4, (part, name)
    for (name, a), (_, b), (_, a0) in zip(_flat(tp), _flat(jp), _flat(p0)):
        update = np.abs(b - a0).max()
        assert np.abs(a.numpy() - b).max() <= 1e-2 * max(update, 1e-30), \
            name


def test_train_step_accum_2_equals_accum_1_in_port():
    _, (_, s1, m1), _ = _cached(1)
    _, (_, s2, m2), _ = _cached(2)
    for a, b in zip(m2, m1):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    for part in ("mu", "nu"):
        for (name, a), (_, b) in zip(_flat(getattr(s2, part)),
                                     _flat(getattr(s1, part))):
            assert _rel(a.numpy(), b.numpy()) <= 1e-5, (part, name)


def test_lm_training_loss_decreases():
    """The twin of the JAX system test: a 2-layer reduced Qwen2 with MNF
    on, vocab 64, on the Markov corpus; AdamW at 3e-3 without weight
    decay; 30 steps of batch 8 x 32."""
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              num_layers=2, vocab_size=64)
    plan = make_train_step(cfg, ShapeConfig("t", 32, 8, "train"),
                           opt=topt.AdamWConfig(lr=3e-3, weight_decay=0.0))
    params = ttfm.init_params(0, cfg, "cpu")
    state = topt.adamw_init(params)
    ds = TokenStreamConfig(vocab_size=64, seq_len=32, global_batch=8)
    losses = []
    for i in range(30):
        params, state, m = plan.fn(params, state,
                                   markov_lm_batch(ds, i, device="cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.main(argv)
    return buf.getvalue().splitlines()


def test_train_driver_runs_and_resumes_on_cpu(tmp_path):
    ck = str(tmp_path / "ck")
    base = ["--reduced", "--batch", "2", "--seq", "16", "--ckpt-every",
            "3", "--device", "cpu", "--ckpt-dir", ck, "--log-every", "1"]
    out = _run_cli(base + ["--steps", "4"])
    summary = json.loads(out[1])
    assert list(summary) == ["final_step", "preempted", "wall_s",
                             "first_loss", "last_loss", "stragglers_flagged",
                             "tokens_per_s"]
    assert summary["final_step"] == 4 and not summary["preempted"]
    roof = json.loads(out[2])
    r = roof["roofline"]
    assert r["chips"] == 1 and r["coll_gbytes"] == 0.0
    assert r["hlo_gflops"] > r["model_gflops"] > 0
    assert roof["measured_frac"] is None          # no card: not measured
    assert out[3].startswith("qwen2-0.5b") and "roofline=" in out[3]
    assert [ln.split()[1] for ln in out[4:]] == ["0", "1", "2", "3"]
    out = _run_cli(base + ["--steps", "6"])
    assert json.loads(out[1])["final_step"] == 6
    assert [ln.split()[1] for ln in out[4:]] == ["4", "5"]
    from repro_torch import checkpoint as tck
    assert tck.all_steps(ck) == [3, 4, 6]

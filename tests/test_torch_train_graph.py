"""The graphed train step's body on the CPU: what the CUDA graph of
``launch.steps.make_train_step`` captures, run eagerly at a small size.

- ``optim.adamw_update_`` (in place) is bitwise ``adamw_update`` over
  five steps of a small tree (an f32 matrix, a bf16 vector; clipping
  binding or not; a schedule or a constant rate).
- The step's body (``_GraphedTrain._step``: the same loss and gradients,
  then ``adamw_update_`` into the state) over 3 steps on a reduced Qwen2
  and a reduced Hymba (2 layers) is bitwise the eager functional step
  (``make_train_step(graph=False)``): params, moments, count, loss,
  grad_norm and lr, at ``accum_steps`` 1 and 2 and with ``schedule``
  None.
- The same in-place run against the JAX package's ``make_train_step``
  on a one-device mesh, within ``tests/test_torch_train_step.py``'s
  tolerances: loss, grad_norm and lr 1e-5; moments 1e-4 of max|JAX|;
  params 1e-2 of JAX's largest update.
- The graphed call's own logic (``_GraphedTrain._replay``) with
  ``graphs.capture`` replaced by an eager stand-in: the warm-up advances
  nothing (the first replay is step 1), the returned leaves are the
  graph's buffers, the caller's tensors are left as they are, a call
  with other state tensors (a restore) copies them in, and a call
  handed the returned trees copies nothing but the batch.
- ``make_train_step(graph=True)`` on CPU tensors is the eager step,
  bitwise.
"""
import contextlib
import dataclasses

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
from repro_torch.launch import steps
from repro_torch.models import transformer as ttfm
from repro_torch.models.param_utils import tree_leaves, tree_map

SEQ, BATCH, STEPS = 16, 4, 3


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _state_leaves(params, state):
    return tree_leaves((params, state.mu, state.nu, state.count))


def _bitwise(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# -- the in-place AdamW update --------------------------------------------

@pytest.mark.parametrize("kw", [dict(grad_clip=0.5),
                                dict(lr=3e-3, weight_decay=0.0,
                                     grad_clip=1e9)],
                         ids=["clipped-schedule", "constant-lr"])
def test_adamw_update_in_place_is_bitwise_functional(kw):
    if "lr" not in kw:
        kw = dict(kw, schedule=topt.warmup_cosine(1e-2, 2, 5))
    cfg = topt.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
         "b": {"c": torch.from_numpy(
             rng.normal(size=(5,)).astype(np.float32)).to(torch.bfloat16)}}
    s = topt.adamw_init(p)
    p_in, s_in = _clone(p), topt.OptState(_clone(s.mu), _clone(s.nu),
                                          s.count.clone())
    ptrs = [t.data_ptr() for t in _state_leaves(p_in, s_in)]
    for _ in range(5):
        g = {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(
            np.float32)),
             "b": {"c": torch.from_numpy(rng.normal(size=(5,)).astype(
                 np.float32))}}
        p, s, m = topt.adamw_update(g, s, p, cfg)
        m_in = topt.adamw_update_(g, s_in, p_in, cfg)
        assert _bitwise(_state_leaves(p_in, s_in), _state_leaves(p, s))
        for key in ("grad_norm", "lr"):
            assert m_in[key].dtype == torch.float32 and m_in[key].dim() == 0
            assert torch.equal(m_in[key], m[key]), key
    assert [t.data_ptr() for t in _state_leaves(p_in, s_in)] == ptrs
    assert int(s_in.count) == 5 and s_in.count.dtype == torch.int32


# -- the step's body against the eager functional step --------------------

def _cfg(arch):
    cfg = get_config(arch).reduced(num_layers=2)
    if cfg.ssm is not None:
        # two scan chunks a layer: the final state's gradient crosses one
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, scan_chunk=SEQ // 2))
    return cfg


def _opt(schedule):
    return topt.AdamWConfig(schedule=topt.warmup_cosine(1e-3, 1, 10)) \
        if schedule else topt.AdamWConfig(lr=1e-3)


def _batches(cfg, n, seq=SEQ, bsz=BATCH):
    ds = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=bsz)
    return [markov_lm_batch(ds, i, device="cpu") for i in range(n)]


def _eager_run(fn, params, batches) -> list:
    """Each step's (params, opt_state, metrics) of the eager step."""
    state, out = (params, topt.adamw_init(params)), []
    for b in batches:
        out.append(fn(*state, b))
        state = out[-1][:2]
    return out


CASES = [("qwen2-0.5b", 1, True), ("qwen2-0.5b", 2, True),
         ("qwen2-0.5b", 1, False), ("hymba-1.5b", 1, True),
         ("hymba-1.5b", 2, False)]


@pytest.mark.parametrize("arch,accum,schedule", CASES,
                         ids=[f"{a}-accum{n}-{'schedule' if s else 'lr'}"
                              for a, n, s in CASES])
def test_step_body_in_place_is_bitwise_functional(arch, accum, schedule):
    cfg = _cfg(arch)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    graphed = steps.make_train_step(cfg, shape, opt=_opt(schedule),
                                    accum_steps=accum)
    eager = steps.make_train_step(cfg, shape, opt=_opt(schedule),
                                  accum_steps=accum, graph=False)
    assert isinstance(graphed.fn, steps._GraphedTrain)
    assert graphed.fn.eager is not None and eager.fn.eager is eager.fn
    params = ttfm.init_params(0, cfg, "cpu")
    batches = _batches(cfg, STEPS)
    want = _eager_run(eager.fn, params, batches)
    p, s = _clone(params), topt.adamw_init(params)
    for (p_want, s_want, m_want), b in zip(want, batches):
        m = graphed.fn._step(p, s.mu, s.nu, s.count, b)
        assert _bitwise(_state_leaves(p, s), _state_leaves(p_want, s_want))
        assert set(m) == {"loss", "grad_norm", "lr"}
        for key in m:
            assert torch.equal(m[key], m_want[key]), key
    assert int(s.count) == STEPS


# -- the in-place run against the JAX package's train step ---------------

@pytest.mark.parametrize("accum", [1, 2])
def test_in_place_step_equals_jax(accum):
    seq, bsz = 32, 4
    jc = jget_config("qwen2-0.5b").reduced(compute_dtype="float32")
    tc = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    params, _ = jtfm.init_params(jax.random.PRNGKey(0), jc)
    params = jax.tree.map(np.array, params)
    jplan = jmake_train_step(
        jc, JShape("t", seq, bsz, "train"),
        checked_mesh((1, 1), ("data", "model")),
        opt=jopt.AdamWConfig(schedule=jopt.warmup_cosine(1e-3, 1, 10)),
        accum_steps=accum)
    tplan = steps.make_train_step(
        tc, ShapeConfig("t", seq, bsz, "train"),
        opt=topt.AdamWConfig(schedule=topt.warmup_cosine(1e-3, 1, 10)),
        accum_steps=accum)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.adamw_init(jp)
    tp = ttfm.params_from_numpy(params, tc, "cpu")
    ts = topt.adamw_init(tp)
    for b in _batches(tc, 2, seq, bsz):
        jp, js, jm = jplan.fn(jp, js, {k: jnp.asarray(v.numpy())
                                       for k, v in b.items()})
        tm = tplan.fn._step(tp, ts.mu, ts.nu, ts.count, b)
        for key in ("loss", "grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                1e-5 * abs(float(jm[key])), key
    assert int(ts.count) == int(js.count) == 2
    for part in ("mu", "nu"):
        for a, b in zip(_sorted_leaves(getattr(ts, part)),
                        _sorted_leaves(jax.tree.map(np.array,
                                                    getattr(js, part)))):
            assert _rel(a.numpy(), b) <= 1e-4, part
    for a, b, a0 in zip(_sorted_leaves(tp),
                        _sorted_leaves(jax.tree.map(np.array, jp)),
                        _sorted_leaves(params)):
        update = np.abs(b - a0).max()
        assert np.abs(a.numpy() - b).max() <= 1e-2 * max(update, 1e-30)


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- the graphed call's own logic, with an eager stand-in for the graph ---

class _EagerGraph:
    """``graphs.capture`` on the CPU: the same warm-up call, then each
    replay calls ``fn`` on the static inputs."""

    def __init__(self, fn, *static, pool=None):
        fn(*static)
        self.fn, self.static, self.replays, self.outputs = fn, static, 0, None

    def replay(self):
        self.outputs = self.fn(*self.static)
        self.replays += 1
        return self.outputs


@contextlib.contextmanager
def _counting_copies():
    counts = [0]
    orig = torch.Tensor.copy_

    def copy_(self, src, *a, **k):
        counts[0] += 1
        return orig(self, src, *a, **k)
    torch.Tensor.copy_ = copy_
    try:
        yield counts
    finally:
        torch.Tensor.copy_ = orig


def test_graphed_call_copies_state_in_and_returns_its_buffers(monkeypatch):
    monkeypatch.setattr(steps.graphs, "capture", _EagerGraph)
    cfg = _cfg("qwen2-0.5b")
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    fn = steps.make_train_step(cfg, shape, opt=_opt(True)).fn
    eager = steps.make_train_step(cfg, shape, opt=_opt(True),
                                  graph=False).fn
    params = ttfm.init_params(0, cfg, "cpu")
    init = (params, topt.adamw_init(params))
    before = [t.clone() for t in _state_leaves(*init)]
    batches = _batches(cfg, STEPS)
    want = [_state_leaves(p, o) + [m["loss"]]
            for p, o, m in _eager_run(eager, params, batches)]
    n_params = len(tree_leaves(params))

    p, o, m = fn._replay(*init, batches[0])
    assert fn.graph.replays == 1
    assert _bitwise(_state_leaves(p, o) + [m["loss"]], want[0])  # step 1
    assert _bitwise(_state_leaves(*init), before)        # the caller's kept
    s_params, s_mu, s_nu, s_count, _ = fn.graph.static
    assert all(x is y for x, y in zip(
        _state_leaves(p, o),
        _state_leaves(s_params, topt.OptState(s_mu, s_nu, s_count))))
    p1 = (_clone(p), topt.OptState(_clone(o.mu), _clone(o.nu),
                                   o.count.clone()))
    # handed back the returned trees: only the batch is copied in (beside
    # the update's own three copies a leaf)
    with _counting_copies() as counts:
        p, o, m = fn._replay(p, o, batches[1])
    assert counts[0] == 3 * n_params + len(batches[1])
    assert _bitwise(_state_leaves(p, o) + [m["loss"]], want[1])
    # a restore between replays: other tensors holding step 1's state
    # are copied in, leaf by leaf
    with _counting_copies() as counts:
        p2, o2, m = fn._replay(*p1, batches[1])
    assert counts[0] == 6 * n_params + 1 + len(batches[1])
    assert p2 is p and o2.count is o.count
    assert _bitwise(_state_leaves(p2, o2) + [m["loss"]], want[1])
    p3, o3, m = fn._replay(p2, o2, batches[2])
    assert _bitwise(_state_leaves(p3, o3) + [m["loss"]], want[2])
    assert fn.graph.replays == 4 and int(o3.count) == 3
    with pytest.raises(ValueError):
        fn._replay(p3, o3, {k: v[:2] for k, v in batches[2].items()})


def test_graphed_step_on_cpu_tensors_is_the_eager_step():
    cfg = _cfg("hymba-1.5b")
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    fn = steps.make_train_step(cfg, shape, opt=_opt(True)).fn
    eager = steps.make_train_step(cfg, shape, opt=_opt(True),
                                  graph=False).fn
    params = ttfm.init_params(0, cfg, "cpu")
    state = topt.adamw_init(params)
    before = [t.clone() for t in _state_leaves(params, state)]
    b = _batches(cfg, 1)[0]
    p, o, m = fn(params, state, b)
    pe, oe, me = eager(params, state, b)
    assert fn.graph is None
    assert _bitwise(_state_leaves(p, o), _state_leaves(pe, oe))
    assert all(torch.equal(m[k], me[k]) for k in me)
    assert _bitwise(_state_leaves(params, state), before)

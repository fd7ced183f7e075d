"""The port's Hymba-1.5B serving path against ``repro`` on the CPU: the same
numpy inputs (and the JAX package's own weights, carried across by
``params_from_numpy``) through both packages.

- B8: the port's plain version against ``mamba_step_events_ref`` and
  ``mamba_step_events_pallas(interpret=True)`` at 1e-5, at threshold 0 and
  above, at DI 64 and a ragged 40, with a row with no events and a row
  whose every block is dead; off the CPU the wrapper hands the kernel the
  events and builds no live mask (meta tensors, a stub launcher).
- ``recurrent_step("mamba")``: outputs and trace records as JAX's, the
  ``recurrent_ineligible_reason`` messages verbatim.
- ``apply_rope``, ``mlp_apply``, ``mamba_apply``, ``mamba_step`` and
  ``chunked_attention`` against JAX.
- The reduced Hymba (2 layers, d_model 64): prefill logits and every cache
  leaf at prompts 12 and 40, then 4 teacher-forced decode steps, at 1e-4
  in f32 and in bf16 at 3e-2 (or, at a step where the JAX package's own
  bf16 run lies further from its f32 run, that far), and gated above
  threshold 0.
- Inside the port: the gated decode at threshold 0 is bitwise the ungated
  one, and ``python -m repro_torch.launch.serve --arch hymba-1.5b
  --reduced --device cpu`` prints its stats.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.configs import get_config as jget_config
from repro.configs.base import GLOBAL_WINDOW as J_GLOBAL_WINDOW
from repro.kernels.mamba_scan.step import (mamba_step_events_pallas,
                                           mamba_step_events_ref as j_ref)
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch import engine as tengine
from repro_torch.configs import GLOBAL_WINDOW, get_config
from repro_torch.core import events as tev
from repro_torch.kernels.mamba_step.kernel import mamba_step_cuda
from repro_torch.kernels.mamba_step.ops import mamba_step_events
from repro_torch.kernels.mamba_step.ref import mamba_step_events_ref
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm

N_STATE = 16


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _step_inputs(seed, di, n=N_STATE):
    """(g, da, bmat, cmat, h) for 4 rows: row 0 has a zero gate (no event
    at any threshold), row 1 a gate below 0.05 (every block dead at
    threshold 0.3), rows 2 and 3 normal gates; da in (0, 1)."""
    r_ = np.random.default_rng(seed)
    f = lambda *s: r_.normal(size=s).astype(np.float32)
    g = f(4, di)
    g[0] = 0.0
    g[1] = r_.uniform(-0.05, 0.05, size=di).astype(np.float32)
    da = r_.uniform(0.05, 1.0, size=(4, di, n)).astype(np.float32)
    return g, da, f(4, n), f(4, n), f(4, di, n)


def _streams(g, threshold):
    jst = jengine.fire_delta(jnp.asarray(g),
                             jengine.EngineConfig(threshold=threshold))
    tst = tengine.fire_delta(torch.from_numpy(g),
                             tengine.EngineConfig(threshold=threshold))
    return jst, tst


B8_CASES = [(th, di) for th in (0.0, 0.3) for di in (64, 40)]


@pytest.mark.parametrize("threshold,di", B8_CASES)
def test_b8_plain_matches_jax_ref_and_pallas(threshold, di):
    g, da, bm, cm, h = _step_inputs(di + int(10 * threshold), di)
    jst, tst = _streams(g, threshold)
    assert tst.blk_k == jst.blk_k == 16
    jargs = [jnp.asarray(a) for a in (da, bm, cm, h)]
    y_ref, h_ref = j_ref(jst.events, *jargs, blk_k=jst.blk_k)
    y_pal, h_pal = mamba_step_events_pallas(jst.events, *jargs,
                                            blk_k=jst.blk_k, interpret=True)
    targs = [torch.from_numpy(a) for a in (da, bm, cm, h)]
    y, h_new = mamba_step_events(tst.events, *targs, blk_k=tst.blk_k)
    y2, h2 = mamba_step_events_ref(tst.events, *targs, blk_k=tst.blk_k)
    assert torch.equal(y, y2) and torch.equal(h_new, h2)
    assert tuple(y.shape) == (4, di) and tuple(h_new.shape) == (4, di, 16)
    for want_y, want_h in ((y_ref, h_ref), (y_pal, h_pal)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(h_new.numpy(), np.asarray(want_h),
                                   atol=1e-5, rtol=1e-5)
    counts = tst.events.counts.numpy()
    assert counts[0] == 0                  # the zero gate fires nothing
    live = tev.live_block_mask(tst.events).numpy()
    if threshold > 0:
        assert counts[1] == 0 and not live[1].any()   # all dead
        assert live[2:].any() and not live.all()
    dead = np.repeat(~live, tst.blk_k, axis=1)[:, :di]
    # a dead block's state is the decay alone, bit for bit
    np.testing.assert_array_equal(h_new.numpy()[dead], (h * da)[dead])


def test_b8_launcher_refuses_cpu_tensors():
    z = torch.zeros((1, 4))
    i32 = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mamba_step_cuda(torch.zeros((1, 1, 1, 4)), i32, i32[0],
                        torch.zeros((1, 4, 4)), z, z, torch.zeros((1, 4, 4)),
                        nkb=1)


@pytest.mark.parametrize("di,nkb,bk", [(1600, 100, 16), (40, 3, 16),
                                       (20, 3, 8)])
def test_b8_wrapper_launches_on_the_events_with_no_mask(monkeypatch, di,
                                                         nkb, bk):
    """Off the CPU the wrapper hands B8 the events as they are, with their
    DI-block count, counts one launch and builds no live mask (the kernel
    derives it).  Meta tensors stand in for the card's; the launcher is a
    stub, and ``live_block_mask`` raises if anything calls it."""
    from repro_torch.kernels.mamba_step import ops
    calls = []

    def kernel(*args, nkb):
        calls.append((args, nkb))
        h_ = args[6]
        return (torch.empty(h_.shape[:2], device="meta"),
                torch.empty_like(h_))

    def no_mask(bev):
        raise AssertionError("the B8 wrapper built a live mask")

    monkeypatch.setattr(ops, "mamba_step_cuda", kernel)
    monkeypatch.setattr(tev, "live_block_mask", no_mask)
    b, e = 4, nkb

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    bev = tev.BlockEvents(meta(b, e, 1, bk), meta(b, e, dtype=torch.int32),
                          meta(b, dtype=torch.int32), nkb)
    da, h = meta(b, di, N_STATE), meta(b, di, N_STATE)
    bm, cm = meta(b, N_STATE), meta(b, N_STATE)
    launches = ops.mamba_step_events.launches
    y, h_new = ops.mamba_step_events(bev, da, bm, cm, h, blk_k=bk)
    assert ops.mamba_step_events.launches == launches + 1
    (args, got_nkb), = calls
    want = (bev.values, bev.block_idx, bev.counts, da, bm, cm, h)
    assert got_nkb == nkb and len(args) == len(want)
    assert all(a is b_ for a, b_ in zip(args, want))
    assert y.shape == (b, di) and h_new.shape == (b, di, N_STATE)
    with pytest.raises(ValueError, match="blk_k"):
        ops.mamba_step_events(bev, da, bm, cm, h, blk_k=bk + 1)


# ---------------------------------------------------------------------------
# recurrent_step("mamba") through the engine
# ---------------------------------------------------------------------------

def _ineligible_streams(pkg_engine, asarray, g):
    """(name, stream, cfg) of each recurrent_ineligible_reason rule and of
    the dense backend, built alike in either package."""
    gg = asarray(g)
    base = pkg_engine.EngineConfig()
    conv = pkg_engine.EventStream.encode_nhwc(
        asarray(np.abs(g).reshape(1, 2, 2, -1)), blk_k=8)
    conv = dataclasses.replace(conv, signed=True)
    wide = dataclasses.replace(
        pkg_engine.fire(gg, base.replace(blk_m=2, blk_k=8, signed=True)),
        signed=True)
    unsigned = pkg_engine.fire(gg, base.replace(blk_m=1, blk_k=8))
    int8 = pkg_engine.fire(gg, base.replace(blk_m=1, blk_k=8, signed=True,
                                            int8_events=True))
    eligible = pkg_engine.fire_delta(gg, base)
    return [("conv", conv, base), ("blk_m", wide, base),
            ("unsigned", unsigned, base), ("int8", int8, base),
            ("dense", eligible, base.replace(backend="dense")),
            ("eligible", eligible, base)]


def test_recurrent_ineligible_reasons_verbatim_for_mamba():
    g = _step_inputs(3, 40)[0]
    jcases = _ineligible_streams(jengine, jnp.asarray, g)
    tcases = _ineligible_streams(tengine, torch.from_numpy, g)
    for (name, js, jc), (_, ts, tc) in zip(jcases, tcases):
        want = jengine.recurrent_ineligible_reason(js, "mamba", jc)
        got = tengine.recurrent_ineligible_reason(ts, "mamba", tc)
        assert got == want, name
        assert (want is None) == (name == "eligible"), (name, want)
    assert tengine.recurrent_ineligible_reason(
        tcases[4][1], "mamba", tcases[4][2]) \
        == "backend 'dense' has no recurrent_step_mamba op"


TRACE_KEYS = ("op", "kind", "chained", "route", "fallback_decode",
              "routed_dense", "reason", "backend", "route_source",
              "shape_class")


@pytest.mark.parametrize("case", ["event", "dense_backend", "forced_dense",
                                  "unsigned", "zero_rows", "threshold"])
def test_recurrent_step_mamba_trace_and_outputs_match_jax(case):
    di = 40
    g, da, bm, cm, h = _step_inputs(7, di)
    kw = {}
    if case == "dense_backend":
        kw = dict(backend="dense")
    elif case == "forced_dense":
        kw = dict(route="dense")
    elif case == "threshold":
        kw = dict(threshold=0.3)
    out = {}
    for pkg, asarray in ((jengine, jnp.asarray), (tengine, torch.from_numpy)):
        cfg = pkg.EngineConfig(**kw).for_recurrent(di)
        rows = 0 if case == "zero_rows" else 4
        gg = asarray(g[:rows])
        if case == "unsigned":
            st = pkg.fire(gg, cfg.replace(signed=False))
        else:
            st = pkg.fire_delta(gg, cfg)
        ops = {n: asarray(a[:rows]) for n, a in
               dict(da=da, bmat=bm, cmat=cm).items()}
        with pkg.trace_dispatch() as recs:
            y, h_new = pkg.recurrent_step("mamba", st, asarray(h[:rows]),
                                          cfg, **ops)
        out[pkg] = (np.asarray(_np(y)), np.asarray(_np(h_new)),
                    [{key: rec.get(key) for key in TRACE_KEYS}
                     for rec in recs])
    (jy, jh, jrecs), (ty, th, trecs) = out[jengine], out[tengine]
    assert trecs == jrecs
    assert len(trecs) == (0 if case == "zero_rows" else 1)
    if case in ("event", "threshold"):
        assert trecs[0]["chained"] and trecs[0]["route"] == "event" \
            and trecs[0]["shape_class"] == f"mambad{di}"
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(th, jh, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Layer primitives and the Mamba / attention modules against JAX
# ---------------------------------------------------------------------------

def _cfg_pair(compute_dtype="float32", **overrides):
    jcfg = jget_config("hymba-1.5b").reduced(compute_dtype=compute_dtype,
                                             **overrides)
    tcfg = get_config("hymba-1.5b").reduced(compute_dtype=compute_dtype,
                                            **overrides)
    return jcfg, tcfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_config_equals_jax_and_derived_fields():
    jcfg, tcfg = jget_config("hymba-1.5b"), get_config("hymba-1.5b")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.q_dim, tcfg.kv_dim) == (jcfg.q_dim, jcfg.kv_dim) \
        == (1600, 320)
    assert GLOBAL_WINDOW == J_GLOBAL_WINDOW
    for c_t, c_j in ((tcfg, jcfg), (tcfg.reduced(), jcfg.reduced())):
        assert [c_t.window_for_layer(i) for i in range(c_t.num_layers)] \
            == [c_j.window_for_layer(i) for i in range(c_j.num_layers)]
    assert [tcfg.window_for_layer(i) for i in (0, 1, 15, 30, 31)] \
        == [GLOBAL_WINDOW, 1024, GLOBAL_WINDOW, 1024, GLOBAL_WINDOW]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    r_ = np.random.default_rng(0)
    x = r_.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = (np.arange(9) + 5).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jlayers.apply_rope(jx, jnp.asarray(pos)).astype(
        jnp.float32))
    got = tlayers.apply_rope(torch.from_numpy(x).to(tlayers.dtype_of(dtype)),
                             torch.from_numpy(pos)).float().numpy()
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_mlp_apply_matches_jax(threshold):
    jcfg, tcfg = _cfg_pair()
    jcfg = dataclasses.replace(jcfg, mnf=dataclasses.replace(
        jcfg.mnf, threshold=threshold))
    tcfg = dataclasses.replace(tcfg, mnf=dataclasses.replace(
        tcfg.mnf, threshold=threshold))
    p = jax.tree.map(np.array, jlayers.mlp_init(jax.random.PRNGKey(2),
                                                jcfg)[0])
    x = np.random.default_rng(1).normal(size=(2, 5, 64)).astype(np.float32)
    want = np.asarray(jlayers.mlp_apply(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(x), jcfg))
    got = tlayers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), tcfg).numpy()
    assert _rel(got, want) <= 1e-5


def _mamba_params(cfg, seed=3):
    p = jax.tree.map(np.array, jssm.mamba_init(
        jax.random.PRNGKey(seed), cfg, d_inner=cfg.d_model)[0])
    # init leaves conv_b and dt_bias zero: give them values to exercise
    r_ = np.random.default_rng(seed)
    p["conv_b"] = (0.1 * r_.normal(size=p["conv_b"].shape)).astype(np.float32)
    p["dt_bias"] = (0.1 * r_.normal(size=p["dt_bias"].shape)).astype(
        np.float32)
    return p


@pytest.mark.parametrize("t", [1, 12, 40])
def test_mamba_apply_matches_jax(t):
    """The prefill: JAX's chunked associative scan against the port's
    sequential loop (both f32; the sums run in another order, so 1e-4),
    at a scan chunk of 16 so that T = 40 spans 3 chunks."""
    jcfg, tcfg = _cfg_pair()
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
        jcfg.ssm, scan_chunk=16))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(
        tcfg.ssm, scan_chunk=16))
    p = _mamba_params(jcfg)
    x = np.random.default_rng(t).normal(size=(2, t, 64)).astype(np.float32)
    jy, (jconv, jh) = jssm.mamba_apply(jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x), jcfg)
    ty, (tconv, th) = tssm.mamba_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tcfg)
    assert _rel(ty.numpy(), jy) <= 1e-4
    assert _rel(th.numpy(), jh) <= 1e-4
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))


@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_mamba_step_matches_jax(threshold):
    jcfg, tcfg = _cfg_pair()
    jcfg = dataclasses.replace(jcfg, mnf=dataclasses.replace(
        jcfg.mnf, threshold=threshold))
    tcfg = dataclasses.replace(tcfg, mnf=dataclasses.replace(
        tcfg.mnf, threshold=threshold))
    p = _mamba_params(jcfg)
    r_ = np.random.default_rng(5)
    conv = r_.normal(size=(2, 3, 64)).astype(np.float32)
    h = r_.normal(size=(2, 64, 4)).astype(np.float32)
    x = r_.normal(size=(2, 1, 64)).astype(np.float32)
    jy, (jconv, jh), jn = jssm.mamba_step(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
        (jnp.asarray(conv), jnp.asarray(h)), with_events=True)
    ty, (tconv, th), tn = tssm.mamba_step(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tcfg, (torch.from_numpy(conv), torch.from_numpy(h)))
    assert float(tn) == float(jn)
    if threshold > 0:
        assert 0 < float(tn) < 2 * 64
    assert _rel(ty.numpy(), jy) <= 1e-5
    assert _rel(th.numpy(), jh) <= 1e-5
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))


@pytest.mark.parametrize("window", [8, "global"])
@pytest.mark.parametrize("kv_len", [None, 33])
def test_chunked_attention_matches_jax(window, kv_len):
    """A 40-token prompt under the reduced attn_chunk of 32 (2 chunks, the
    second padded), GQA of 4 query heads over 2 KV heads, with the reduced
    sliding window of 8 or no bound, and with a kv_len below the keys."""
    win = GLOBAL_WINDOW if window == "global" else window
    r_ = np.random.default_rng(0 if kv_len is None else 1)
    q = r_.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k = r_.normal(size=(2, 40, 2, 16)).astype(np.float32)
    v = r_.normal(size=(2, 40, 2, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    want = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), window=win, kv_len=kv_len, chunk=32))
    got = tattn.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(pos), window=win, kv_len=kv_len,
        chunk=32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The reduced Hymba against the JAX package
# ---------------------------------------------------------------------------

B, STEPS = 2, 4


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    """The JAX package's reduced Hymba weights as numpy, with random norm
    gains and Mamba biases (init leaves them ones and zeros, which would
    leave the ``- 1.0`` offsets and the bias adds unexercised)."""
    cfg = jget_config("hymba-1.5b").reduced()
    tree = jax.tree.map(np.array, jtfm.init_params(jax.random.PRNGKey(seed),
                                                   cfg)[0])
    r_ = np.random.default_rng(seed)
    lay = tree["layers"]
    for leaf in (lay["mix"], lay["mix"]["mamba"]):
        for name in ("norm_attn", "norm_mamba", "conv_b", "dt_bias"):
            if name in leaf:
                leaf[name] = (leaf[name] + 0.1 * r_.normal(
                    size=leaf[name].shape)).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _run_both(compute_dtype, prompt_len, threshold=0.0):
    tree = _jax_params()
    jcfg, tcfg = _cfg_pair(compute_dtype)
    jcfg = dataclasses.replace(jcfg, mnf=dataclasses.replace(
        jcfg.mnf, threshold=threshold))
    tcfg = dataclasses.replace(tcfg, mnf=dataclasses.replace(
        tcfg.mnf, threshold=threshold))
    r_ = np.random.default_rng(prompt_len)
    prompt = r_.integers(0, tcfg.vocab_size, (B, prompt_len)).astype(np.int32)
    teach = r_.integers(0, tcfg.vocab_size, (B, STEPS)).astype(np.int32)
    max_len = prompt_len + STEPS

    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg,
                                       max_len=max_len))(
        jparams, jnp.asarray(prompt))
    jsteps = [(np.asarray(jl), jax.tree.map(np.asarray, jc))]
    dstep = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
    for i in range(STEPS):
        jl, jc = dstep(jparams, jc, jnp.asarray(teach[:, i:i + 1]),
                       jnp.asarray(prompt_len + i, jnp.int32))
        jsteps.append((np.asarray(jl), jax.tree.map(np.asarray, jc)))

    tparams = ttfm.compute_params(
        ttfm.params_from_numpy(tree, tcfg, "cpu"), tcfg)
    tl, tc = ttfm.prefill(tparams, torch.from_numpy(prompt).long(), tcfg,
                          max_len=max_len)
    tsteps = [(tl, tc)]
    for i in range(STEPS):
        tl, tc = ttfm.decode_step(tparams, tc,
                                  torch.from_numpy(teach[:, i:i + 1]).long(),
                                  prompt_len + i, tcfg)
        tsteps.append((tl, tc))
    return jsteps, tsteps


def _leaves(tree, path=""):
    """(path, leaf) of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def _worst_per_step(steps_a, steps_b):
    """Per step, the largest relative gap of the logits and of any cache
    leaf (events aside) of run a from run b."""
    out = []
    for (al, ac), (bl, bc) in zip(steps_a, steps_b):
        bleaves = dict(_leaves(bc["scan"]))
        out.append(max([_rel(np.asarray(al, np.float32), bl)] + [
            _rel(np.asarray(v, np.float32), bleaves[k])
            for k, v in _leaves(ac["scan"]) if k != "events"]))
    return out


def _compare(compute_dtype, tol, prompt_len, threshold=0.0):
    """Prefill (step 0) and each teacher-forced decode step: logits and
    every cache leaf within ``tol`` (a number, or one per step) of
    max|JAX| (events exactly)."""
    jsteps, tsteps = _run_both(compute_dtype, prompt_len, threshold)
    tols = tol if isinstance(tol, list) else [tol] * len(jsteps)
    worst = {}
    for i, ((jl, jc), (tl, tc)) in enumerate(zip(jsteps, tsteps)):
        assert tuple(tl.shape) == jl.shape and torch.isfinite(tl).all()
        tleaves = dict(_leaves(tc["scan"]))
        jleaves = dict(_leaves(jc["scan"]))
        assert set(tleaves) == set(jleaves) == {
            "attn/k", "attn/v", "conv", "ssm", "events"}
        worst[f"logits{i}"] = _rel(tl.float().numpy(), jl)
        for name, leaf in tleaves.items():
            want = jleaves[name]
            assert tuple(leaf.shape) == want.shape, name
            assert str(leaf.dtype).split(".")[-1] == str(want.dtype), name
            if name == "events":
                np.testing.assert_array_equal(leaf.numpy(), want)
                continue
            worst[f"{name}{i}"] = _rel(leaf.float().numpy(),
                                       want.astype(np.float32))
    bad = {k: v for k, v in worst.items() if v > tols[int(k[-1])]}
    assert not bad, bad
    return worst


@pytest.mark.parametrize("prompt_len", [12, 40])
def test_reduced_hymba_prefill_and_decode_match_jax_f32(prompt_len):
    """f32 compute: prefill (at 40 tokens the 44-slot cache spans two
    attention chunks of 32, and layer 1's window of 8 binds), then 4 gated
    decode steps; every leaf within 1e-4 of max|JAX|."""
    _compare("float32", 1e-4, prompt_len)


@pytest.mark.parametrize("prompt_len", [12, 40])
def test_reduced_hymba_gated_decode_at_threshold_matches_jax_f32(prompt_len):
    """θ = 0.05: the gated decode drops sub-threshold gates and the MLP
    masks dead tiles, in both packages alike (events exact)."""
    _compare("float32", 1e-4, prompt_len, threshold=0.05)
    jsteps, _ = _run_both("float32", prompt_len, 0.05)
    full = B * 64 * 2                              # B·DI events × 2 layers
    assert 0 < jsteps[-1][1]["scan"]["events"].sum() < full


@pytest.mark.parametrize("prompt_len", [12, 40])
def test_reduced_hymba_prefill_and_decode_match_jax_bf16(prompt_len):
    """The config's own bf16 compute.  Both packages round every matmul
    output, norm and activation to bf16, but not at the same places (XLA's
    CPU backend computes fused bf16 elementwise chains in f32 and rounds
    once, torch rounds after each op), so values land a bf16 step or a few
    apart and the steps add up over 2 layers and 4 decode steps.  How far
    that can go is bf16's own noise, measured as how far the JAX package's
    bf16 run lies from its f32 run: on these inputs up to 7.3e-2 of max at
    the first decode step (prompt 12), while the port lay 5.7e-2 from
    JAX's bf16 there.  So at each step every leaf and the logits lie
    within 3e-2 of max|JAX bf16|, or, at a step where JAX's own bf16 noise
    is larger, within that noise; and over the steps the port's logits lie
    no further from JAX's bf16 logits than JAX's bf16 logits lie from its
    f32 logits.  The f32 test holds the algorithm at 1e-4."""
    jb, tb = _run_both("bfloat16", prompt_len)
    jf, _ = _run_both("float32", prompt_len)
    own = _worst_per_step(
        [(j[0].astype(np.float32), jax.tree.map(
            lambda a: a.astype(np.float32), j[1])) for j in jb], jf)
    worst = _compare("bfloat16", [max(3e-2, o) for o in own], prompt_len)
    assert max(worst.values()) > 0    # the packages round differently
    gap = max(_rel(t[0].float().numpy(), j[0]) for t, j in zip(tb, jb))
    own_logits = max(_rel(j[0], f[0]) for j, f in zip(jb, jf))
    assert gap <= own_logits, (gap, own_logits)


def test_params_from_numpy_checks_keys():
    tree = jax.tree.map(np.array, _jax_params())
    tcfg = get_config("hymba-1.5b").reduced()
    del tree["layers"]["mix"]["mamba"]["a_log"]
    with pytest.raises(KeyError, match="mix/mamba"):
        ttfm.params_from_numpy(tree, tcfg, "cpu")


def test_port_init_params_match_jax_shapes_and_constants():
    """The port's own init: the JAX tree's structure, shapes and dtypes,
    and the same constants (a_log = log(1..N) per channel, ones, zeros)."""
    cfg = get_config("hymba-1.5b").reduced()
    tree = _jax_params()
    mine = ttfm.init_params(0, cfg, "cpu")
    tl, jl = dict(_leaves(mine)), dict(_leaves(tree))
    assert set(tl) == set(jl)
    for name, leaf in tl.items():
        assert tuple(leaf.shape) == jl[name].shape, name
    a_log = jax.tree.map(np.array, jtfm.init_params(
        jax.random.PRNGKey(0), jget_config("hymba-1.5b").reduced())[0])
    a_log = a_log["layers"]["mix"]["mamba"]["a_log"]
    np.testing.assert_allclose(tl["layers/mix/mamba/a_log"].numpy(), a_log,
                               rtol=1e-7)
    assert float(tl["layers/mix/mamba/d_skip"].min()) == 1.0


# ---------------------------------------------------------------------------
# Inside the port (mirrors tests/test_ssm.py's gated-decode contract)
# ---------------------------------------------------------------------------

def _mamba_decode_once(cfg, seed=11):
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    p = tssm.mamba_init(3, cfg, d_inner=cfg.d_model, device="cpu")
    r_ = np.random.default_rng(seed)
    conv = torch.from_numpy(r_.normal(size=(
        2, cfg.ssm.conv_dim - 1, cfg.d_model)).astype(np.float32))
    h = torch.from_numpy(r_.normal(size=(
        2, cfg.d_model, cfg.ssm.state_dim)).astype(np.float32))
    x = torch.from_numpy(r_.normal(size=(2, 1, cfg.d_model))
                         .astype(np.float32))
    return tssm.mamba_step(p, x, cfg, (conv, h))


def test_port_gated_decode_bitwise_at_zero_threshold():
    base = get_config("hymba-1.5b").reduced()
    assert base.mnf.enabled and base.mnf.threshold == 0.0
    with tengine.trace_dispatch() as recs:
        y_g, (cv_g, h_g), n_ev = _mamba_decode_once(base)
    off = dataclasses.replace(base, mnf=dataclasses.replace(base.mnf,
                                                            enabled=False))
    y_d, (cv_d, h_d), n_off = _mamba_decode_once(off)
    assert torch.equal(y_g, y_d) and torch.equal(h_g, h_d) \
        and torch.equal(cv_g, cv_d)
    assert float(n_ev) == 2 * base.d_model and float(n_off) == 0.0
    steps = [r for r in recs if r["op"] == "recurrent_step"]
    assert len(steps) == 1 and steps[0]["chained"] \
        and steps[0]["route"] == "event" and steps[0]["backend"] == "block" \
        and steps[0]["kind"] == "mamba"
    assert not any(r.get("fallback_decode") for r in recs)


def test_port_reduced_hymba_gated_decode_bitwise_ungated():
    """The whole reduced model at threshold 0: gated logits and caches are
    the ungated decode's, bit for bit."""
    cfg = get_config("hymba-1.5b").reduced(compute_dtype="float32")
    off = dataclasses.replace(cfg, mnf=dataclasses.replace(cfg.mnf,
                                                           enabled=False))
    params = ttfm.compute_params(ttfm.init_params(0, cfg, "cpu"), cfg)
    prompts = serve.make_prompts(cfg, 2, 7, 0, "cpu")
    runs = [serve.run_lm(params, c, prompts, 3, keep_logits=True)
            for c in (cfg, off)]
    assert torch.equal(runs[0]["logits"], runs[1]["logits"])
    assert torch.equal(runs[0]["prefill_logits"], runs[1]["prefill_logits"])
    assert runs[0]["events"].shape == (3, 2) and runs[1]["events"] is None
    assert float(runs[0]["events"].min()) == 2 * cfg.d_model


def test_serve_reduced_hymba_on_cpu_prints_stats(capsys):
    serve.main(["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                "--mnf", "--gen", "3", "--prompt-len", "5", "--batch", "2"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = get_config("hymba-1.5b").reduced()
    assert stats["arch"] == "hymba-1.5b" and stats["mnf"] is True
    assert stats["generated"] == 3 and stats["device"] == "cpu"
    assert len(stats["events_per_layer"]) == cfg.num_layers
    assert stats["events_per_token"] == 2 * cfg.d_model * cfg.num_layers

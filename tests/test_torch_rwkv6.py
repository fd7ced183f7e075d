"""The port's RWKV6 serving path against ``repro`` on the CPU: the same
numpy inputs (and the JAX package's own weights, carried across by
``params_from_numpy``) through both packages.

- B7: the port's plain version against ``wkv6_step_events_ref`` and
  ``wkv6_step_events_pallas(interpret=True)`` at 1e-5, with random r, v,
  w, S and a random bonus ``u`` taken per row as ``g % H``.
- ``fire_delta`` and ``live_block_mask``: integer arrays exact; the
  ``recurrent_ineligible_reason`` messages and the ``recurrent_step``
  trace fields verbatim.
- The reduced RWKV6 (2 layers, d_model 64): prefill logits and every cache
  leaf, then 4 teacher-forced decode steps, at 1e-4 in f32 and at the
  stated bf16 tolerance.
- Inside the port: the gated decode at threshold 0 is bitwise the ungated
  decode, events per token fall as the threshold rises, and
  ``python -m repro_torch.launch.serve --reduced --device cpu`` prints its
  stats.
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
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.core import events as jev
from repro.kernels.wkv6.step import (wkv6_step_events_pallas,
                                     wkv6_step_events_ref as j_step_ref)
from repro.models import transformer as jtfm
from repro_torch import engine as tengine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import events as tev
from repro_torch.kernels.wkv6_step.kernel import wkv6_step_cuda
from repro_torch.kernels.wkv6_step.ops import wkv6_step_events
from repro_torch.kernels.wkv6_step.ref import wkv6_step_events_ref
from repro_torch.launch import serve
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm

B, H = 2, 3


def _step_inputs(seed, d):
    """Random (r, k, v, w, u_rows, S) for G = B·H rows; u is (H, D) taken
    per row as g % H, w in (0, 1)."""
    r_ = np.random.default_rng(seed)
    g = B * H
    f = lambda *s: r_.normal(size=s).astype(np.float32)
    r, k, v, s = f(g, d), f(g, d), f(g, d), f(g, d, d)
    w = r_.uniform(0.05, 1.0, size=(g, d)).astype(np.float32)
    u_heads = f(H, d)
    u = np.broadcast_to(u_heads, (B, H, d)).reshape(g, d).copy()
    return r, k, v, w, u, s


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _streams(k, threshold):
    jst = jengine.fire_delta(jnp.asarray(k),
                             jengine.EngineConfig(threshold=threshold))
    tst = tengine.fire_delta(torch.from_numpy(k),
                             tengine.EngineConfig(threshold=threshold))
    return jst, tst


CASES = [(th, d) for th in (0.0, 0.5, 2.0) for d in (16, 64, 20)]


@pytest.mark.parametrize("threshold,d", CASES)
def test_fire_delta_and_live_mask_match_jax(threshold, d):
    _, k, *_ = _step_inputs(d, d)
    jst, tst = _streams(k, threshold)
    assert tst.signed and jst.signed
    assert (tst.blk_m, tst.blk_k, tst.shape) == (jst.blk_m, jst.blk_k,
                                                tuple(jst.shape))
    assert tst.blk_k == min(16, d)
    for name in ("values", "block_idx", "counts"):
        np.testing.assert_array_equal(_np(getattr(tst.events, name)),
                                      np.asarray(getattr(jst.events, name)))
    np.testing.assert_array_equal(_np(tst.fired), np.asarray(jst.fired))
    np.testing.assert_array_equal(_np(tev.live_block_mask(tst.events)),
                                  np.asarray(jev.live_block_mask(jst.events)))
    assert float(tst.num_scalar_events) == float(jst.num_scalar_events)


def test_live_block_mask_ignores_padding_slots():
    """A row with one live block: its padding slots repeat that index, and
    a row with none points at block 0 — neither may mark a block live."""
    vals = np.zeros((2, 3, 1, 4), np.float32)
    vals[0, 0] = 1.0
    idx = np.array([[2, 2, 2], [0, 0, 0]], np.int32)
    cnt = np.array([1, 0], np.int32)
    tb = tev.BlockEvents(torch.from_numpy(vals), torch.from_numpy(idx),
                         torch.from_numpy(cnt), 3)
    jb = jev.BlockEvents(jnp.asarray(vals), jnp.asarray(idx),
                         jnp.asarray(cnt), 3)
    want = [[False, False, True], [False, False, False]]
    assert tev.live_block_mask(tb).tolist() == want
    np.testing.assert_array_equal(np.asarray(jev.live_block_mask(jb)), want)


@pytest.mark.parametrize("threshold,d", CASES)
def test_b7_plain_matches_jax_ref_and_pallas(threshold, d):
    r, k, v, w, u, s = _step_inputs(100 + d, d)
    jst, tst = _streams(k, threshold)
    jargs = [jnp.asarray(a) for a in (r, v, w, u, s)]
    o_ref, s_ref = j_step_ref(jst.events, *jargs, blk_k=jst.blk_k)
    o_pal, s_pal = wkv6_step_events_pallas(jst.events, *jargs,
                                           blk_k=jst.blk_k, interpret=True)
    targs = [torch.from_numpy(a) for a in (r, v, w, u, s)]
    o, s_new = wkv6_step_events(tst.events, *targs, blk_k=tst.blk_k)
    o2, s2 = wkv6_step_events_ref(tst.events, *targs, blk_k=tst.blk_k)
    assert torch.equal(o, o2) and torch.equal(s_new, s2)
    for want_o, want_s in ((o_ref, s_ref), (o_pal, s_pal)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(s_new.numpy(), np.asarray(want_s),
                                   atol=1e-5, rtol=1e-5)
    live = tev.live_block_mask(tst.events).numpy()
    if threshold == 2.0:
        assert not live.all()       # dead blocks: S' = w S exactly there
        dead_rows = np.repeat(~live, tst.blk_k, axis=1)[:, :d]
        dec = (w[..., None] * s)[dead_rows]
        np.testing.assert_array_equal(s_new.numpy()[dead_rows], dec)


def test_b7_launcher_refuses_cpu_tensors():
    z = torch.zeros((1, 4))
    i32 = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wkv6_step_cuda(torch.zeros((1, 1, 1, 4)), i32, i32[0], z, z, z, z,
                       torch.zeros((1, 4, 4)), nkb=1)


@pytest.mark.parametrize("d,nkb", [(64, 4), (20, 3)])
def test_b7_wrapper_launches_on_the_events_with_no_mask(monkeypatch, d,
                                                         nkb):
    """Off the CPU the wrapper hands B7 the events as they are, with their
    K-block count, counts one launch and builds no live mask (the kernel
    derives it).  Meta tensors stand in for the card's (the wrapper's
    meta branch, the dry run's, patched off); the launcher is a stub, and
    ``live_block_mask`` raises if anything calls it.  Then the meta branch
    itself: empty outputs of the kernel's shapes, no launch."""
    from repro_torch.kernels.wkv6_step import ops
    calls = []

    def kernel(*args, nkb):
        calls.append((args, nkb))
        return torch.empty_like(args[3]), torch.empty_like(args[7])

    def no_mask(bev):
        raise AssertionError("the B7 wrapper built a live mask")

    monkeypatch.setattr(ops, "wkv6_step_cuda", kernel)
    monkeypatch.setattr(tev, "live_block_mask", no_mask)
    monkeypatch.setattr(ops, "on_meta", lambda t: False)
    g, e, bk = 6, 2, 16 if d == 64 else 8

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    bev = tev.BlockEvents(meta(g, e, 1, bk), meta(g, e, dtype=torch.int32),
                          meta(g, dtype=torch.int32), nkb)
    rows = [meta(g, d) for _ in range(4)]
    s = meta(g, d, d)
    launches = ops.wkv6_step_events.launches
    o, s_new = ops.wkv6_step_events(bev, *rows, s, blk_k=bk)
    assert ops.wkv6_step_events.launches == launches + 1
    (args, got_nkb), = calls
    want = (bev.values, bev.block_idx, bev.counts, *rows, s)
    assert got_nkb == nkb and len(args) == len(want)
    assert all(a is b for a, b in zip(args, want))
    assert o.shape == (g, d) and s_new.shape == (g, d, d)
    monkeypatch.undo()
    o, s_new = ops.wkv6_step_events(bev, *rows, s, blk_k=bk)
    assert ops.wkv6_step_events.launches == launches + 1 and len(calls) == 1
    assert (o.shape, o.dtype, o.device.type) == ((g, d), torch.float32,
                                                 "meta")
    assert (s_new.shape, s_new.dtype) == ((g, d, d), torch.float32)


def _ineligible_streams(pkg_engine, asarray, k):
    """(name, stream, cfg) of each recurrent_ineligible_reason rule and of
    the dense backend, built alike in either package."""
    kk = asarray(k)
    base = pkg_engine.EngineConfig()
    conv = pkg_engine.EventStream.encode_nhwc(
        asarray(np.abs(k).reshape(1, 2, 3, -1)), blk_k=8)
    conv = dataclasses.replace(conv, signed=True)
    wide = dataclasses.replace(
        pkg_engine.fire(kk, base.replace(blk_m=2, blk_k=8, signed=True)),
        signed=True)
    unsigned = pkg_engine.fire(kk, base.replace(blk_m=1, blk_k=8))
    int8 = pkg_engine.fire(kk, base.replace(blk_m=1, blk_k=8, signed=True,
                                            int8_events=True))
    eligible = pkg_engine.fire_delta(kk, base)
    return [("conv", conv, base), ("blk_m", wide, base),
            ("unsigned", unsigned, base), ("int8", int8, base),
            ("dense", eligible, base.replace(backend="dense")),
            ("eligible", eligible, base)]


def test_recurrent_ineligible_reasons_verbatim():
    k = _step_inputs(3, 16)[1]
    jcases = _ineligible_streams(jengine, jnp.asarray, k)
    tcases = _ineligible_streams(tengine, torch.from_numpy, k)
    for (name, js, jc), (_, ts, tc) in zip(jcases, tcases):
        want = jengine.recurrent_ineligible_reason(js, "wkv6", jc)
        got = tengine.recurrent_ineligible_reason(ts, "wkv6", tc)
        assert got == want, name
        assert (want is None) == (name == "eligible"), (name, want)


TRACE_KEYS = ("op", "kind", "chained", "route", "fallback_decode",
              "routed_dense", "reason", "backend", "route_source",
              "shape_class")


@pytest.mark.parametrize("case", ["event", "dense_backend", "forced_dense",
                                  "unsigned", "zero_rows"])
def test_recurrent_step_trace_and_outputs_match_jax(case):
    d = 16
    r, k, v, w, u, s = _step_inputs(7, d)
    kw = {}
    if case == "dense_backend":
        kw = dict(backend="dense")
    elif case == "forced_dense":
        kw = dict(route="dense")
    out = {}
    for pkg, asarray in ((jengine, jnp.asarray), (tengine, torch.from_numpy)):
        cfg = pkg.EngineConfig(**kw).for_recurrent(d)
        kk = asarray(k[:0] if case == "zero_rows" else k)
        if case == "unsigned":
            st = pkg.fire(kk, cfg.replace(signed=False))
        else:
            st = pkg.fire_delta(kk, cfg)
        rows = 0 if case == "zero_rows" else B * H
        ops = {n: asarray(a[:rows]) for n, a in
               dict(r=r, v=v, w=w, u=u).items()}
        with pkg.trace_dispatch() as recs:
            o, s_new = pkg.recurrent_step("wkv6", st, asarray(s[:rows]), cfg,
                                          **ops)
        out[pkg] = (np.asarray(_np(o)), np.asarray(_np(s_new)),
                    [{key: rec.get(key) for key in TRACE_KEYS}
                     for rec in recs])
    (jo, js, jrecs), (to, ts, trecs) = out[jengine], out[tengine]
    assert trecs == jrecs
    assert len(trecs) == (0 if case == "zero_rows" else 1)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=1e-5)


def test_get_config_names_the_roadmap_item_of_unported_archs():
    """Every architecture of the JAX registry is ported (item 12b brought
    the last two): the port's registry is JAX's, in its order, each config
    equal to JAX's, full and reduced; an unknown name raises."""
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jget_config(arch))
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            jget_config(arch).reduced())
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ---------------------------------------------------------------------------
# The reduced RWKV6 against the JAX package
# ---------------------------------------------------------------------------

PROMPT, STEPS = 12, 4


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    """The JAX package's reduced RWKV6 weights as numpy, with a random
    bonus u (init makes it zero, which would leave Σ r·u·k unexercised)."""
    cfg = jget_config("rwkv6-7b").reduced()
    tree = jax.tree.map(np.array,                 # writable numpy copies
                        jtfm.init_params(jax.random.PRNGKey(seed), cfg)[0])
    r_ = np.random.default_rng(seed)
    tree["layers"]["u"] = (0.5 * r_.normal(
        size=tree["layers"]["u"].shape)).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _run_both(compute_dtype, threshold=0.0):
    tree = _jax_params()
    jcfg = jget_config("rwkv6-7b").reduced(compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(jcfg, mnf=dataclasses.replace(
        jcfg.mnf, threshold=threshold))
    tcfg = get_config("rwkv6-7b").reduced(compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(tcfg, mnf=dataclasses.replace(
        tcfg.mnf, threshold=threshold))
    r_ = np.random.default_rng(1)
    prompt = r_.integers(0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    teach = r_.integers(0, tcfg.vocab_size, (B, STEPS)).astype(np.int32)

    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg))(
        jparams, jnp.asarray(prompt))
    jsteps = [(np.asarray(jl), jax.tree.map(np.asarray, jc))]
    dstep = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
    for i in range(STEPS):
        jl, jc = dstep(jparams, jc, jnp.asarray(teach[:, i:i + 1]),
                       jnp.asarray(PROMPT + i, jnp.int32))
        jsteps.append((np.asarray(jl), jax.tree.map(np.asarray, jc)))

    tparams = ttfm.compute_params(
        ttfm.params_from_numpy(tree, tcfg, "cpu"), tcfg)
    tl, tc = ttfm.prefill(tparams, torch.from_numpy(prompt).long(), tcfg)
    tsteps = [(tl, tc)]
    for i in range(STEPS):
        tl, tc = ttfm.decode_step(tparams, tc,
                                  torch.from_numpy(teach[:, i:i + 1]).long(),
                                  PROMPT + i, tcfg)
        tsteps.append((tl, tc))
    return jsteps, tsteps


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _compare(compute_dtype, tol, threshold=0.0):
    """Prefill (step 0) and each teacher-forced decode step: logits and
    every cache leaf within ``tol`` of max|JAX| (events exactly)."""
    jsteps, tsteps = _run_both(compute_dtype, threshold)
    worst = {}
    for i, ((jl, jc), (tl, tc)) in enumerate(zip(jsteps, tsteps)):
        assert tuple(tl.shape) == jl.shape and torch.isfinite(tl).all()
        assert set(tc["scan"]) == set(jc["scan"])
        worst[f"logits{i}"] = _rel(tl.float().numpy(), jl)
        for name, leaf in tc["scan"].items():
            want = jc["scan"][name]
            assert tuple(leaf.shape) == want.shape, name
            assert str(leaf.dtype).split(".")[-1] == str(want.dtype), name
            if name == "events":
                np.testing.assert_array_equal(leaf.numpy(), want)
                continue
            worst[f"{name}{i}"] = _rel(leaf.float().numpy(),
                                       want.astype(np.float32))
    bad = {k: v for k, v in worst.items() if v > tol}
    assert not bad, bad
    return worst


def test_reduced_rwkv6_prefill_and_decode_match_jax_f32():
    """f32 compute: prefill (chunked, 2 chunks of 8 with padding), then 4
    gated decode steps, every leaf within 1e-4 of max|JAX|."""
    _compare("float32", 1e-4)


def test_reduced_rwkv6_gated_decode_at_threshold_matches_jax_f32():
    """θ = 0.5: the gated decode drops sub-threshold keys and the channel
    mix masks dead tiles, in both packages alike (events exact)."""
    _compare("float32", 1e-4, threshold=0.5)
    jsteps, _ = _run_both("float32", 0.5)
    full = B * 4 * 16 * 2                          # B·H·D events × 2 layers
    assert 0 < jsteps[-1][1]["scan"]["events"].sum() < full


def test_reduced_rwkv6_prefill_and_decode_match_jax_bf16():
    """The config's own bf16 compute.  Both packages round every matmul
    output, lerp and activation to bf16 (a relative step of 2**-8), but
    not at the same places: XLA's CPU backend computes fused bf16
    elementwise chains in f32 and rounds once, torch rounds after each op.
    So values land a bf16 step or a few apart and the steps add up over
    2 layers and 4 decode steps.  The scale of that noise is bf16's own:
    the JAX package's bf16 logits lie up to 4.3e-2 of max from its f32
    logits on these inputs.  So: every leaf within 3e-2 of max|JAX bf16|
    (the port measured 2.5e-2 at worst), and the port's bf16 logits no
    further from JAX's bf16 logits than bf16 rounding moves JAX's own
    (from its f32 logits).  The f32 test above holds the algorithm at
    1e-4."""
    worst = _compare("bfloat16", 3e-2)
    assert max(worst.values()) > 0    # the packages round differently
    jb, tb = _run_both("bfloat16")
    jf, _ = _run_both("float32")
    gap = max(_rel(t[0].float().numpy(), j[0]) for t, j in zip(tb, jb))
    own = max(_rel(j[0], f[0]) for j, f in zip(jb, jf))
    assert gap <= own, (gap, own)


# ---------------------------------------------------------------------------
# Inside the port (mirrors tests/test_ssm.py's gated-decode tests)
# ---------------------------------------------------------------------------

def _rwkv_decode_once(cfg, seed=11):
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    p = tssm.rwkv6_block_init(7, cfg, "cpu")
    p["u"] = torch.randn(p["u"].shape, generator=torch.Generator()
                         .manual_seed(3))
    r_ = np.random.default_rng(seed)
    x = torch.from_numpy(r_.normal(size=(2, 6, cfg.d_model))
                         .astype(np.float32))
    _, state = tssm.rwkv6_block_apply(p, x, cfg)
    tok = torch.from_numpy(r_.normal(size=(2, 1, cfg.d_model))
                           .astype(np.float32))
    return tssm.rwkv6_block_decode(p, tok, cfg, state)


def test_port_gated_decode_bitwise_at_zero_threshold():
    base = get_config("rwkv6-7b").reduced()
    assert base.mnf.enabled and base.mnf.threshold == 0.0
    with tengine.trace_dispatch() as recs:
        y_gated, st_gated = _rwkv_decode_once(base)
    off = dataclasses.replace(base, mnf=dataclasses.replace(base.mnf,
                                                            enabled=False))
    y_dense, st_dense = _rwkv_decode_once(off)
    assert torch.equal(y_gated, y_dense)
    assert torch.equal(st_gated["wkv"], st_dense["wkv"])
    assert float(st_gated["events"]) == 2 * base.num_heads * base.head_dim
    steps = [r for r in recs if r["op"] == "recurrent_step"]
    assert len(steps) == 1 and steps[0]["chained"] \
        and steps[0]["route"] == "event" and steps[0]["backend"] == "block"
    assert not any(r.get("fallback_decode") for r in recs)


def test_port_events_per_token_monotone_in_threshold():
    base = get_config("rwkv6-7b").reduced()
    counts = []
    for th in (0.0, 0.1, 0.5, 2.0):
        cfg = dataclasses.replace(base, mnf=dataclasses.replace(
            base.mnf, threshold=th))
        _, st = _rwkv_decode_once(cfg)
        counts.append(float(st["events"]))
    assert counts == sorted(counts, reverse=True), counts
    assert counts[0] > counts[-1], counts


def test_serve_reduced_on_cpu_prints_stats(capsys):
    serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                "--mnf", "--gen", "3", "--prompt-len", "5", "--batch", "2"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = get_config("rwkv6-7b").reduced()
    assert stats["arch"] == "rwkv6-7b" and stats["mnf"] is True
    assert stats["generated"] == 3 and stats["device"] == "cpu"
    assert stats["decode_tok_per_s"] > 0 and stats["prefill_s"] >= 0
    per_layer = 2 * cfg.num_heads * cfg.head_dim    # θ = 0: every key fires
    assert stats["events_per_layer"] == [float(per_layer)] * cfg.num_layers
    assert stats["events_per_token"] == stats["events_per_token_min"] \
        == stats["events_per_token_max"] == per_layer * cfg.num_layers


def test_run_lm_teacher_forcing_replays_the_inputs():
    cfg = serve.lm_config("rwkv6-7b", reduced=True)
    params = ttfm.compute_params(ttfm.init_params(0, cfg, "cpu"), cfg)
    prompts = serve.make_prompts(cfg, 2, 5, 0, "cpu")
    free = serve.run_lm(params, cfg, prompts, 3, keep_logits=True)
    assert torch.equal(free["inputs"][:, 1:], free["tokens"][:, :-1])
    forced = serve.run_lm(params, cfg, prompts, 3, teacher=free["inputs"],
                          keep_logits=True)
    assert torch.equal(forced["logits"], free["logits"])
    assert free["events"].shape == (3, cfg.num_layers)

"""Int8 event values in the port against the JAX package (DESIGN.md §12):
the same numpy inputs through both.  Scales, zero points, codes, event
addresses and counts are exactly equal; float outputs of the kernels' plain
versions are held at the tolerance each test states; whole forwards at
5e-3 and 1e-4·max|logits| (tests/test_conv_chain.py's tolerance and
tests/test_torch_cnn.py's tighter one), with chained == fake-quant round
trip bitwise inside the port."""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import events as jev
from repro.core.fire import FireConfig as JFireConfig
from repro.kernels.event_conv.kernel import event_conv_int8_pallas
from repro.kernels.event_conv.ref import fused_event_conv2d_ref
from repro.kernels.event_matmul.ops import event_matmul_int8 as j_mm_int8
from repro.kernels.event_matmul.ref import event_matmul_int8_ref as j_mm_ref
from repro.models import cnn as jcnn
from repro_torch import engine as tengine
from repro_torch.core import events as tev
from repro_torch.core import quantize as tqz
from repro_torch.core.fire import FireConfig
from repro_torch.kernels.event_conv.ops import (event_conv, event_conv_dequant,
                                                strip_conv_inputs)
from repro_torch.kernels.event_matmul.ops import (event_matmul,
                                                  event_matmul_dequant,
                                                  event_matmul_int8)
from repro_torch.models import cnn as tcnn
from test_torch_cnn import _vgg16_small  # the 32-px VGG16 topology

# by module path: ``repro.core`` re-exports the function ``quantize`` under
# the module's name
jqz = importlib.import_module("repro.core.quantize")

def _fired(seed, shape, sparsity=0.5):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape) * (r.random(shape) > sparsity)
    return np.maximum(x, 0).astype(np.float32)


def _jit(fn, *args, **static):
    """One compiled JAX call (eager dispatch compiles op by op)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _tqp(jqp):
    return tqz.QParams(scale=torch.tensor(np.asarray(jqp.scale)),
                       zero_point=torch.tensor(np.asarray(jqp.zero_point)))


def _codes(seed, shape, sparsity=0.5):
    """A fired map, its symmetric QParams and int8 codes, computed by the
    JAX package (numpy out)."""
    x = _fired(seed, shape, sparsity)
    qp = jqz.calibrate(jnp.asarray(x))
    return x, qp, np.array(jqz.quantize(jnp.asarray(x), qp))


# -- core/quantize ---------------------------------------------------------------

@pytest.mark.parametrize("shape,sparsity,signed,symmetric", [
    ((64, 96), 0.5, False, True), ((8, 1000), 0.9, True, True),
    ((3, 5, 7), 1.0, False, True),           # all zero: amax clamps to 1e-8
    ((64, 96), 0.3, True, False), ((16, 16), 0.0, False, False),
])
def test_quantize_matches_jax_exactly(shape, sparsity, signed, symmetric):
    """calibrate/quantize/dequantize/fake_quant on one array: the same
    scale, zero point, codes and floats in both packages (exact)."""
    r = np.random.default_rng(len(shape) + int(10 * sparsity))
    x = (r.normal(size=shape) * (r.random(shape) > sparsity))
    x = (x if signed else np.abs(x)).astype(np.float32)
    jqp = jqz.calibrate(jnp.asarray(x), symmetric=symmetric)
    tqp = tqz.calibrate(torch.from_numpy(x), symmetric=symmetric)
    assert tqp.scale.dtype == torch.float32
    assert tqp.zero_point.dtype == torch.int32
    assert tqp.scale.item() == float(jqp.scale)
    assert tqp.zero_point.item() == int(jqp.zero_point)
    q = tqz.quantize(torch.from_numpy(x), tqp)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jqz.quantize(jnp.asarray(x),
                                                          jqp)))
    np.testing.assert_array_equal(
        tqz.dequantize(q, tqp).numpy(),
        np.asarray(jqz.dequantize(jnp.asarray(q.numpy()), jqp)))
    np.testing.assert_array_equal(
        tqz.fake_quant(torch.from_numpy(x), tqp).numpy(),
        np.asarray(jqz.fake_quant(jnp.asarray(x), jqp)))


def test_requantize_accumulator_matches_jax_exactly():
    r = np.random.default_rng(3)
    acc = (r.normal(size=(32, 48)) * 40).astype(np.float32)
    j_in, j_w = jqz.QParams.symmetric(0.02), jqz.QParams.symmetric(0.5)
    j_out = jqz.calibrate(jnp.asarray(acc) * 0.01)
    t_in, t_w = tqz.QParams.symmetric(0.02), tqz.QParams.symmetric(0.5)
    t_out = _tqp(j_out)
    np.testing.assert_array_equal(
        tqz.requantize_accumulator(torch.from_numpy(acc), t_in, t_w,
                                   t_out).numpy(),
        np.asarray(jqz.requantize_accumulator(jnp.asarray(acc), j_in, j_w,
                                              j_out)))
    np.testing.assert_array_equal(
        tqz.dequantize_accumulator(torch.from_numpy(acc), t_in, t_w).numpy(),
        np.asarray(jqz.dequantize_accumulator(jnp.asarray(acc), j_in, j_w)))


# -- the int8 fire ---------------------------------------------------------------

@pytest.mark.parametrize("conv,blk_m,threshold", [
    (False, 8, 0.0), (False, 4, 0.3), (True, 1, 0.0), (True, 8, 0.1),
])
def test_fire_int8_matches_jax_exactly(conv, blk_m, threshold):
    """engine.fire / fire_conv with int8_events: the same codes, block
    addresses, counts and scale as the JAX package, and the kept twin is the
    dequantized map."""
    acc = np.random.default_rng(blk_m).normal(
        size=(2, 4, 16, 16)).astype(np.float32)
    tcfg = tengine.EngineConfig(blk_m=blk_m, blk_k=8, threshold=threshold,
                                int8_events=True)
    jcfg = jengine.EngineConfig(backend="block", blk_m=blk_m, blk_k=8,
                                threshold=threshold, int8_events=True)
    if conv:
        ts = tengine.fire_conv(torch.from_numpy(acc), tcfg, blk_m=blk_m)
        js = jengine.fire_conv(jnp.asarray(acc), jcfg, blk_m=blk_m)
        assert ts.logical_shape == js.logical_shape == acc.shape
    else:
        a2 = acc.reshape(-1, 16)
        ts = tengine.fire(torch.from_numpy(a2), tcfg)
        js = jengine.fire(jnp.asarray(a2), jcfg)
    assert ts.events.values.dtype == torch.int8
    for a, b in ((ts.events.values, js.events.values),
                 (ts.events.block_idx, js.events.block_idx),
                 (ts.events.counts, js.events.counts)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ts.qparams.scale.item() == float(js.qparams.scale)
    assert ts.qparams.zero_point.item() == 0 == int(js.qparams.zero_point)
    np.testing.assert_array_equal(ts.fired.numpy(), np.asarray(js.fired))
    # the twin is the dequantized map, and the events decode to it
    assert torch.equal(ts.fired, tqz.dequantize(
        tqz.quantize(ts.fired, ts.qparams), ts.qparams))
    assert torch.equal(dataclasses.replace(ts, fired=None).dense(), ts.fired)


# -- int8 codes keep their dtype through every event-domain move ------------------

@pytest.mark.parametrize("blk_m", [1, tev.STRIP_W])
def test_int8_codes_keep_dtype_through_encode_gather_remap_retile(blk_m):
    """The counterpart of tests/test_retile.py's int8 test, array for array
    with the JAX package.  ``torch.where(mask, int8, 0.0)`` promotes to
    f32, which the encode, decode, remap and re-tile zeroed their padding
    with; every one of them now keeps the codes int8."""
    b, h, w, c = 2, 3, 8, 8
    _, _, q = _codes(7, (b, h, w, c))
    a = q.reshape(b * h * w, c)
    tb = tev.encode_block_events(torch.from_numpy(a), blk_m=blk_m, blk_k=4)
    jb = jev.encode_block_events(jnp.asarray(a), blk_m=blk_m, blk_k=4)

    def same(t, j):
        assert t.values.dtype == torch.int8
        for x, y in ((t.values, j.values), (t.block_idx, j.block_idx),
                     (t.counts, j.counts)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    same(tb, jb)
    dec = tev.decode_block_events(tb, blk_m=blk_m, blk_k=4, m=a.shape[0],
                                  k=c)
    assert dec.dtype == torch.int8 and np.array_equal(dec.numpy(), a)
    g = tb.block_idx.shape[0]
    idx = np.arange(g)[::-1].copy()
    live = np.arange(g) % 3 != 0
    same(tev.gather_row_groups(tb, torch.from_numpy(idx),
                               torch.from_numpy(live)),
         jev.gather_row_groups(jb, jnp.asarray(idx), jnp.asarray(live)))
    rt = tev.retile_block_events(tb, (b, h, w, c), blk_m)
    same(rt, jev.retile_block_events(jb, (b, h, w, c), blk_m))
    same(rt, jev.encode_block_events(jnp.asarray(q.reshape(b, -1)), blk_m=1,
                                     blk_k=4, capacity=rt.capacity))
    if blk_m == tev.STRIP_W:
        for shift, stride in ((-3, 1), (2, 2), (5, 4)):
            t = tev.remap_rows(tb.values, shift, stride)
            assert t.dtype == torch.int8
            j = jev.gather_row_strips(jb, jnp.arange(g), jnp.ones(g, bool),
                                      shift, row_stride=stride)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j.values))


def test_int8_stream_retile_and_dense_carry_qparams():
    x = _fired(11, (1, 2, 8, 8), 0.4)
    cfg = tengine.EngineConfig(blk_k=4, int8_events=True)
    s = tengine.fire_conv(torch.from_numpy(x), cfg, blk_m=1)
    rt = s.retile_fc()
    assert rt.qparams is s.qparams and rt.events.values.dtype == torch.int8
    assert torch.equal(rt.dense(), s.dense().reshape(1, -1))
    bare = dataclasses.replace(rt, fired=None)
    assert torch.equal(bare.dense(), rt.dense())      # decode + dequantize
    dq = s.dequantize_events()
    assert dq.qparams is None and dq.events.values.dtype == torch.float32
    assert torch.equal(dq.events.values,
                       tqz.dequantize(s.events.values, s.qparams))


# -- B5: the int8 event matmul's plain version ---------------------------------------

@pytest.mark.parametrize("m,k,n,bm,bk,sp", [
    (8, 128, 64, 8, 128, 0.5), (16, 64, 24, 8, 16, 0.6),
    (5, 33, 10, 8, 16, 0.0), (6, 32, 24, 1, 8, 1.0),
])
def test_event_matmul_int8_plain_matches_jax(m, k, n, bm, bk, sp):
    """The port's ``event_matmul_int8`` (encode + B5's plain version)
    against ``repro``'s in interpret mode and its dense oracle, at the
    1e-5 relative tolerance of two f32 sums in different orders (the JAX
    test allows 1e-3); and bitwise B2's plain version on the dequantized
    tiles."""
    r = np.random.default_rng(m * k)
    a = (r.normal(size=(m, k)) * (r.random((m, k)) > sp)).astype(np.float32)
    jqp = jqz.calibrate(jnp.asarray(a))
    q = np.array(jqz.quantize(jnp.asarray(a), jqp))
    w = r.normal(size=(k, n)).astype(np.float32)
    y = event_matmul_int8(torch.from_numpy(q), torch.from_numpy(w),
                          _tqp(jqp), blk_m=bm, blk_k=bk)
    jy = np.asarray(j_mm_int8(jnp.asarray(q), jnp.asarray(w), jqp, blk_m=bm,
                              blk_k=bk, blk_n=8, interpret=True))
    qpad = jev.pad_to_block_multiple(jev.pad_to_block_multiple(
        jnp.asarray(q), bm, 0), bk, 1)
    ref = np.asarray(_jit(j_mm_ref, qpad,
                          jev.pad_to_block_multiple(jnp.asarray(w), bk, 0),
                          jqp, blk_m=bm, blk_k=bk))[:m, :n]
    scale = max(float(np.abs(ref).max()), 1e-30)
    for other in (jy, ref):
        np.testing.assert_allclose(y.numpy(), other, rtol=0,
                                   atol=1e-5 * scale)
    tb = tev.encode_block_events(torch.from_numpy(np.array(qpad)),
                                 blk_m=bm, blk_k=bk)
    wp = torch.from_numpy(np.array(jev.pad_to_block_multiple(
        jnp.asarray(w), bk, 0)))
    tqp = _tqp(jqp)
    y8 = event_matmul_dequant(tb.values, tb.block_idx, tb.counts, tqp.scale,
                              tqp.zero_point, wp)
    y32 = event_matmul(tqz.dequantize(tb.values, tqp), tb.block_idx,
                       tb.counts, wp)
    assert torch.equal(y8, y32)


# -- B6: the int8 strip conv's plain version ------------------------------------------

@pytest.mark.parametrize("shape,k,p,s,co,zp", [
    ((1, 4, 16, 8), 3, 1, 1, 8, 0),
    ((1, 6, 16, 4), 3, 1, 2, 16, 0),
    ((1, 8, 32, 3), 3, 1, 4, 8, 0),
    ((1, 6, 16, 8), 3, 1, 2, 8, 5),          # non-zero zero point
])
def test_event_conv_int8_plain_matches_jax(shape, k, p, s, co, zp):
    """B6's plain version against ``event_conv_int8_pallas`` in interpret
    mode on the same plan, codes and QParams (and, at zero point 0,
    against the JAX block twin on the int8 stream), at 2e-4 — the
    tolerance of the f32 test in tests/test_torch_kernels.py.  Inside the
    port it is bitwise B3's plain version on the dequantized tiles, which
    dequantize before the remap: unsourced rows stay 0 at any zero
    point."""
    x, jqp, q = _codes(k * s + zp, shape)
    if zp:
        jqp = jqz.QParams(scale=jqp.scale, zero_point=jnp.int32(zp))
    tqp = _tqp(jqp)
    wt = np.random.default_rng(co).normal(
        size=(k, k, shape[3], co)).astype(np.float32)
    bk = min(8, shape[3])
    ts = tengine.EventStream.encode_nhwc(torch.from_numpy(q), blk_k=bk,
                                         blk_m=tev.STRIP_W, keep_dense=False)
    assert ts.events.values.dtype == torch.int8
    args, nkb = strip_conv_inputs(ts, torch.from_numpy(wt), stride=s,
                                  padding=p)
    y = event_conv_dequant(*args[:6], tqp.scale, tqp.zero_point, args[6],
                           nkb=nkb, row_stride=s)
    jy = np.asarray(event_conv_int8_pallas(
        *(jnp.asarray(a.numpy()) for a in args[:6]), jqp.scale,
        jqp.zero_point, jnp.asarray(args[6].numpy()), nkb=nkb, blk_n=co,
        row_stride=s, interpret=True))
    np.testing.assert_allclose(y.numpy(), jy, atol=2e-4, rtol=2e-4)
    deq = tqz.dequantize(args[0], tqp)
    assert torch.equal(y, event_conv(deq, *args[1:], nkb=nkb, row_stride=s))
    if not zp:
        js = jengine.EventStream.encode_nhwc(jnp.asarray(q), blk_k=bk,
                                             blk_m=jev.STRIP_W,
                                             keep_dense=False)
        js = dataclasses.replace(js, qparams=jqp)
        ref = _jit(fused_event_conv2d_ref, js, jnp.asarray(wt), stride=s,
                   padding=p)
        np.testing.assert_allclose(y.numpy().reshape(-1, co)[:ref.shape[0]],
                                   np.asarray(ref), atol=2e-4, rtol=2e-4)


# -- whole forwards: MINI, MINI_S4, the 32-px VGG16 topology in int8 ----------------

SPECS = {"mini": (jcnn.MINI, tcnn.MINI),
         "mini_s4": (jcnn.MINI_S4, tcnn.MINI_S4),
         "vgg16_small": (_vgg16_small(jcnn), _vgg16_small(tcnn))}


def _key(r):
    return (r["op"], r.get("route"), r.get("strip"), r.get("launches"),
            r.get("chained"), r.get("retile"))


@functools.lru_cache(maxsize=None)
def _run(name):
    jspec, tspec = SPECS[name]
    # He weights as numpy from a seeded torch.Generator (jax.random would
    # compile per shape, most of this test's time on the CPU)
    params = [None if p is None else p.numpy() for p in tcnn.init_cnn_params(
        tspec, torch.Generator().manual_seed(7), weight_sparsity=0.5)]
    size = jspec.input_size
    x = np.maximum(np.random.default_rng(7).normal(size=(2, size, size, 3)),
                   0).astype(np.float32)
    with jengine.trace_dispatch() as jrecs:
        yj = np.asarray(jax.jit(functools.partial(
            jcnn.cnn_forward, spec=jspec,
            fire_cfg=JFireConfig(quantize_to_int8=True)))(params,
                                                          jnp.asarray(x)))
    tparams = tcnn.params_from_numpy(params)
    fire_cfg = FireConfig(quantize_to_int8=True)
    with tengine.trace_dispatch() as trecs:
        yc = tcnn.cnn_forward(tparams, torch.from_numpy(x), tspec,
                              fire_cfg=fire_cfg, device="cpu")
    yr = tcnn.cnn_forward(tparams, torch.from_numpy(x), tspec, chain=False,
                          fire_cfg=fire_cfg, device="cpu")
    y32 = tcnn.cnn_forward(tparams, torch.from_numpy(x), tspec,
                           device="cpu")
    return dict(yj=yj, yc=yc, yr=yr, y32=y32, jrecs=jrecs, trecs=trecs,
                tspec=tspec)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_int8_forward_matches_jax(name):
    """Logits against ``repro``'s int8 forward on the block backend, at
    5e-3 and at 1e-4·max|logits|: the codes agree exactly (test above), so
    only the order of f32 sums differs."""
    r = _run(name)
    assert r["yc"].shape == r["yj"].shape
    assert torch.isfinite(r["yc"]).all()
    np.testing.assert_allclose(r["yc"].numpy(), r["yj"], atol=5e-3,
                               rtol=5e-3)
    scale = float(np.abs(r["yj"]).max())
    assert float(np.abs(r["yc"].numpy() - r["yj"]).max()) <= 1e-4 * scale
    # int8 really ran: the logits moved off the f32 forward's
    assert not torch.equal(r["yc"], r["y32"])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_int8_trace_sequence_matches_jax(name):
    r = _run(name)
    assert [_key(x) for x in r["trecs"]] == [_key(x) for x in r["jrecs"]]
    assert not any(x.get("fallback_decode") or x.get("decode")
                   for x in r["trecs"])
    fire_cfg = FireConfig(quantize_to_int8=True)
    assert tcnn.chain_boundary_summary(r["tspec"], batch=2,
                                       fire_cfg=fire_cfg)["densify"] == 0


@pytest.mark.parametrize("name", sorted(SPECS))
def test_int8_chained_equals_fake_quant_round_trip_bitwise(name):
    r = _run(name)
    assert torch.equal(r["yc"], r["yr"]), "int8 chain != fake-quant twin"


def test_int8_events_ride_the_vgg16_chain(monkeypatch):
    """Every stream after the first conv carries int8 codes with QParams:
    the strip conv, per-tap conv, pools and FC layers get codes (through
    the B5/B6 wrappers' plain versions, which count no launch)."""
    _, tspec = SPECS["vgg16_small"]
    gen = torch.Generator().manual_seed(3)
    params = tcnn.init_cnn_params(tspec, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((1, 32, 32, 3), generator=gen))
    cfg = tengine.EngineConfig(int8_events=True)
    seen = []

    def spy(fn):
        def wrapped(x, *a, **kw):
            if isinstance(x, tengine.EventStream):
                seen.append((fn.__name__, x.events.values.dtype,
                             x.qparams is not None))
            return fn(x, *a, **kw)
        return wrapped

    for name in ("conv2d", "linear", "maxpool2d"):
        monkeypatch.setattr(tengine, name, spy(getattr(tengine, name)))
    counts = (event_matmul_dequant.launches, event_conv_dequant.launches)
    tcnn.cnn_forward(params, x, tspec, engine_cfg=cfg, device="cpu")
    # CPU tensors take the plain versions: no launch is counted
    assert counts == (event_matmul_dequant.launches,
                      event_conv_dequant.launches)
    assert seen[0] == ("conv2d", torch.float32, False)     # the encoded input
    assert all(dt == torch.int8 and q for _, dt, q in seen[1:]), seen
    assert {n for n, _, _ in seen} == {"conv2d", "linear", "maxpool2d"}

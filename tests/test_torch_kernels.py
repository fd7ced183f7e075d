"""The port's plain kernel versions against the JAX package's kernels: the
same numpy inputs through both.  B1-B3 are held against the Pallas kernels
in interpret mode and their refs; B4 against the JAX block refs only (the
JAX Pallas pools do not run on the installed jax, ROADMAP C.r1).  Integer
outputs exact; floats at the tolerance of the matching JAX test."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import events as jev
from repro.kernels.event_conv.ops import fused_event_conv2d as j_fused_conv
from repro.kernels.event_conv.ref import fused_event_conv2d_ref
from repro.kernels.event_matmul.kernel import event_matmul_pallas
from repro.kernels.event_matmul.ref import event_matmul_ref as j_mm_ref
from repro.kernels.event_pool.ref import (event_max_pool2d_ref,
                                          event_max_pool2d_window_ref)
from repro.kernels.fire_compact.kernel import fire_compact_pallas
from repro.kernels.fire_compact.ops import fire_and_encode as j_fire_encode
from repro.kernels.fire_compact.ref import fire_compact_ref as j_fire_ref
from repro_torch import engine as tengine
from repro_torch.core import events as tev
from repro_torch.kernels.event_conv.ops import (event_conv,
                                                fused_event_conv2d,
                                                strip_conv_inputs)
from repro_torch.kernels.event_matmul.ops import event_matmul
from repro_torch.kernels.event_matmul.ref import event_matmul_ref
from repro_torch.kernels.event_pool.ops import (event_max_pool2d,
                                                event_max_pool2d_window,
                                                event_pool, event_pool_window)
from repro_torch.kernels.fire_compact.ops import (fire_and_encode,
                                                  fire_compact)


def _fired(seed, shape, sparsity=0.5):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape) * (r.random(shape) > sparsity)
    return np.maximum(x, 0).astype(np.float32)


def _jit(fn, *args, **static):
    """One compiled JAX call (eager dispatch compiles op by op)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- B1 fire_compact ---------------------------------------------------------

@pytest.mark.parametrize("m,k,bm,bk,thr,mag,qs", [
    (16, 64, 8, 8, 0.0, False, None),
    (8, 256, 4, 128, 0.5, True, None),
    (16, 32, 1, 8, 0.0, False, 0.05),
])
def test_fire_compact_plain_matches_pallas(m, k, bm, bk, thr, mag, qs):
    acc = np.random.default_rng(m + k).normal(size=(m, k)).astype(np.float32)
    kw = dict(blk_m=bm, blk_k=bk, threshold=thr, magnitude=mag, qscale=qs)
    fired, occ = fire_compact(torch.from_numpy(acc), **kw)
    jf, jo = fire_compact_pallas(jnp.asarray(acc), interpret=True, **kw)
    rf, ro = _jit(j_fire_ref, jnp.asarray(acc), **kw)
    for f, o in ((jf, jo), (rf, ro)):
        np.testing.assert_array_equal(fired.numpy(), _np(f))
        np.testing.assert_array_equal(occ.numpy(), _np(o))
    assert occ.dtype == torch.int32
    if qs is None:
        tf, tb = fire_and_encode(torch.from_numpy(acc), blk_m=bm, blk_k=bk,
                                 threshold=thr, magnitude=mag)
        jf2, jb = _jit(j_fire_encode, jnp.asarray(acc), blk_m=bm, blk_k=bk,
                       threshold=thr, magnitude=mag, interpret=True)
        np.testing.assert_array_equal(tf.numpy(), _np(jf2))
        for a, b in ((tb.values, jb.values), (tb.block_idx, jb.block_idx),
                     (tb.counts, jb.counts)):
            np.testing.assert_array_equal(a.numpy(), _np(b))


# -- B2 event_matmul ---------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bm,bk,sp", [
    (8, 64, 40, 8, 8, 0.5), (6, 32, 24, 1, 8, 0.9), (4, 256, 16, 4, 128, 0.3),
    (8, 16, 8, 8, 8, 1.0),
])
def test_event_matmul_plain_matches_pallas(m, k, n, bm, bk, sp):
    r = np.random.default_rng(n)
    a = (r.normal(size=(m, k)) * (r.random((m, k)) > sp)).astype(np.float32)
    w = r.normal(size=(k, n)).astype(np.float32)
    tb = tev.encode_block_events(torch.from_numpy(a), blk_m=bm, blk_k=bk)
    y = event_matmul(tb.values, tb.block_idx, tb.counts, torch.from_numpy(w))
    assert y.shape == (m // bm, bm, n)
    jy = event_matmul_pallas(jnp.asarray(tb.values.numpy()),
                             jnp.asarray(tb.block_idx.numpy()),
                             jnp.asarray(tb.counts.numpy()), jnp.asarray(w),
                             blk_n=8, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-3,
                               rtol=1e-3)
    ref = _jit(j_mm_ref, jnp.asarray(a), jnp.asarray(w), blk_m=bm, blk_k=bk)
    np.testing.assert_allclose(y.numpy().reshape(m, n), np.asarray(ref),
                               atol=1e-3, rtol=1e-3)


def test_event_matmul_tile_dot_is_row_invariant():
    """The plain tile dot sums each row in the same fixed order whatever
    the other rows hold: an 8-row tile and its rows one at a time agree
    bitwise (the M-invariance the strip == per-tap contract rests on)."""
    r = np.random.default_rng(5)
    a = _fired(5, (8, 64))
    w = torch.from_numpy(r.normal(size=(64, 32)).astype(np.float32))
    strip = tev.encode_block_events(torch.from_numpy(a), blk_m=8, blk_k=8)
    pix = tev.encode_block_events(torch.from_numpy(a), blk_m=1, blk_k=8)
    ys = event_matmul_ref(strip.values, strip.block_idx, strip.counts, w)
    yp = event_matmul_ref(pix.values, pix.block_idx, pix.counts, w)
    assert torch.equal(ys.reshape(8, 32), yp.reshape(8, 32))


# -- B3 event_conv -------------------------------------------------------------

def _streams(x, bk):
    ts = tengine.EventStream.encode_nhwc(torch.from_numpy(x), blk_k=bk,
                                         blk_m=tev.STRIP_W, keep_dense=False)
    js = jengine.EventStream.encode_nhwc(jnp.asarray(x), blk_k=bk,
                                         blk_m=jev.STRIP_W, keep_dense=False)
    return ts, js


@pytest.mark.parametrize("shape,k,p,s,co,pallas", [
    ((1, 4, 16, 8), 3, 1, 1, 8, True),
    ((1, 6, 16, 4), 3, 1, 2, 16, True),
    ((1, 8, 32, 3), 3, 1, 4, 8, False),
])
def test_event_conv_plain_matches_pallas_and_ref(shape, k, p, s, co, pallas):
    x = _fired(k * s, shape)
    wt = np.random.default_rng(co).normal(
        size=(k, k, shape[3], co)).astype(np.float32)
    bk = min(8, shape[3])
    ts, js = _streams(x, bk)
    args, nkb = strip_conv_inputs(ts, torch.from_numpy(wt), stride=s,
                                  padding=p)
    y = event_conv(*args, nkb=nkb, row_stride=s).reshape(-1, co)
    n_out = y.shape[0]
    ref = _jit(fused_event_conv2d_ref, js, jnp.asarray(wt), stride=s,
               padding=p)
    np.testing.assert_allclose(y.numpy()[:ref.shape[0]], np.asarray(ref),
                               atol=2e-4, rtol=2e-4)
    assert n_out == ref.shape[0]
    if pallas:
        jy = _jit(j_fused_conv, js, jnp.asarray(wt), stride=s, padding=p,
                  blk_n=8, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("shape,k,p,s", [
    ((2, 5, 16, 8), 3, 1, 1), ((1, 6, 16, 8), 3, 1, 2),
    ((1, 8, 32, 8), 3, 1, 4), ((1, 4, 16, 8), 1, 0, 2),
])
def test_strip_bitwise_equals_pertap_in_port(shape, k, p, s):
    """DESIGN.md §6 inside the port: the fused strip conv equals the per-tap
    path on the pixel stream, bitwise, at strides 1, 2 and 4."""
    x = torch.from_numpy(_fired(3 * s + k, shape))
    wt = torch.from_numpy(np.random.default_rng(k).normal(
        size=(k, k, shape[3], 16)).astype(np.float32))
    cfg = tengine.EngineConfig(blk_k=8)
    strip = tengine.EventStream.encode_nhwc(x, blk_k=8, blk_m=8,
                                            keep_dense=False)
    pix = tengine.EventStream.encode_nhwc(x, blk_k=8, blk_m=1,
                                          keep_dense=False)
    with tengine.trace_dispatch() as recs:
        ys = tengine.conv2d(strip, wt, cfg=cfg, stride=s, padding=p)
        yp = tengine.conv2d(pix, wt, cfg=cfg, stride=s, padding=p)
    assert [r.get("strip") for r in recs] == [True, None]
    assert torch.equal(ys, yp)
    yd = tengine.conv2d(x, wt, cfg=cfg.replace(backend="dense"), stride=s,
                        padding=p)
    torch.testing.assert_close(ys, yd, atol=2e-4, rtol=2e-4)


# -- B4 event_pool --------------------------------------------------------------

@pytest.mark.parametrize("shape,k,s,bm,window", [
    ((2, 8, 16, 16), 2, 2, 8, True), ((1, 6, 32, 8), 2, 2, 8, True),
    ((2, 7, 7, 8), 3, 2, 1, False), ((1, 8, 8, 16), 2, 2, 8, False),
])
def test_event_pool_plain_matches_block_refs(shape, k, s, bm, window):
    x = _fired(k + bm, shape, 0.6)
    bk = 8
    ts = tengine.EventStream.encode_nhwc(torch.from_numpy(x), blk_k=bk,
                                         blk_m=bm, keep_dense=False)
    js = jengine.EventStream.encode_nhwc(jnp.asarray(x), blk_k=bk, blk_m=bm,
                                         keep_dense=False)
    if window:
        y = event_max_pool2d_window(ts, k, s)
        ref = _jit(event_max_pool2d_window_ref, js, k=k, stride=s)
    else:
        y = event_max_pool2d(ts, k, s)
        ref = _jit(event_max_pool2d_ref, js, k=k, stride=s)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref))
    dense = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                  (1, k, k, 1), (1, s, s, 1), "VALID")
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(dense).reshape(y.shape))


def test_cpu_wrappers_take_plain_and_count_nothing():
    """On CPU tensors each wrapper runs its plain version; the launch
    counters move only where a kernel launches."""
    before = (fire_compact.launches, event_matmul.launches,
              event_conv.launches, event_pool.launches,
              event_pool_window.launches)
    x = torch.from_numpy(_fired(1, (1, 4, 16, 8)))
    wt = torch.ones((3, 3, 8, 8))
    s = tengine.EventStream.encode_nhwc(x, blk_k=8, blk_m=8)
    fused_event_conv2d(s, wt, stride=1, padding=1)
    event_max_pool2d_window(s, 2, 2)
    event_max_pool2d(s, 2, 2)
    fire_compact(x.reshape(-1, 8), blk_m=8, blk_k=8)
    after = (fire_compact.launches, event_matmul.launches,
             event_conv.launches, event_pool.launches,
             event_pool_window.launches)
    assert before == after


def test_zero_extent_short_circuits():
    """Empty batches never reach a kernel: each op returns the exact empty
    (or zero) result of the right shape."""
    cfg = tengine.EngineConfig(blk_k=8)
    acc = torch.zeros((0, 8, 8, 16))
    s = tengine.fire_conv(acc, cfg, blk_m=8)
    assert s.shape == (0, 16) and s.events.values.shape[0] == 0
    y = tengine.conv2d(s, torch.ones((3, 3, 16, 8)), cfg=cfg, padding=1)
    assert y.shape == (0, 8, 8, 8)
    p = tengine.maxpool2d(s, 2, 2, cfg=cfg)
    assert p.logical_shape == (0, 4, 4, 16) and p.shape == (0, 16)
    assert tengine.linear(p, torch.ones((256, 10)), cfg=cfg).shape == (0, 10)
    f = tengine.fire(torch.zeros((0, 32)), cfg)
    assert f.shape == (0, 32)
    assert tengine.linear(f, torch.ones((32, 4)), cfg=cfg).shape == (0, 4)

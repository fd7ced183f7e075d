"""The CUDA kernels against their plain versions, the compiled steps
(CUDA graphs) against the eager runs, and the serving tier's engine, on
the card, at small shapes.
Marked ``cuda``: each test skips where there is no GPU (decided inside
the fixture, never at import).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import engine, kernels
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import quantize as qz
from repro_torch.core.events import (BlockEvents, decode_block_events,
                                     gather_row_groups, live_block_mask)
from repro_torch.core.fire import FireConfig
from repro_torch.engine.backends import tap_row_map
from repro_torch.kernels.event_conv.ops import (event_conv, event_conv_dequant,
                                                strip_conv_inputs)
from repro_torch.kernels.event_conv.ref import (event_conv_int8_ref,
                                                event_conv_ref)
from repro_torch.kernels.event_matmul.ops import (event_matmul,
                                                  event_matmul_dequant)
from repro_torch.kernels.event_matmul.ref import (event_matmul_int8_ref,
                                                  event_matmul_ref)
from repro_torch.kernels.event_pool.ops import (event_pool, event_pool_window,
                                                pool_inputs,
                                                pool_window_inputs)
from repro_torch.kernels.event_pool.ref import (event_pool_ref,
                                                event_pool_window_ref)
from repro_torch.kernels.fire_compact.ops import fire_compact
from repro_torch.kernels.fire_compact.ref import fire_compact_ref
from repro_torch.kernels.mamba_scan.kernel import (MAX_N, mamba_scan_cuda,
                                                   mamba_scan_fused_cuda)
from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_fused
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                mamba_scan_ref,
                                                mamba_scan_streams)
from repro_torch.kernels.mamba_step.ops import mamba_step_events
from repro_torch.kernels.mamba_step.ref import mamba_step_events_ref
from repro_torch.kernels.wkv6.kernel import MAX_D, wkv6_cuda
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_single
from repro_torch.kernels.wkv6.ref import wkv6_multihead_ref
from repro_torch.kernels.wkv6_step.ops import wkv6_step_events
from repro_torch.kernels.wkv6_step.ref import wkv6_step_events_ref
from repro_torch import serving
from repro_torch.launch import graphs, serve, steps
from repro_torch.models import cnn, mlp
from repro_torch.serving import server
from repro_torch.models import transformer as tfm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fired(seed, shape, dev, sparsity=0.5):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape) * (r.random(shape) > sparsity)
    return torch.from_numpy(np.maximum(x, 0).astype(np.float32)).to(dev)


def _close(a, b):
    return float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()),
                                                    1e-30)


@pytest.mark.parametrize("m,k,bm,bk,mag", [(64, 64, 8, 8, False),
                                           (4, 1000, 4, 128, True)])
def test_fire_compact_matches_plain(dev, m, k, bm, bk, mag):
    acc = torch.randn((m, k - k % bk), device=dev)
    n = fire_compact.launches
    f1, o1 = fire_compact(acc, blk_m=bm, blk_k=bk, magnitude=mag)
    f2, o2 = fire_compact_ref(acc, blk_m=bm, blk_k=bk, magnitude=mag)
    assert fire_compact.launches == n + 1
    assert torch.equal(f1, f2) and torch.equal(o1, o2)


#: B1 cases: (M, K, bm, bk, threshold, magnitude, qscale).  The VGG-like
#: pair is the forward's strip and pixel fire (K 64, bk 8: two 16-byte
#: lanes a tile, reduced by one shuffle); bk 128 is a whole warp a tile;
#: bk 6 (LeNet's K 300) and an acc 4 bytes off 16-byte alignment take the
#: scalar path, bk 6 with a shared-memory flag per tile; "ties" puts values
#: at x.5 * qscale (round half to even); "dead_band" has tile rows with no
#: live value (occupancy 0).
FIRE_CASES = {
    "vgg_strip": (2048, 64, 8, 8, 0.0, False, None),
    "vgg_pixel": (2048, 64, 1, 8, 0.0, False, None),
    "bk128": (40, 1024, 8, 128, 0.0, False, None),
    "lenet_bk6": (128, 300, 1, 6, 0.0, False, None),
    "unaligned": (96, 64, 8, 8, 0.0, False, None),
    "theta": (512, 64, 8, 8, 0.5, False, None),
    "magnitude": (512, 64, 1, 8, 0.3, True, None),
    "ties": (256, 64, 8, 8, 0.0, False, 0.125),
    "dead_band": (256, 64, 8, 8, 0.0, False, None),
}


@pytest.mark.parametrize("case", sorted(FIRE_CASES))
def test_fire_compact_cases(dev, case):
    m, k, bm, bk, thr, mag, qscale = FIRE_CASES[case]
    r = np.random.default_rng(len(case))
    x = r.normal(size=(m, k)).astype(np.float32)
    if case == "ties":
        x = ((np.floor(x * 16) + 0.5) * qscale).astype(np.float32)
        assert (np.abs(x / qscale - np.round(x / qscale)) == 0.5).all()
    if case == "dead_band":
        x[8:24] = -np.abs(x[8:24])
    acc = torch.from_numpy(x).to(dev)
    if case == "unaligned":
        acc = torch.empty(m * k + 1, device=dev)[1:].view(m, k).copy_(acc)
        assert acc.data_ptr() % 16 == 4
    kw = dict(blk_m=bm, blk_k=bk, threshold=thr, magnitude=mag,
              qscale=qscale)
    n = fire_compact.launches
    f1, o1 = fire_compact(acc, **kw)
    assert fire_compact.launches == n + 1
    f2, o2 = fire_compact_ref(acc, **kw)
    assert torch.equal(f1, f2) and torch.equal(o1, o2)
    if case == "dead_band":
        assert int(o1[1:3].sum()) == 0


#: B2/B5 cases: (seed, rows, K, N, bm, bk, capacity, per-tap gather).  The
#: launcher takes the FC CTA shape where G * bm <= 4 ("fc", "fc_n10") and
#: the per-tap conv one elsewhere; "n1000" and "fc" leave a ragged last
#: column tile, "fc_n10" and "pixel" take the 4-byte weight copies (N not a
#: multiple of 4), "capacity" has counts > E, "per_tap" is tap (0, 0) of a
#: 3x3 conv over a (4, 10, 10, 64) pixel stream, its border groups with
#: counts 0.
MATMUL_CASES = {
    "pixel": (16, 16, 64, 1002, 1, 8, None, False),
    "strip": (8, 8, 512, 40, 8, 128, None, False),
    "n1000": (9, 64, 256, 1000, 1, 8, None, False),
    "fc": (4, 4, 9600, 1000, 1, 8, None, False),
    "fc_n10": (5, 4, 64, 10, 1, 8, None, False),
    "capacity": (6, 64, 256, 96, 1, 8, 8, False),
    "per_tap": (7, 400, 64, 96, 1, 8, None, True),
}


def _matmul_events(case, dev, int8):
    """The events (values, block_idx, counts), W and, for ``int8``, the
    codes' QParams of a MATMUL_CASES case."""
    seed, m, k, n, bm, bk, cap, per_tap = MATMUL_CASES[case]
    shape = (4, 10, 10, k) if per_tap else (m, k)
    x = _fired(seed, shape, dev)
    qp = None
    if int8:
        x, qp = _int8(x)
    if per_tap:
        st = engine.EventStream.encode_nhwc(x, blk_k=bk, blk_m=1)
        idx, live = tap_row_map(shape, 3, 1, 1)
        bev = gather_row_groups(st.events, torch.from_numpy(idx[0]).to(dev),
                                torch.from_numpy(live[0]).to(dev))
        assert bev.values.shape[0] == m and int((bev.counts == 0).sum()) > 0
    else:
        bev = engine.EventStream.encode(x, blk_m=bm, blk_k=bk,
                                        capacity=cap).events
    if cap is not None:
        assert int(bev.counts.max()) > bev.values.shape[1]
    w = torch.randn((k, n), device=dev)
    return (bev.values, bev.block_idx, bev.counts), w, qp


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
def test_event_matmul_matches_plain(dev, case):
    """B2 against its plain version within 1e-4 of max|plain|."""
    ev3, w, _ = _matmul_events(case, dev, int8=False)
    args = (*ev3, w)
    launches = event_matmul.launches
    y = event_matmul(*args)
    assert event_matmul.launches == launches + 1
    assert _close(y, event_matmul_ref(*args))


@pytest.mark.parametrize("shape,k,p,s", [((2, 8, 32, 8), 3, 1, 1),
                                         ((1, 8, 32, 8), 3, 1, 2),
                                         ((1, 16, 64, 3), 11, 4, 4)])
def test_event_conv_matches_plain(dev, shape, k, p, s):
    x = _fired(k, shape, dev)
    w = torch.randn((k, k, shape[3], 16), device=dev)
    st = engine.EventStream.encode_nhwc(x, blk_k=8, blk_m=8)
    args, nkb = strip_conv_inputs(st, w, stride=s, padding=p)
    assert _close(event_conv(*args, nkb=nkb, row_stride=s),
                  event_conv_ref(*args, nkb=nkb, row_stride=s))


#: B3/B6 cases: (seed, (B, H, W, CI), k, padding, stride, CO, blk_k,
#: capacity, event-free strips).  "ci64_*" are VGG16's conv1_2/conv2_1
#: widths on small maps (one and two column tiles), "co24" a ragged column
#: tile, "bk3" the 3-channel first layer (4-byte weight copies, one value a
#: load), "capacity" counts > E, "empty_strips" whole strips without
#: events, "stride2_ci64" a k3s2 layer at CI 64.
CONV_CASES = {
    "ci64_co64": (21, (2, 8, 32, 64), 3, 1, 1, 64, 8, None, False),
    "ci64_co128": (22, (1, 8, 64, 64), 3, 1, 1, 128, 8, None, False),
    "co24": (23, (2, 8, 32, 16), 3, 1, 1, 24, 8, None, False),
    "bk3": (24, (2, 8, 32, 3), 3, 1, 1, 64, 3, None, False),
    "capacity": (25, (1, 8, 32, 64), 3, 1, 1, 64, 8, 3, False),
    "empty_strips": (26, (2, 8, 32, 64), 3, 1, 1, 64, 8, None, True),
    "stride2_ci64": (27, (1, 16, 64, 64), 3, 1, 2, 64, 8, None, False),
}


def _conv_case(case, dev, zero_point=None):
    """The strip conv operands of a CONV_CASES case, and the QParams when
    ``zero_point`` asks for int8 codes."""
    seed, shape, k, p, s, co, bk, cap, empty = CONV_CASES[case]
    x = _fired(seed, shape, dev)
    if empty:                      # strips 1 and 2 of every row: no events
        x[:, :, 8:24] = 0
    qp = None
    if zero_point is not None:
        x, qp = _int8(x, zero_point)
    w = torch.randn((k, k, shape[3], co), device=dev)
    st = engine.EventStream.encode_nhwc(x, blk_k=bk, blk_m=8, capacity=cap,
                                        keep_dense=False)
    assert st.blk_k == bk
    cnt = st.events.counts
    if cap is not None:
        assert int(cnt.max()) > st.events.values.shape[1]
    if empty:
        assert int((cnt == 0).sum()) >= 2 * shape[0] * shape[1]
    args, nkb = strip_conv_inputs(st, w, stride=s, padding=p)
    return args, dict(nkb=nkb, row_stride=s), qp


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_event_conv_cases(dev, case):
    """B3 against its plain version within 1e-4 of max|plain|."""
    args, kw, _ = _conv_case(case, dev)
    launches = event_conv.launches
    y = event_conv(*args, **kw)
    assert event_conv.launches == launches + 1
    assert _close(y, event_conv_ref(*args, **kw))


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_event_conv_int8_cases(dev, case):
    """B6 with zero point 7 (a live code of 0 is -7 * scale, an unsourced
    row exact 0) against its plain version, and bitwise B3 on the
    dequantized tiles."""
    args, kw, qp = _conv_case(case, dev, zero_point=7)
    assert bool((args[0] == 0).any())
    a8 = (*args[:6], qp.scale, qp.zero_point, args[6])
    launches = event_conv_dequant.launches
    y = event_conv_dequant(*a8, **kw)
    assert event_conv_dequant.launches == launches + 1
    assert _close(y, event_conv_int8_ref(*a8, **kw))
    assert torch.equal(y, event_conv(qz.dequantize(args[0], qp), *args[1:],
                                     **kw))


def _int8(x, zero_point=0):
    """Codes of ``x`` under its symmetric QParams, with the zero point
    replaced by ``zero_point`` (the kernels take any)."""
    qp = qz.calibrate(x)
    q = qz.quantize(x, qp)
    return q, qz.QParams(scale=qp.scale, zero_point=torch.full(
        (), zero_point, dtype=torch.int32, device=x.device))


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
def test_event_matmul_int8_matches_plain(dev, case):
    """B5 against its plain version within 1e-4 of max|plain|, and bitwise
    B2 on the dequantized tiles (the same CTA shape, the same walk)."""
    (vals, idx, cnt), w, qp = _matmul_events(case, dev, int8=True)
    assert vals.dtype == torch.int8
    args = (vals, idx, cnt, qp.scale, qp.zero_point, w)
    launches = event_matmul_dequant.launches
    y = event_matmul_dequant(*args)
    assert event_matmul_dequant.launches == launches + 1
    assert _close(y, event_matmul_int8_ref(*args))
    # bitwise B2 on the dequantized tiles: the same fmaf walk
    assert torch.equal(y, event_matmul(qz.dequantize(args[0], qp),
                                       *args[1:3], w))


@pytest.mark.parametrize("shape,k,p,s,zp", [((2, 8, 32, 8), 3, 1, 1, 0),
                                            ((1, 8, 32, 8), 3, 1, 2, 0),
                                            ((1, 16, 64, 3), 11, 4, 4, 0),
                                            ((1, 8, 32, 8), 3, 1, 2, 7)])
def test_event_conv_int8_matches_plain(dev, shape, k, p, s, zp):
    """B6 at strides 1, 2, 4, and with a non-zero zero point: codes are
    dequantized before the row remap, so unsourced rows stay 0."""
    q, qp = _int8(_fired(k + s, shape, dev), zp)
    w = torch.randn((k, k, shape[3], 16), device=dev)
    st = engine.EventStream.encode_nhwc(q, blk_k=8, blk_m=8)
    args, nkb = strip_conv_inputs(st, w, stride=s, padding=p)
    a8 = (*args[:6], qp.scale, qp.zero_point, args[6])
    y = event_conv_dequant(*a8, nkb=nkb, row_stride=s)
    assert _close(y, event_conv_int8_ref(*a8, nkb=nkb, row_stride=s))
    assert torch.equal(y, event_conv(qz.dequantize(args[0], qp), *args[1:],
                                     nkb=nkb, row_stride=s))


@pytest.mark.parametrize("s", [1, 2])
def test_strip_equals_per_tap_on_card(dev, s):
    """DESIGN.md §6 on the card: engine.conv2d on the strip stream (B3, one
    launch) and on the pixel stream of the same map (B2 x 9, per tap) agree
    bitwise: both sum each output's terms in the same order."""
    shape = (2, 8, 32, 8)
    x = _fired(11 + s, shape, dev)
    w = torch.randn((3, 3, 8, 16), device=dev)
    cfg = engine.EngineConfig(blk_k=8)
    strip = engine.EventStream.encode_nhwc(x, blk_k=8, blk_m=8,
                                           keep_dense=False)
    pix = engine.EventStream.encode_nhwc(x, blk_k=8, blk_m=1,
                                         keep_dense=False)
    n_conv, n_mm = event_conv.launches, event_matmul.launches
    ys = engine.conv2d(strip, w, cfg=cfg, stride=s, padding=1)
    assert (event_conv.launches, event_matmul.launches) == (n_conv + 1,
                                                            n_mm)
    yp = engine.conv2d(pix, w, cfg=cfg, stride=s, padding=1)
    assert (event_conv.launches, event_matmul.launches) == (n_conv + 1,
                                                            n_mm + 9)
    assert torch.equal(ys, yp)


@pytest.mark.parametrize("s", [1, 2])
def test_strip_equals_per_tap_ci64_on_card(dev, s):
    """Strip == per-tap at VGG16's CI 64 (eight K-blocks a strip, the
    kernel's aligned path): B3 x 1 and B2 x 9 bitwise."""
    shape = (2, 8, 64, 64)
    x = _fired(31 + s, shape, dev)
    w = torch.randn((3, 3, 64, 64), device=dev)
    cfg = engine.EngineConfig(blk_k=8)
    strip, pix = (engine.EventStream.encode_nhwc(x, blk_k=8, blk_m=bm,
                                                 keep_dense=False)
                  for bm in (8, 1))
    n_conv, n_mm = event_conv.launches, event_matmul.launches
    ys = engine.conv2d(strip, w, cfg=cfg, stride=s, padding=1)
    yp = engine.conv2d(pix, w, cfg=cfg, stride=s, padding=1)
    assert (event_conv.launches, event_matmul.launches) == (n_conv + 1,
                                                            n_mm + 9)
    assert torch.equal(ys, yp)


def _all_live(st):
    """The drive of a fire_delta stream with every K-block an event (encode
    at threshold -1, DESIGN.md §13): what the gated kernel consumes when
    nothing is gated."""
    return engine.EventStream.encode(st.dense(), blk_m=1, blk_k=st.blk_k,
                                     threshold=-1.0).events


def test_wkv6_step_theta0_equals_all_live(dev):
    """DESIGN.md §13's within-backend contract for B7: on a θ = 0 drive
    whose zero blocks are dead, o and S' are bitwise the same kernel's on
    the all-live drive of the same values (gating changes the work, never
    the numbers)."""
    g, d = 12, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    r, k, v, u, s = f(g, d), f(g, d), f(g, d), f(g, d), f(g, d, d)
    w = torch.rand((g, d), generator=gen, device=dev) * 0.9 + 0.05
    k[:, 16:32] = 0.0
    k[0] = 0.0
    st = engine.fire_delta(k, engine.EngineConfig(threshold=0.0))
    live = _all_live(st)
    assert int(st.events.counts.sum()) < int(live.counts.sum()) == g * 4
    o, s_new = wkv6_step_events(st.events, r, v, w, u, s, blk_k=st.blk_k)
    o2, s2 = wkv6_step_events(live, r, v, w, u, s, blk_k=st.blk_k)
    assert torch.equal(o, o2) and torch.equal(s_new, s2)


def test_mamba_step_theta0_equals_all_live(dev):
    """The same contract for B8: h' and y bitwise the all-live drive's."""
    b, di, n = 4, 1600, 16
    gen = torch.Generator(device=dev).manual_seed(4)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    g, bm, cm, h = f(b, di), f(b, n), f(b, n), f(b, di, n)
    da = torch.rand((b, di, n), generator=gen, device=dev) * 0.9 + 0.05
    g[:, 32:160] = 0.0
    g[1] = 0.0
    st = engine.fire_delta(g, engine.EngineConfig(threshold=0.0))
    live = _all_live(st)
    assert int(st.events.counts.sum()) < int(live.counts.sum())
    y, h_new = mamba_step_events(st.events, da, bm, cm, h, blk_k=st.blk_k)
    y2, h2 = mamba_step_events(live, da, bm, cm, h, blk_k=st.blk_k)
    assert torch.equal(y, y2) and torch.equal(h_new, h2)


@pytest.mark.parametrize("shape,bm", [((2, 16, 16, 16), 8),
                                      ((2, 7, 7, 16), 1)])
def test_event_pools_match_plain(dev, shape, bm):
    x = _fired(bm, shape, dev)
    st = engine.EventStream.encode_nhwc(x, blk_k=8, blk_m=bm)
    args = pool_inputs(st, 2, 2)
    assert torch.equal(event_pool(*args, nkb=2), event_pool_ref(*args, nkb=2))
    if bm == 8:
        args = pool_window_inputs(st, 2, 2)
        assert torch.equal(event_pool_window(*args, nkb=2, row_stride=2),
                           event_pool_window_ref(*args, nkb=2, row_stride=2))


#: B4b cases: (NHWC shape, bm, bk, k, stride, capacity).  bm 1 is the
#: forward's pixel stream, bm 8 a strip stream; k3 s2 has T 9 taps; C 512
#: at bk 8 is pool4/pool5's 512 columns, C 4096 at k3 a slot table wider
#: than a CTA's share (two windows of K-blocks); "capacity" has counts > E
#: (E 2 of nkb 4), "event_free" whole pixels without events, bk 6 the
#: scalar path.
POOL_CASES = {
    "pixel_k2s2": ((2, 8, 8, 16), 1, 8, 2, 2, None),
    "strip_k2s2": ((2, 8, 16, 32), 8, 8, 2, 2, None),
    "pixel_k3s2": ((2, 9, 9, 32), 1, 8, 3, 2, None),
    "strip_k3s2": ((1, 9, 16, 16), 8, 8, 3, 2, None),
    "c512": ((2, 6, 6, 512), 1, 8, 2, 2, None),
    "c4096_k3": ((1, 3, 3, 4096), 1, 8, 3, 2, None),
    "capacity": ((2, 8, 8, 32), 1, 8, 2, 2, 2),
    "event_free": ((2, 8, 8, 16), 1, 8, 2, 2, None),
    "bk6": ((2, 8, 8, 12), 1, 6, 2, 2, None),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_event_pool_cases(dev, case):
    """B4b exact against its plain version and F.max_pool2d on the decoded
    map, one launch a call."""
    shape, bm, bk, k, s, cap = POOL_CASES[case]
    x = _fired(len(case), shape, dev, sparsity=0.6)
    if case == "event_free":
        x[0, :4] = 0.0
        x[1, :, 2:6] = 0.0
    st = engine.EventStream.encode_nhwc(x, blk_k=bk, blk_m=bm, capacity=cap)
    nkb = st.events.num_k_blocks
    args = pool_inputs(st, k, s)
    if cap is not None:
        assert int(args[4].max()) > args[0].shape[1] and cap < nkb
    if case == "event_free":
        assert int((args[4] == 0).all(1).sum()) > 0
    n = event_pool.launches
    y = event_pool(*args, nkb=nkb)
    assert event_pool.launches == n + 1
    assert torch.equal(y, event_pool_ref(*args, nkb=nkb))
    b, h, w, c = shape
    dense = decode_block_events(st.events, blk_m=bm, blk_k=bk,
                                m=b * h * w, k=nkb * bk)[:, :c]
    pooled = torch.nn.functional.max_pool2d(
        dense.reshape(shape).permute(0, 3, 1, 2), k, s)
    assert torch.equal(y.reshape(y.shape[0], -1)[:, :c],
                       pooled.permute(0, 2, 3, 1).reshape(-1, c))


#: B4a cases: (NHWC shape, bk, k, stride, capacity).  The window pool
#: takes strip streams (bm 8) whose pooled width is a multiple of 8.  C 64
#: and C 128 at bk 8 are pool1's and pool2's tiles (k2 s2, T 8 subtaps);
#: k3 s3 has T 27 (a k3 s2 window pool never qualifies: its pooled width
#: (W - 3)//2 + 1 is odd for every W a multiple of 8); C 4096 has a slot
#: table wider than a CTA's share (two windows of K-blocks); "capacity" has
#: counts > E (E 2 of nkb 4), "event_free" whole strips without events,
#: bk 6 the 4-byte path, "unaligned" a_vals 4 bytes off 16-byte alignment.
POOL_WINDOW_CASES = {
    "k2s2_c64": ((2, 4, 32, 64), 8, 2, 2, None),
    "k2s2_c128": ((2, 4, 32, 128), 8, 2, 2, None),
    "k3s3": ((1, 6, 24, 32), 8, 3, 3, None),
    "c4096": ((1, 4, 16, 4096), 8, 2, 2, None),
    "capacity": ((2, 4, 32, 32), 8, 2, 2, 2),
    "event_free": ((2, 4, 32, 16), 8, 2, 2, None),
    "bk6": ((2, 4, 16, 12), 6, 2, 2, None),
    "unaligned": ((2, 4, 32, 64), 8, 2, 2, None),
}


@pytest.mark.parametrize("case", sorted(POOL_WINDOW_CASES))
def test_event_pool_window_cases(dev, case):
    """B4a exact against its plain version and F.max_pool2d on the decoded
    map, one launch a call."""
    shape, bk, k, s, cap = POOL_WINDOW_CASES[case]
    x = _fired(len(case) + 100, shape, dev, sparsity=0.6)
    if case == "event_free":
        x[0, :2] = 0.0
        x[1, :, 8:24] = 0.0
    st = engine.EventStream.encode_nhwc(x, blk_k=bk, blk_m=8, capacity=cap)
    nkb = st.events.num_k_blocks
    args = pool_window_inputs(st, k, s)
    if cap is not None:
        assert int(args[4].max()) > args[0].shape[1] and cap < nkb
    if case == "event_free":
        assert int((args[4] == 0).all(1).sum()) > 0
    if case == "unaligned":
        buf = torch.empty(args[0].numel() + 1, device=dev)
        shifted = buf[1:].view(args[0].shape)
        shifted.copy_(args[0])
        assert shifted.data_ptr() % 16 == 4
        args = (shifted, *args[1:])
    n = event_pool_window.launches
    y = event_pool_window(*args, nkb=nkb, row_stride=s)
    assert event_pool_window.launches == n + 1
    assert torch.equal(y, event_pool_window_ref(*args, nkb=nkb,
                                                row_stride=s))
    b, h, w, c = shape
    dense = decode_block_events(st.events, blk_m=8, blk_k=bk,
                                m=b * h * w, k=nkb * bk)[:, :c]
    pooled = torch.nn.functional.max_pool2d(
        dense.reshape(shape).permute(0, 3, 1, 2), k, s)
    assert torch.equal(y.reshape(-1, nkb * bk)[:, :c],
                       pooled.permute(0, 2, 3, 1).reshape(-1, c))


def test_mini_chain_bitwise_and_matches_cpu(dev):
    gen = torch.Generator().manual_seed(0)
    params = cnn.init_cnn_params(cnn.MINI, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((2, 8, 8, 3), generator=gen))
    yc = cnn.cnn_forward(params, x, cnn.MINI)
    yr = cnn.cnn_forward(params, x, cnn.MINI, chain=False)
    assert torch.equal(yc, yr)
    y_cpu = cnn.cnn_forward(params, x, cnn.MINI, device="cpu")
    torch.testing.assert_close(yc.cpu(), y_cpu, atol=1e-5, rtol=1e-5)


def test_int8_mini_and_mlp_chains_bitwise_and_match_cpu(dev):
    fire_cfg = FireConfig(quantize_to_int8=True)
    gen = torch.Generator().manual_seed(0)
    params = cnn.init_cnn_params(cnn.MINI, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((2, 8, 8, 3), generator=gen))
    yc = cnn.cnn_forward(params, x, cnn.MINI, fire_cfg=fire_cfg)
    yr = cnn.cnn_forward(params, x, cnn.MINI, fire_cfg=fire_cfg, chain=False)
    assert torch.equal(yc, yr)
    y_cpu = cnn.cnn_forward(params, x, cnn.MINI, fire_cfg=fire_cfg,
                            device="cpu")
    torch.testing.assert_close(yc.cpu(), y_cpu, atol=1e-5, rtol=1e-5)
    mp = mlp.init_mlp_params(mlp.MLP_MINI, gen, weight_sparsity=0.5)
    xm = torch.relu(torch.randn((4, 64), generator=gen))
    launches = event_matmul_dequant.launches
    ym = mlp.mlp_forward(mp, xm, mlp.MLP_MINI, fire_cfg=fire_cfg)
    assert event_matmul_dequant.launches == launches + 2
    assert torch.equal(ym, mlp.mlp_forward(mp, xm, mlp.MLP_MINI,
                                           fire_cfg=fire_cfg, chain=False))


#: B7 cases: (G, D, θ, case).  G 256 x D 64 is the RWKV6-7B batch-4 main
#: path's shape (events (256, 4, 1, 16)); its θ = 0 twin zeroes whole key
#: blocks so that some (row, K-block) pairs are dead, as a decode's are.
#: "padding slots repeat a dead block" points every padding slot at a dead
#: block of its row and fills it with 7.0: a kernel that visited padding
#: would mark that block live.  D 20 takes the 4-byte path, D 128 holds a
#: row in 4 passes of 4 rows a thread.
@pytest.mark.parametrize("g,d,threshold,case", [
    (256, 64, 0.0, "all live"),
    (256, 64, 0.0, "main path with dead blocks"),
    (12, 64, 1.0, "some dead"),
    (12, 64, 0.0, "padding slots repeat a dead block"),
    (12, 20, 0.5, "D not a multiple of 16"),
    (8, 128, 0.5, "D 128"),
    (8, 64, 0.5, "zero events in a row"),
    (8, 64, 1e9, "all blocks dead"),
])
def test_wkv6_step_matches_plain(dev, g, d, threshold, case):
    """B7 against its plain version: S' bitwise (the state update's
    multiply, multiply, add in round-to-nearest intrinsics), o within
    1e-4 of max|plain| (a D-term reduction in another order)."""
    gen = torch.Generator(device=dev).manual_seed(g + d)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    r, k, v, u, s = f(g, d), f(g, d), f(g, d), f(g, d), f(g, d, d)
    w = torch.rand((g, d), generator=gen, device=dev) * 0.9 + 0.05
    if case == "zero events in a row":
        k[0] = 0.0
    if case in ("main path with dead blocks",
                "padding slots repeat a dead block"):
        k[::2, 16:32] = 0.0
        k[1::3, 48:64] = 0.0
    st = engine.fire_delta(k, engine.EngineConfig(threshold=threshold))
    bev = st.events
    live = live_block_mask(bev)
    if case == "zero events in a row":
        assert int(bev.counts[0]) == 0
    if case == "all blocks dead":
        assert int(bev.counts.sum()) == 0
    if case in ("main path with dead blocks",
                "padding slots repeat a dead block"):
        assert 0 < int((~live).sum()) < live.numel()
    if case == "padding slots repeat a dead block":
        pad = torch.arange(bev.capacity, device=dev)[None, :] \
            >= bev.counts[:, None]
        dead = (~live).int().argmax(1).to(torch.int32)   # a dead block
        rows = (~live).any(1)
        pad &= rows[:, None]
        assert int(pad.sum()) > 0
        bev = BlockEvents(
            torch.where(pad[:, :, None, None], 7.0, bev.values),
            torch.where(pad, dead[:, None], bev.block_idx), bev.counts,
            bev.num_k_blocks)
        assert torch.equal(live_block_mask(bev), live)
    launches = wkv6_step_events.launches
    o, s_new = wkv6_step_events(bev, r, v, w, u, s, blk_k=st.blk_k)
    assert wkv6_step_events.launches == launches + 1
    o2, s2 = wkv6_step_events_ref(bev, r, v, w, u, s, blk_k=st.blk_k)
    assert torch.equal(s_new, s2)
    assert _close(o, o2)
    if case == "all blocks dead":
        assert torch.equal(s_new, w[..., None] * s)
    dead_rows = (~live).repeat_interleave(st.blk_k, 1)[:, :d]
    assert torch.equal(s_new[dead_rows], (w[..., None] * s)[dead_rows])


def test_wkv6_step_wrapper_builds_no_live_mask(dev, monkeypatch):
    """The B7 wrapper launches the kernel alone: the kernel derives the
    live mask from the events, so ``live_block_mask`` (patched to raise)
    is never called, and the result is the plain version's."""
    from repro_torch.core import events as ev
    g, d = 256, 64
    gen = torch.Generator(device=dev).manual_seed(5)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    r, k, v, u, s = f(g, d), f(g, d), f(g, d), f(g, d), f(g, d, d)
    w = torch.rand((g, d), generator=gen, device=dev) * 0.9 + 0.05
    k[::2, 16:32] = 0.0
    st = engine.fire_delta(k, engine.EngineConfig(threshold=0.0))

    def no_mask(bev):
        raise AssertionError("the B7 wrapper built a live mask")

    monkeypatch.setattr(ev, "live_block_mask", no_mask)
    launches = wkv6_step_events.launches
    o, s_new = wkv6_step_events(st.events, r, v, w, u, s, blk_k=st.blk_k)
    assert wkv6_step_events.launches == launches + 1
    monkeypatch.undo()
    o2, s2 = wkv6_step_events_ref(st.events, r, v, w, u, s, blk_k=st.blk_k)
    assert torch.equal(s_new, s2) and _close(o, o2)


#: B8 cases: (DI, N, θ, case).  "rows": row 0 a zero gate (no events),
#: row 1 a gate below 0.05 (every block dead at θ = 0.3), rows 2-3 normal;
#: DI 40 has a ragged last block, DI 1600 is Hymba-1.5B's.  "padding slots
#: repeat a dead block" points every padding slot at a dead block of its
#: row and fills it with 7.0: a kernel that visited padding would mark that
#: block live.  "capacity" keeps 37 of the 100 slots, so counts > E.  N 4
#: takes one 16-byte chunk a channel, N 6 the 4-byte path (2 lanes of 3
#: columns), "unaligned" the 4-byte path at N 16 (dA and h 4 bytes off a
#: 16-byte boundary), N 64 16 lanes a channel.
@pytest.mark.parametrize("di,n,threshold,case", [
    (40, 16, 0.0, "rows"), (40, 16, 0.3, "rows"),
    (64, 16, 0.0, "rows"), (64, 16, 0.3, "rows"),
    (1600, 16, 0.0, "rows"), (1600, 16, 0.3, "rows"),
    (64, 16, 0.0, "padding slots repeat a dead block"),
    (1600, 16, 0.0, "capacity"),
    (40, 4, 0.3, "rows"), (40, 6, 0.3, "rows"),
    (1600, 16, 0.3, "unaligned"), (64, 64, 0.3, "rows"),
])
def test_mamba_step_matches_plain(dev, di, n, threshold, case):
    """B8 against its plain version on 4 rows: h' bitwise (the multiply,
    multiply, add in round-to-nearest intrinsics), y within 1e-4 of
    max|plain| (an N-term sum in another order); a dead block's h' is
    h dA alone."""
    seed = di if (n, case) == (16, "rows") else di + n
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    g, bm, cm, h = f(4, di), f(4, n), f(4, n), f(4, di, n)
    g[0] = 0.0
    g[1] = (torch.rand(di, generator=gen, device=dev) - 0.5) * 0.1
    da = torch.rand((4, di, n), generator=gen, device=dev) * 0.9 + 0.05
    if case == "padding slots repeat a dead block":
        g[2:, 16:32] = 0.0
    if case == "unaligned":
        da, h = (torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
                 for x in (da, h))
        assert da.data_ptr() % 16 and h.data_ptr() % 16
    st = engine.fire_delta(g, engine.EngineConfig(threshold=threshold))
    bev = st.events
    assert int(bev.counts[0]) == 0
    if threshold > 0:
        assert int(bev.counts[1]) == 0
    if case == "padding slots repeat a dead block":
        live = live_block_mask(bev)
        pad = torch.arange(bev.capacity, device=dev)[None, :] \
            >= bev.counts[:, None]
        dead = (~live).int().argmax(1).to(torch.int32)
        pad &= (~live).any(1)[:, None]
        assert int(pad.sum()) > 0 and bool((~live[2:, 1]).all())
        bev = BlockEvents(
            torch.where(pad[:, :, None, None], 7.0, bev.values),
            torch.where(pad, dead[:, None], bev.block_idx), bev.counts,
            bev.num_k_blocks)
        assert torch.equal(live_block_mask(bev), live)
    if case == "capacity":
        bev = BlockEvents(bev.values[:, :37].contiguous(),
                          bev.block_idx[:, :37].contiguous(), bev.counts,
                          bev.num_k_blocks)
        assert int(bev.counts.max()) > 37
    launches = mamba_step_events.launches
    y, h_new = mamba_step_events(bev, da, bm, cm, h, blk_k=st.blk_k)
    assert mamba_step_events.launches == launches + 1
    y2, h2 = mamba_step_events_ref(bev, da, bm, cm, h, blk_k=st.blk_k)
    assert torch.equal(h_new, h2)
    assert _close(y, y2)
    assert torch.equal(h_new[0], h[0] * da[0])
    if threshold > 0:
        assert torch.equal(h_new[1], h[1] * da[1])
    dead = (~live_block_mask(bev)).repeat_interleave(st.blk_k, 1)[:, :di]
    assert torch.equal(h_new[dead], (h * da)[dead])


def test_mamba_step_wrapper_builds_no_live_mask(dev, monkeypatch):
    """The B8 wrapper launches the kernel alone: the kernel derives the
    live mask from the events, so ``live_block_mask`` (patched to raise)
    is never called, and the result is the plain version's."""
    from repro_torch.core import events as ev
    b, di, n = 4, 1600, 16
    gen = torch.Generator(device=dev).manual_seed(6)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    g, bm, cm, h = f(b, di), f(b, n), f(b, n), f(b, di, n)
    da = torch.rand((b, di, n), generator=gen, device=dev) * 0.9 + 0.05
    g[::2, 32:160] = 0.0
    st = engine.fire_delta(g, engine.EngineConfig(threshold=0.0))

    def no_mask(bev):
        raise AssertionError("the B8 wrapper built a live mask")

    monkeypatch.setattr(ev, "live_block_mask", no_mask)
    launches = mamba_step_events.launches
    y, h_new = mamba_step_events(st.events, da, bm, cm, h, blk_k=st.blk_k)
    assert mamba_step_events.launches == launches + 1
    monkeypatch.undo()
    y2, h2 = mamba_step_events_ref(st.events, da, bm, cm, h, blk_k=st.blk_k)
    assert torch.equal(h_new, h2) and _close(y, y2)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("heads", [1, 3])
def test_wkv6_matches_plain(dev, d, heads):
    """B9' against its plain version at T 37 (the kernel stages 32 tokens
    at a time: a ragged last chunk) with a non-zero s0: S bitwise (the
    multiply, multiply, add in round-to-nearest intrinsics), o within
    1e-4 of max|plain|; B9 on each head's rows bitwise B9''s slice (the
    same kernel body), also with s0 None and bf16 inputs (cast to f32)."""
    b, t = 2, 37
    gen = torch.Generator(device=dev).manual_seed(d + heads)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    r, k, v = f(b, heads, t, d), f(b, heads, t, d), f(b, heads, t, d)
    w = torch.rand((b, heads, t, d), generator=gen, device=dev) * 0.7 + 0.3
    u, s0 = f(heads, d), f(b, heads, d, d)
    launches = wkv6.launches
    o, s = wkv6(r, k, v, w, u, s0)
    assert wkv6.launches == launches + 1
    o2, s2 = wkv6_multihead_ref(r, k, v, w, u, s0)
    assert torch.equal(s, s2)
    assert _close(o, o2)
    launches = wkv6_single.launches
    for h in range(heads):
        oh, sh = wkv6_single(r[:, h], k[:, h], v[:, h], w[:, h], u[h],
                             s0[:, h])
        assert torch.equal(oh, o[:, h]) and torch.equal(sh, s[:, h])
    assert wkv6_single.launches == launches + heads
    _, s_zero = wkv6(r, k, v, w, u)
    assert torch.equal(s_zero, wkv6_multihead_ref(r, k, v, w, u)[1])
    bf = [x.bfloat16() for x in (r, k, v, w)]
    assert torch.equal(wkv6(*bf, u)[1], wkv6(*(x.float() for x in bf), u)[1])


#: (D, heads, batch): G = batch x heads rows.  G 4 at D 64 splits each
#: row's columns over 4 CTAs (too few rows for the card), G 256 takes a
#: CTA a row.  D 20 stages a bf16 row in 8-byte copies (40 bytes); D 18
#: zero-pads its last granule, in 8-byte (f32) or 4-byte (bf16) copies;
#: D 13 takes 4-byte (f32) or 2-byte plain (bf16) copies.
WKV6_SHAPES = [(64, 1, 4), (64, 64, 4), (16, 3, 2), (20, 3, 2), (18, 1, 3),
               (13, 3, 2)]


def _wkv6_rows(gen, b, h, t, d, layout, dev):
    """r, k, v, w (B, H, T, D) in ``layout``: "f32" contiguous, "f32_t" f32
    (B, T, H, D).transpose(1, 2) views, "bf16" bf16 r, k, v and f32 w
    contiguous, "prefill" those as (B, T, H, D).transpose(1, 2) views (the
    RWKV6 prefill's)."""
    strided = layout in ("f32_t", "prefill")
    low = torch.bfloat16 if layout in ("bf16", "prefill") else torch.float32

    def make(x, dtype):
        x = x.to(dtype)
        return x.transpose(1, 2).contiguous().transpose(1, 2) if strided \
            else x.contiguous()
    f = lambda: torch.randn((b, h, t, d), generator=gen, device=dev)
    w = torch.rand((b, h, t, d), generator=gen, device=dev) * 0.7 + 0.3
    return [make(f(), low) for _ in range(3)] + [make(w, torch.float32)]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("layout", ["f32", "f32_t", "bf16", "prefill"])
@pytest.mark.parametrize("d,heads,b", WKV6_SHAPES)
@pytest.mark.parametrize("t", [1, 31, 32, 33, 37, 200, 600])
def test_wkv6_cases(dev, t, d, heads, b, layout, with_s0):
    """B9' across the kernel's edges: T 1, 31, 32, 33, 37, 200 and 600
    against its 32-token chunks, 8-token readout groups and the 128 tokens
    from which a thread takes 4 columns in place of 2 (T 200 split in two
    runs both); the shapes of
    ``WKV6_SHAPES`` (both grid splits, every copy width); r, k, v, w f32
    or bf16 r, k, v with f32 w, contiguous or strided as the prefill lays
    them; s0 None or given.  S bitwise the plain version's, o within 1e-4
    of max|plain|; o and S bitwise the kernel's on contiguous f32 copies
    of the same values (no order depends on a row's type, strides or
    alignment), and bitwise two launches over T split in two with S
    carried (none on T); B9 on each head's rows bitwise B9''s slice."""
    gen = torch.Generator(device=dev).manual_seed(1000 * d + t + heads)
    rows = _wkv6_rows(gen, b, heads, t, d, layout, dev)
    if heads > 1 and t > 1:
        assert all(x.is_contiguous() == (layout in ("f32", "bf16"))
                   for x in rows)
    u = torch.randn((heads, d), generator=gen, device=dev)
    s0 = torch.randn((b, heads, d, d), generator=gen, device=dev) \
        if with_s0 else None
    launches = wkv6.launches
    o, s = wkv6(*rows, u, s0)
    assert wkv6.launches == launches + 1
    o2, s2 = wkv6_multihead_ref(*rows, u, s0)
    assert torch.equal(s, s2)
    assert _close(o, o2)
    plain = [x.float().contiguous() for x in rows]
    o3, s3 = wkv6(*plain, u, s0)
    assert torch.equal(o3, o) and torch.equal(s3, s)
    if t > 1:
        cut = t // 2
        oa, sa = wkv6(*(x[:, :, :cut] for x in rows), u, s0)
        ob, sb = wkv6(*(x[:, :, cut:] for x in rows), u, sa)
        assert torch.equal(torch.cat([oa, ob], 2), o) and torch.equal(sb, s)
    launches = wkv6_single.launches
    for h in range(heads):
        oh, sh = wkv6_single(*(x[:, h] for x in rows), u[h],
                             None if s0 is None else s0[:, h])
        assert torch.equal(oh, o[:, h]) and torch.equal(sh, s[:, h])
    assert wkv6_single.launches == launches + heads


@pytest.mark.parametrize("di,n,t", [
    (40, 4, 13), (40, 16, 13), (1600, 4, 13), (1600, 16, 13),
    (1600, 16, 600), (40, 64, 600), (40, 8, 37), (40, 6, 37),
])
def test_mamba_scan_matches_plain(dev, di, n, t):
    """B10 (the streams entry) at T 13 (the kernel keeps 8 steps' loads in
    flight: a ragged last group), T 37 and T 600 (many times its pipeline's
    depth) with a non-zero h0; DI 40 leaves the last CTA's channels partly
    masked; N 16 reduces y by shuffles, N 4, 6, 8 and 64 in shared memory.
    h bitwise (the multiply and add in round-to-nearest intrinsics), y
    within 1e-4 of max|plain| (an N-term sum in another order); two
    launches with h carried equal one over the whole T."""
    b = 3
    gen = torch.Generator(device=dev).manual_seed(
        di + n if t == 13 else di + n + t)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    da = torch.exp(-2 * torch.rand((b, t, di, n), generator=gen, device=dev))
    dbx, c, h0 = f(b, t, di, n), f(b, t, n), f(b, di, n)
    launches = mamba_scan.launches
    y, h = mamba_scan(da, dbx, c, h0)
    assert mamba_scan.launches == launches + 1
    y2, h2 = mamba_scan_ref(da, dbx, c, h0)
    assert torch.equal(h, h2)
    assert _close(y, y2)
    ya, ha = mamba_scan(da[:, :5], dbx[:, :5], c[:, :5], h0)
    yb, hb = mamba_scan(da[:, 5:], dbx[:, 5:], c[:, 5:], ha)
    assert mamba_scan.launches == launches + 3
    assert torch.equal(hb, h) and torch.equal(torch.cat([ya, yb], 1), y)
    assert torch.equal(mamba_scan(da, dbx, c)[1],
                       mamba_scan_ref(da, dbx, c)[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("di,n", [(40, 4), (40, 16), (1600, 4), (1600, 16)])
@pytest.mark.parametrize("extra", [3, 100])
def test_mamba_scan_fused_matches_plain_and_the_streams_entry(dev, dtype,
                                                              with_h0, di, n,
                                                              extra):
    """B10's fused entry on dt, x, A, B and C laid out as the Mamba prefill
    hands them (a chunk sliced along T; B and C slices of one last
    dimension 2N + extra wide; dt softplus-positive, A = -exp(log 1..N)),
    T 37: h bitwise and y within 1e-4 of max|plain| against its plain
    version, and h and y bitwise the streams entry run on the streams torch
    builds from the same values (the kernel forms da with the expf
    torch.exp runs); two launches with h carried equal one.  Extra 100
    (the prefill's 2N + DT_RANK row) aligns B and C's rows to four
    elements, so N 16 takes the kernel's 16-byte (8-byte for bf16) loads;
    extra 3 leaves them unaligned, so it takes the 4-byte path."""
    b, t_all, t0, t = 3, 50, 6, 37
    gen = torch.Generator(device=dev).manual_seed(di + n + with_h0)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    dt_all = torch.nn.functional.softplus(f(b, t_all, di)).to(dtype)
    x_all = f(b, t_all, di).to(dtype)
    bc_all = f(b, t_all, 2 * n + extra).to(dtype)
    sl = slice(t0, t0 + t)
    dt, x = dt_all[:, sl], x_all[:, sl]
    bmat, cmat = bc_all[:, sl, :n], bc_all[:, sl, n:2 * n]
    assert not dt.is_contiguous() and not bmat.is_contiguous()
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=dev).repeat(di, 1)
    # mnf_mamba_scan_fused's condition for the wide loads
    row = 4 * bmat.element_size()
    wide = (a.data_ptr() % 16 == 0
            and all(m.data_ptr() % row == 0 and m.stride(0) % 4 == 0
                    and m.stride(1) % 4 == 0 for m in (bmat, cmat)))
    assert wide == (extra == 100)
    h0 = f(b, di, n) if with_h0 else None
    launches = mamba_scan_fused.launches
    y, h = mamba_scan_fused(dt, x, a, bmat, cmat, h0)
    assert mamba_scan_fused.launches == launches + 1
    y2, h2 = mamba_scan_fused_ref(dt, x, a, bmat, cmat, h0)
    assert torch.equal(h, h2)
    assert _close(y, y2)
    launches = mamba_scan.launches
    y3, h3 = mamba_scan(*mamba_scan_streams(dt, x, a, bmat, cmat), h0)
    assert mamba_scan.launches == launches + 1
    assert torch.equal(h, h3) and torch.equal(y, y3)
    ya, ha = mamba_scan_fused(dt[:, :11], x[:, :11], a, bmat[:, :11],
                              cmat[:, :11], h0)
    yb, hb = mamba_scan_fused(dt[:, 11:], x[:, 11:], a, bmat[:, 11:],
                              cmat[:, 11:], ha)
    assert torch.equal(hb, h) and torch.equal(torch.cat([ya, yb], 1), y)


def test_scan_launchers_refuse_other_dtypes_and_wide_heads(dev):
    """The launchers take f32 only (the fused B10 entry f32 or bf16 rows,
    all of one type, each with unit stride in its last dimension; B9 f32
    or bf16 rows, each of its own type), B9 no head wider than MAX_D, B10
    no state wider than MAX_N."""
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt,
                                                     device=dev)
    bf = torch.bfloat16
    with pytest.raises(TypeError):                   # f16 r
        wkv6_cuda(z(2, 3, 8, dt=torch.float16),
                  *(z(2, 3, 8) for _ in range(3)), z(8), None)
    with pytest.raises(ValueError, match="unit stride"):
        wkv6_cuda(z(2, 8, 3).transpose(1, 2), *(z(2, 3, 8) for _ in range(3)),
                  z(8), None)
    with pytest.raises(TypeError):
        mamba_scan_cuda(z(1, 3, 4, 2, dt=bf), z(1, 3, 4, 2), z(1, 3, 2),
                        None)
    rows = lambda dt: (z(1, 3, 4, dt=dt), z(1, 3, 4, dt=dt))
    with pytest.raises(TypeError):                   # f16 rows
        mamba_scan_fused_cuda(*rows(torch.float16), z(4, 2),
                              z(1, 3, 2, dt=torch.float16),
                              z(1, 3, 2, dt=torch.float16), None)
    with pytest.raises(TypeError):                   # bf16 dt, f32 x
        mamba_scan_fused_cuda(z(1, 3, 4, dt=bf), z(1, 3, 4), z(4, 2),
                              z(1, 3, 2, dt=bf), z(1, 3, 2, dt=bf), None)
    with pytest.raises(ValueError, match="unit stride"):
        mamba_scan_fused_cuda(z(1, 4, 3).transpose(1, 2), z(1, 3, 4),
                              z(4, 2), z(1, 3, 2), z(1, 3, 2), None)
    n = MAX_N + 1
    with pytest.raises(ValueError, match="state width"):
        mamba_scan_fused_cuda(*rows(torch.float32), z(4, n), z(1, 3, n),
                              z(1, 3, n), None)
    d = MAX_D + 1
    with pytest.raises(ValueError, match="head_dim"):
        wkv6_cuda(*(z(2, 3, d) for _ in range(4)), z(d), None)
    with pytest.raises(ValueError, match="head_dim"):
        wkv6_cuda(*(z(2, 3, 4, d, dt=bf) for _ in range(3)), z(2, 3, 4, d),
                  z(3, d), None)


# -- compiled steps: CUDA graphs replayed against the eager runs ------------

def _counted(fn):
    with kernels.count_launches() as seen:
        out = fn()
    torch.cuda.synchronize()
    return out, seen


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("net", ["mini", "mini_s4", "mlp_mini"])
def test_pipeline_replay_bitwise_eager(dev, net, int8):
    """A pipeline's replay is bitwise the eager forward on two inputs (the
    second replayed with no host sync); the capture saw the eager run's
    launches; other parameter tensors are refused."""
    fire_cfg = FireConfig(quantize_to_int8=int8)
    gen = torch.Generator(device=dev).manual_seed(0)
    if net == "mlp_mini":
        spec = mlp.MLP_MINI
        params = mlp.init_mlp_params(spec, gen, weight_sparsity=0.5)
        xs = [torch.relu(torch.randn((4, 64), generator=gen, device=dev))
              for _ in range(2)]
        pipe = mlp.make_mlp_pipeline(spec, batch=4, fire_cfg=fire_cfg)
        fwd = mlp.make_mlp_forward(spec, fire_cfg=fire_cfg)
    else:
        spec = cnn.MINI if net == "mini" else cnn.MINI_S4
        params = cnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
        size = spec.input_size
        xs = [torch.relu(torch.randn((2, size, size, 3), generator=gen,
                                     device=dev)) for _ in range(2)]
        pipe = cnn.make_cnn_pipeline(spec, batch=2, fire_cfg=fire_cfg)
        fwd = cnn.make_cnn_forward(spec, fire_cfg=fire_cfg)
    y_eager, eager = _counted(lambda: fwd(params, xs[0]))
    y = pipe(params, xs[0]).clone()
    assert pipe.graph.launches == eager and sum(eager.values()) > 0
    assert torch.equal(y, y_eager)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y2 = pipe(params, xs[1]).clone()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(y2, fwd(params, xs[1])) and not torch.equal(y2, y)
    with pytest.raises(ValueError, match="parameter tensors"):
        pipe([None if p is None else p.clone() for p in params], xs[0])


def _cache_equal(a, b):
    la, lb = graphs.leaves(a), graphs.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_lm_graphs_replay_bitwise_eager(dev, arch, gated):
    """The reduced model's graphed serve (prefill plus 4 decode steps) is
    bitwise the eager serve: tokens, events, logits and the final cache;
    the captures saw the eager run's launches (the decode's once a step);
    the decode loop makes no host sync (``run_lm`` runs it under
    set_sync_debug_mode("error")); a graphed step refuses a Python-int
    position and other parameter tensors."""
    cfg = serve.lm_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, mnf=dataclasses.replace(cfg.mnf,
                                                           enabled=gated))
    params = tfm.compute_params(tfm.init_params(0, cfg, dev), cfg)
    prompts = serve.make_prompts(cfg, 2, 12, 0, dev)
    ref, eager = _counted(lambda: serve.run_lm(
        params, cfg, prompts, 4, keep_logits=True, graph=False))
    run = serve.run_lm(params, cfg, prompts, 4, keep_logits=True)
    assert run["launches"] == eager
    for key in ("tokens", "inputs", "prefill_logits", "logits"):
        assert torch.equal(run[key], ref[key]), key
    assert (run["events"] is None) == (not gated)
    if gated:
        assert torch.equal(run["events"], ref["events"])
    assert _cache_equal(run["cache"], ref["cache"])
    srv = steps.make_serve_step(cfg, ShapeConfig("s", 16, 2, "decode"))
    tok = prompts[:, :1]
    with pytest.raises(TypeError, match="0-d integer tensor"):
        srv.fn(params, run["cache"], dict(tokens=tok), 12)
    pos = torch.full((), 12, dtype=torch.int64, device=dev)
    srv.fn(params, run["cache"], dict(tokens=tok), pos)
    other = tfm.compute_params(tfm.init_params(1, cfg, dev), cfg)
    with pytest.raises(ValueError, match="parameter tensors"):
        srv.fn(other, run["cache"], dict(tokens=tok), pos)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "gemma2-27b"])
def test_lm_stack_graphs_replay_bitwise_eager_twice(dev, arch, gated):
    """The reduced DeepSeek-V2-Lite (MLA, the sort-dispatched MoE and its
    dense first layer) and Gemma-2 (softcaps, alternating windows, tied
    embeddings) in their own bf16: the graphed serve (prefill plus 4
    decode steps) is bitwise the eager serve — tokens, logits and every
    cache leaf — and a second eager and a second graphed serve repeat
    those bits (the MoE combine sums each token's contributions in a
    fixed order, with no float atomics); no B1-B10 kernel launches on
    this path; the decode loop makes no host sync."""
    cfg = serve.lm_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, mnf=dataclasses.replace(cfg.mnf,
                                                           enabled=gated))
    params = tfm.init_compute_params(0, cfg, dev)
    prompts = serve.make_prompts(cfg, 2, 12, 0, dev)
    runs = []
    for graph in (False, True, False, True):
        run, seen = _counted(lambda: serve.run_lm(
            params, cfg, prompts, 4, keep_logits=True, graph=graph))
        assert not any(seen.values()), seen
        runs.append(run)
    for run in runs[1:]:
        for key in ("tokens", "inputs", "prefill_logits", "logits"):
            assert torch.equal(run[key], runs[0][key]), key
        assert _cache_equal(run["cache"], runs[0]["cache"])
    assert runs[1]["launches"] == {} and runs[0]["events"] is None


@pytest.mark.parametrize("net", ["mini", "mlp_mini"])
def test_serve_engine_on_card(dev, net):
    """``ServeEngine`` on the card, buckets (1, 2, 4): one capture a bucket
    at the warm-up and none over ticks (1, 3, 0, 4, 2); every request
    served FIFO; within a bucket a real row bitwise the same row of a
    full bucket; every served logit row bitwise the unpadded graphed
    forward's; each replay runs under the engine's no-host-sync guard,
    which raises at a sync."""
    gen = torch.Generator(device=dev).manual_seed(0)
    if net == "mlp_mini":
        spec = mlp.MLP_MINI
        params = mlp.init_mlp_params(spec, gen, weight_sparsity=0.5)
        shape = (spec.in_features,)
        make = mlp.make_mlp_pipeline
    else:
        spec = cnn.MINI
        params = cnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
        shape = (8, 8, 3)
        make = cnn.make_cnn_pipeline
    buckets = (1, 2, 4)
    images = torch.relu(torch.randn((10,) + shape,
                                    generator=torch.Generator()
                                    .manual_seed(1)))
    eng = serving.ServeEngine(spec, params,
                              serving.ServeEngineConfig(buckets=buckets))
    assert eng.device.type == "cuda" and eng.recompiles == len(buckets)
    assert all(p.fn.graph is not None for p in eng.plans.values())
    it = iter(images)
    for n in (1, 3, 0, 4, 2):
        for _ in range(n):
            eng.submit(next(it))
        eng.run_tick()
        assert eng.recompiles == len(buckets)
    assert [r.rid for r in eng.completed] == list(range(10))
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    for b in buckets[1:]:
        full = eng.forward(b, list(images[:b]))
        assert torch.equal(bits(eng.forward(b, [images[0]])[0]),
                           bits(full[0]))
    ref = make(spec, batch=10)(eng.params, images.to(dev)).cpu()
    got = torch.stack([r.result for r in eng.completed])
    assert torch.equal(bits(got), bits(ref))
    assert eng.boundary_report(4)["fallback_decodes"] == 0
    assert all(g["pool_gib"] >= 0 for g in eng.graph_gib.values())
    with pytest.raises(RuntimeError):
        with server._no_host_sync(dev):
            torch.ones(1, device=dev).item()

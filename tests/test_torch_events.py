"""repro_torch.core.events against repro.core.events: the same numpy inputs,
integer arrays exactly equal, messages verbatim."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro_torch.core import events as tev


def _fired(seed, shape, sparsity=0.5):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape) * (r.random(shape) > sparsity)
    return np.maximum(x, 0).astype(np.float32)


def _jit(fn, *args, **static):
    """Run a JAX function as one compiled call (eager dispatch compiles
    every small op separately, which dominates these tests' time)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _assert_bev_equal(tb, jb):
    np.testing.assert_array_equal(tb.values.numpy(), np.asarray(jb.values))
    np.testing.assert_array_equal(tb.block_idx.numpy(),
                                  np.asarray(jb.block_idx))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    assert tb.block_idx.dtype == torch.int32 and tb.counts.dtype == torch.int32
    assert tb.num_k_blocks == jb.num_k_blocks


@pytest.mark.parametrize("m,k,bm,bk,cap,thr,sp", [
    (8, 64, 8, 8, None, 0.0, 0.5),
    (16, 128, 1, 8, None, 0.0, 0.9),
    (12, 48, 4, 16, 2, 0.0, 0.7),       # capacity below the live count
    (8, 40, 8, 8, None, 0.3, 0.2),      # threshold > 0
    (4, 32, 1, 8, None, 0.0, 1.0),      # all-empty groups
])
def test_encode_decode_match(m, k, bm, bk, cap, thr, sp):
    x = _fired(m * k, (m, k), sp)
    tb = tev.encode_block_events(torch.from_numpy(x), blk_m=bm, blk_k=bk,
                                 capacity=cap, threshold=thr)
    jb = _jit(jev.encode_block_events, jnp.asarray(x), blk_m=bm, blk_k=bk,
              capacity=cap, threshold=thr)
    _assert_bev_equal(tb, jb)
    if cap is None and thr == 0.0:
        y = tev.decode_block_events(tb, blk_m=bm, blk_k=bk, m=m, k=k)
        np.testing.assert_array_equal(y.numpy(), x)


def test_encode_with_occupancy_equals_rescan():
    x = _fired(3, (16, 64))
    live = torch.from_numpy(x).reshape(2, 8, 8, 8).permute(0, 2, 1, 3) \
        .flatten(2).ne(0).any(-1)
    a = tev.encode_block_events(torch.from_numpy(x), blk_m=8, blk_k=8)
    b = tev.encode_block_events(torch.from_numpy(x), blk_m=8, blk_k=8,
                                live=live)
    for f in ("values", "block_idx", "counts"):
        assert torch.equal(getattr(a, f), getattr(b, f))


GEOMS = [  # (B, H, W, C), k, padding, stride — strides 1, 2 and 4
    ((2, 5, 16, 8), 3, 1, 1), ((1, 4, 8, 8), 1, 0, 1),
    ((1, 3, 24, 4), 5, 2, 1), ((2, 8, 16, 8), 3, 1, 2),
    ((1, 6, 32, 4), 1, 0, 2), ((1, 9, 32, 4), 3, 1, 4),
    ((1, 12, 64, 3), 11, 4, 4), ((1, 8, 32, 8), 1, 0, 4),
]


@pytest.mark.parametrize("shape,k,p,s", GEOMS)
def test_strip_plan_and_gathers_match(shape, k, p, s):
    assert tev.strip_ineligible_reason(shape[2], k, s, p) is None
    assert tev.strip_subtap_counts(k, p, s) == jev.strip_subtap_counts(k, p,
                                                                       s)
    tplan = tev.strip_tap_map(shape, k, p, s)
    jplan = jev.strip_tap_map(shape, k, p, s)
    for a, b in zip(tplan, jplan):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    x = _fired(k + s, (shape[0] * shape[1] * shape[2], shape[3]))
    bk = min(4, shape[3])
    tb = tev.encode_block_events(torch.from_numpy(x), blk_m=8, blk_k=bk)
    jb = _jit(jev.encode_block_events, jnp.asarray(x), blk_m=8, blk_k=bk)
    src, live, shift, _ = jplan
    # the first subtap of up to six distinct row shifts, both signs included
    firsts = sorted({int(d): t for t, d in reversed(list(enumerate(shift)))}
                    .items())
    for _, t in firsts[:3] + firsts[3:][-3:]:
        _assert_bev_equal(
            tev.gather_row_strips(tb, torch.from_numpy(src[:, t].copy()),
                                  torch.from_numpy(live[:, t].copy()),
                                  int(shift[t]), s),
            _jit(jev.gather_row_strips, jb, jnp.asarray(src[:, t]),
                 jnp.asarray(live[:, t]), shift=int(shift[t]), row_stride=s))


@pytest.mark.parametrize("shape,k,s,bm", [
    ((2, 8, 16, 8), 2, 2, 8), ((1, 6, 8, 4), 3, 2, 1),
    ((1, 4, 8, 8), 2, 2, 8), ((2, 7, 7, 4), 3, 2, 1),
    ((1, 32, 32, 8), 2, 2, 8),
])
def test_pool_plans_match(shape, k, s, bm):
    for a, b in zip(tev.pool_window_map(shape, k, s, bm),
                    jev.pool_window_map(shape, k, s, bm)):
        np.testing.assert_array_equal(a, b)
    reason = tev.pool_window_ineligible_reason(shape, k, s, bm)
    assert reason == jev.pool_window_ineligible_reason(shape, k, s, bm)
    if reason is None:
        for a, b in zip(tev.pool_strip_map(shape, k, s),
                        jev.pool_strip_map(shape, k, s)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,bm,bk,sp", [
    ((2, 2, 8, 16), 8, 8, 0.6), ((2, 3, 3, 16), 1, 8, 0.8),
    ((1, 1, 8, 8), 8, 8, 1.0),          # zero-event stream
])
def test_retile_matches(shape, bm, bk, sp):
    b, h, w, c = shape
    x = _fired(7, (b * h * w, c), sp)
    tb = tev.encode_block_events(torch.from_numpy(x), blk_m=bm, blk_k=bk)
    jb = _jit(jev.encode_block_events, jnp.asarray(x), blk_m=bm, blk_k=bk)
    np.testing.assert_array_equal(
        tev.retile_fc_addr_offsets(shape, c // bk, c // bk),
        jev.retile_fc_addr_offsets(shape, c // bk, c // bk))
    _assert_bev_equal(tev.retile_block_events(tb, shape, bm),
                      _jit(jev.retile_block_events, jb, logical_shape=shape,
                           blk_m=bm))


def test_ineligible_reasons_verbatim():
    for width in (0, 8, 12, 16, 24, 64):
        for k in (1, 3, 5, 11, 19):
            for stride in (1, 2, 3, 4):
                for padding in (0, 1, 2, 4, 5, 9):
                    for co in (None, 8, 12):
                        assert tev.strip_ineligible_reason(
                            width, k, stride, padding, co) == \
                            jev.strip_ineligible_reason(width, k, stride,
                                                        padding, co)
    for shape in ((1, 8, 16, 4), (1, 8, 12, 4), (1, 1, 8, 4),
                  (1, 8, 18, 4), (1, 16, 32, 4)):
        for k, s in ((2, 2), (3, 2), (3, 1), (9, 9)):
            for bm in (1, 8):
                assert tev.pool_window_ineligible_reason(shape, k, s, bm) == \
                    jev.pool_window_ineligible_reason(shape, k, s, bm)
    for shape in (None, (4, 8), (1, 2, 2, 12), (1, 2, 2, 16)):
        for bm, bk in ((1, 8), (8, 8), (4, 8), (1, 5)):
            assert tev.retile_ineligible_reason(shape, bm, bk) == \
                jev.retile_ineligible_reason(shape, bm, bk)


# -- the event matmul's precondition: live addresses ascend per group ----------
# B2/B5 (csrc/event_matmul.cu) walk the ascending union of a CTA's groups'
# K-blocks, so each group's live a_idx slots must be strictly ascending for
# the walk to keep the order e ascending.  Every producer hands them so.

def _assert_live_ascending(a_idx, counts):
    e = a_idx.shape[1]
    live = torch.arange(e)[None, :] < counts.clamp(max=e)[:, None]
    pairs = live[:, 1:] & live[:, :-1]
    assert bool((a_idx[:, 1:] > a_idx[:, :-1])[pairs].all()), \
        "a group's live block addresses are not strictly ascending"
    return int(pairs.sum())


@pytest.mark.parametrize("producer", ["encode", "encode_capacity",
                                      "retile_pixel", "retile_strip",
                                      "gather_padded_taps"])
def test_producers_hand_ascending_addresses(producer):
    from repro_torch.engine.backends import tap_row_map
    shape = (2, 5, 8, 32)
    x = torch.from_numpy(_fired(11, (2 * 5 * 8, 32), 0.6))
    bm = 8 if producer == "retile_strip" else 1
    bev = tev.encode_block_events(
        x, blk_m=bm, blk_k=8,
        capacity=2 if producer == "encode_capacity" else None)
    if producer == "encode_capacity":
        assert int(bev.counts.max()) > bev.capacity
    if producer.startswith("retile"):
        bev = tev.retile_block_events(bev, shape, bm)
    if producer == "gather_padded_taps":
        idx, live = tap_row_map(shape, 3, 1, 1)
        for t in range(9):
            tap = tev.gather_row_groups(bev, torch.from_numpy(idx[t]),
                                        torch.from_numpy(live[t]))
            # every tap but the centre one reads the zero-padding border
            assert (int((tap.counts == 0).sum()) > 0) == (t != 4)
            assert _assert_live_ascending(tap.block_idx, tap.counts) > 0
        return
    assert _assert_live_ascending(bev.block_idx, bev.counts) > 0


def _vgg16_topology():
    """VGG16's 13 convs, 5 pools and 3 FCs at input 32, channels 8–32:
    strip convs (widths 32/16/8), per-tap convs (widths 4/2, taps in the
    padding border), the conv→FC re-tile, event FCs."""
    from repro_torch.models import cnn
    conv = lambda co: cnn.ConvSpec(co, 3, 1, 1)  # noqa: E731
    p = cnn.PoolSpec()
    layers = (conv(8), conv(8), p, conv(16), conv(16), p,
              conv(16), conv(16), conv(16), p, conv(32), conv(32), conv(32),
              p, conv(32), conv(32), conv(32), p, cnn.FCSpec(64),
              cnn.FCSpec(64), cnn.FCSpec(10))
    return cnn.CNNSpec("vgg16_topology", 32, 3, layers, num_classes=10)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_event_matmul_inputs_ascend_on_vgg16_topology(monkeypatch, mode):
    """Every B2/B5 call of a VGG16-topology forward, chained and round trip,
    gets strictly ascending live addresses per group: the per-tap gathers
    (zero-count border taps included), the re-tiled FC1 stream and the
    encoded FC streams."""
    from repro_torch.core.fire import FireConfig
    from repro_torch.kernels.event_matmul import ops
    from repro_torch.models import cnn
    seen = []

    def spy(orig):
        def f(a_vals, a_idx, counts, *rest):
            seen.append((tuple(a_vals.shape), int((counts == 0).sum()),
                         _assert_live_ascending(a_idx, counts)))
            return orig(a_vals, a_idx, counts, *rest)
        return f

    name = "event_matmul_int8_ref" if mode == "int8" else "event_matmul_ref"
    monkeypatch.setattr(ops, name, spy(getattr(ops, name)))
    spec = _vgg16_topology()
    gen = torch.Generator().manual_seed(5)
    params = cnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((2, 32, 32, 3), generator=gen))
    fire_cfg = FireConfig(quantize_to_int8=mode == "int8")
    for chain in (True, False):
        cnn.cnn_forward(params, x, spec, fire_cfg=fire_cfg, chain=chain,
                        device="cpu")
    per_tap = [s for s in seen if s[0][0] > 2]
    fc = [s for s in seen if s[0][0] <= 2]
    # the chain's 6 per-tap convs and 3 FCs at least (the f32 round trip
    # also runs its strip layers per tap)
    assert len(per_tap) >= 6 * 9 and len(fc) >= 3
    assert any(zeros for _, zeros, _ in per_tap)
    assert sum(pairs for _, _, pairs in fc) > 0


# -- the strip conv's per-tap flush (csrc/event_conv.cu) ----------------------
# B3/B6 sum each tap into one register and flush it once: bitwise the
# per-subtap flush because the parts of a tap are contiguous in the plan,
# taps ascend, and a tap's parts source each output row of a strip exactly
# once (the other parts add an exact 0).  The kernel also walks a source
# strip's live K-blocks ascending, so its live a_idx must ascend.

def _spec_strip_convs(spec):
    """(name, (1, H, W, CI), k, padding, stride) of every conv of ``spec``
    the strip route takes, at batch 1."""
    from repro_torch.models import cnn
    h = w = spec.input_size
    c = spec.in_ch
    out = []
    for i, layer in enumerate(spec.layers):
        if isinstance(layer, cnn.FCSpec):
            break
        if isinstance(layer, cnn.PoolSpec):
            h = (h - layer.k) // layer.stride + 1
            w = (w - layer.k) // layer.stride + 1
            continue
        k, s, p = layer.k, layer.stride, layer.padding
        if tev.strip_ineligible_reason(w, k, s, p, layer.out_ch) is None:
            out.append((f"{spec.name}-{i}", (1, h, w, c), k, p, s))
        h = (h + 2 * p - k) // s + 1
        w = (w + 2 * p - k) // s + 1
        c = layer.out_ch
    return out


def _plan_geometries():
    from repro_torch.models import cnn
    geoms = [(f"geom{i}", *g) for i, g in enumerate(GEOMS)]
    return geoms + _spec_strip_convs(cnn.VGG16) \
        + _spec_strip_convs(cnn.ALEXNET_FF)


def _assert_per_tap_flush_holds(tap, shift, stride):
    """Taps ascend (so a tap's parts are contiguous) and each tap's parts
    source each of a strip's output rows exactly once."""
    tap, shift = np.asarray(tap), np.asarray(shift)
    assert (np.diff(tap) >= 0).all(), "taps do not ascend in the plan"
    rows = stride * np.arange(tev.STRIP_W)[None, :] + shift[:, None]
    sourced = (rows >= 0) & (rows < tev.STRIP_W)             # (T, 8)
    for t in np.unique(tap):
        per_row = sourced[tap == t].sum(0)
        assert (per_row == 1).all(), (int(t), per_row.tolist())
    return len(np.unique(tap))


@pytest.mark.parametrize("name,shape,k,p,s", _plan_geometries(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_strip_plan_parts_source_each_row_once(name, shape, k, p, s):
    """The identity under the strip conv's per-tap flush, for every
    geometry above and every strip conv of VGG16 and ALEXNET_FF."""
    src, live, shift, tap = tev.strip_tap_map(shape, k, p, s)
    assert _assert_per_tap_flush_holds(tap, shift, s) == k * k


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_event_conv_inputs_ascend_on_vgg16_topology(monkeypatch, mode):
    """Every B3/B6 call of a VGG16-topology chained forward gets strictly
    ascending live addresses per source strip, and a plan whose per-tap
    flush is exact."""
    from repro_torch.core.fire import FireConfig
    from repro_torch.kernels.event_conv import ops
    from repro_torch.models import cnn
    seen = []

    def spy(orig):
        def f(a_vals, a_idx, tap, shift, src, cnt, *rest, nkb, row_stride):
            # a source strip's live count: its count wherever the plan
            # reads it live
            counts = torch.zeros(a_idx.shape[0], dtype=torch.int32)
            counts.scatter_reduce_(0, src.flatten().long(), cnt.flatten(),
                                   "amax")
            seen.append((a_vals.dtype,
                         _assert_live_ascending(a_idx, counts),
                         _assert_per_tap_flush_holds(tap, shift,
                                                     row_stride)))
            return orig(a_vals, a_idx, tap, shift, src, cnt, *rest, nkb=nkb,
                        row_stride=row_stride)
        return f

    for name in ("event_conv_ref", "event_conv_int8_ref"):
        monkeypatch.setattr(ops, name, spy(getattr(ops, name)))
    spec = _vgg16_topology()
    gen = torch.Generator().manual_seed(6)
    params = cnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((2, 32, 32, 3), generator=gen))
    cnn.cnn_forward(params, x, spec, device="cpu",
                    fire_cfg=FireConfig(quantize_to_int8=mode == "int8"))
    # the chain's 7 strip convs (widths 32, 16, 8): B3 x 7 in f32; in
    # int8 B3 on the f32 input, then B6 x 6 on codes
    dtypes = [d for d, _, _ in seen]
    assert len(seen) == 7
    assert dtypes.count(torch.int8) == (6 if mode == "int8" else 0)
    # the layers of 16 channels (two K-blocks a strip) have live pairs
    assert sum(pairs > 0 for _, pairs, _ in seen) >= 4


# -- the event pool's precondition (csrc/event_pool.cu) ------------------------
# B4b builds a table slot[t][kb] of each tap's live events, one writer a
# K-block, so a source group's live a_idx must be distinct: they ascend
# strictly.

@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_event_pool_inputs_ascend_on_vgg16_topology(monkeypatch, mode):
    """Every B4a/B4b call of a VGG16-topology chained forward reads live
    source groups whose addresses ascend strictly; the forward pools
    window-major twice (B4a) and per pixel three times (B4b)."""
    from repro_torch.core.fire import FireConfig
    from repro_torch.kernels.event_pool import ops
    from repro_torch.models import cnn
    seen = []

    def spy(kind, orig):
        def f(a_vals, a_idx, plan, src, cnt, **kw):
            # a source group's live count: its count wherever the plan
            # reads it live
            counts = torch.zeros(a_idx.shape[0], dtype=torch.int32)
            counts.scatter_reduce_(0, src.flatten().long(), cnt.flatten(),
                                   "amax")
            seen.append((kind, tuple(a_vals.shape),
                         _assert_live_ascending(a_idx, counts)))
            return orig(a_vals, a_idx, plan, src, cnt, **kw)
        return f

    monkeypatch.setattr(ops, "event_pool_ref",
                        spy("B4b", ops.event_pool_ref))
    monkeypatch.setattr(ops, "event_pool_window_ref",
                        spy("B4a", ops.event_pool_window_ref))
    spec = _vgg16_topology()
    gen = torch.Generator().manual_seed(6)
    params = cnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((2, 32, 32, 3), generator=gen))
    cnn.cnn_forward(params, x, spec, device="cpu",
                    fire_cfg=FireConfig(quantize_to_int8=mode == "int8"))
    kinds = [k for k, _, _ in seen]
    assert kinds.count("B4a") == 2 and kinds.count("B4b") == 3
    per_pixel = [(shape, pairs) for k, shape, pairs in seen if k == "B4b"]
    assert all(shape[2] == 1 for shape, _ in per_pixel)
    assert all(pairs > 0 for _, pairs in per_pixel), per_pixel

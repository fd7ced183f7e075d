"""The port's ``scalar`` backend — the paper's Algorithm 2
(``scalar_event_linear``) and Algorithm 1 (``scalar_event_conv2d``) with
the §4.1.1 event fields (``event_params_for_pixel``) — against ``repro``
on the CPU, on the same numpy inputs:

- ``event_params_for_pixel`` exactly equal over every pixel of a 9 x 9
  map for k in {1, 3, 5}, stride in {1, 2, 4}, padding in {0, 1, 2}
  (clipped and all-clipped pixels included);
- the scalar linear and conv against JAX's and against the port's dense
  oracle (the sums run in another order: at the tolerance of
  ``tests/test_mnf_linear.py`` and ``tests/test_mnf_conv.py``); the
  ``mnf_linear`` / ``mnf_conv2d`` shims;
- ``engine.linear``, ``conv2d``, ``maxpool2d``, ``fire`` and
  ``fire_conv`` under ``"scalar"`` against JAX's engine, with the ops
  registered under ``"scalar"`` those of JAX's registry; a stream handed
  to the scalar backend decodes, visibly; ``"scalar"`` resolves on CPU
  tensors and on a CUDA device; ``engine.describe`` against JAX's.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import mnf_conv as jconv
from repro.engine import registry as jregistry
from repro_torch import engine as tengine
from repro_torch.core import mnf_conv as tconv
from repro_torch.core import mnf_linear as tlin
from repro_torch.core.fire import FireConfig as TFireConfig
from repro_torch.engine import registry as tregistry

# ``repro.core`` re-exports a function named like the module
jlin = importlib.import_module("repro.core.mnf_linear")
jfire = importlib.import_module("repro.core.fire")

CONV_TOL = 1e-4       # tests/test_mnf_conv.py
LINEAR_TOL = 1e-5     # tests/test_mnf_linear.py, the scalar case


def _relu_normal(shape, seed, density=0.5):
    r_ = np.random.default_rng(seed)
    x = np.maximum(r_.normal(size=shape), 0.0)
    return (x * (r_.random(shape) < 2 * density)).astype(np.float32)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_event_params_for_pixel_equal_jax(k, stride):
    """All eight fields exactly equal, over every pixel of a 9 x 9 map and
    paddings 0, 1, 2 — negative numerators floor-divide alike."""
    iy, ix = np.meshgrid(np.arange(9), np.arange(9), indexing="ij")
    iy, ix = iy.reshape(-1).astype(np.int32), ix.reshape(-1).astype(np.int32)
    clipped = 0
    for p in (0, 1, 2):
        oy = jconv.conv_out_size(9, k, stride, p)
        want = jconv.event_params_for_pixel(
            jnp.asarray(iy), jnp.asarray(ix), k=k, stride=stride, padding=p,
            oy_size=oy, ox_size=oy)
        got = tconv.event_params_for_pixel(
            torch.from_numpy(iy), torch.from_numpy(ix), k=k, stride=stride,
            padding=p, oy_size=oy, ox_size=oy)
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        clipped += int((np.asarray(want[2]) < k - 1).sum())
        # scalar ints give the same fields
        one = tconv.event_params_for_pixel(int(iy[-1]), int(ix[-1]), k=k,
                                           stride=stride, padding=p,
                                           oy_size=oy, ox_size=oy)
        assert [int(v) for v in one] == [int(np.asarray(w)[-1])
                                         for w in want]
    assert clipped > 0 or (k, stride) == (1, 1)


@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_scalar_event_linear_matches_jax_and_dense(density):
    """Signed events at the reference test's scale (K 48, N 16): none,
    some, and every neuron firing."""
    r_ = np.random.default_rng(1)
    x = (r_.normal(size=(48,)) * (r_.random(48) < density)).astype(
        np.float32)
    w, b = _normal((48, 16), 2), _normal((16,), 3)
    got = tlin.scalar_event_linear(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b)).numpy()
    want = np.asarray(jlin.scalar_event_linear(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(b)))
    dense = tlin.dense_linear(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=LINEAR_TOL)
    np.testing.assert_allclose(got, dense, atol=LINEAR_TOL)
    with pytest.raises(AssertionError, match="per-activation-vector"):
        tlin.scalar_event_linear(torch.zeros(2, 3), torch.zeros(3, 4))


@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("stride", [1, 2])
def test_scalar_event_conv2d_matches_jax_and_dense(stride, padding):
    x = _relu_normal((10, 9, 4), 4)
    w = _normal((3, 3, 4, 6), 5)
    got = tconv.scalar_event_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                    stride=stride, padding=padding).numpy()
    want = np.asarray(jconv.scalar_event_conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding))
    dense = tconv.dense_conv2d(torch.from_numpy(x)[None], torch.from_numpy(w),
                               stride=stride, padding=padding)[0].numpy()
    assert got.shape == want.shape == dense.shape
    np.testing.assert_allclose(got, want, atol=CONV_TOL)
    np.testing.assert_allclose(got, dense, atol=CONV_TOL)


def test_scalar_event_conv2d_k5_stride4_reaches_every_output():
    """A filter wider than the stride and pixels that touch no output
    (stride 4 over k 1 skips them): the walk's masks hold either way."""
    x = _relu_normal((13, 13, 2), 6, density=0.9)
    for k, s, p in ((5, 4, 2), (1, 4, 0), (5, 1, 2)):
        w = _normal((k, k, 2, 3), 7)
        got = tconv.scalar_event_conv2d(torch.from_numpy(x),
                                        torch.from_numpy(w), stride=s,
                                        padding=p).numpy()
        want = np.asarray(jconv.scalar_event_conv2d(
            jnp.asarray(x), jnp.asarray(w), stride=s, padding=p))
        np.testing.assert_allclose(got, want, atol=CONV_TOL)


def test_mnf_linear_and_conv2d_shims_match_jax():
    x, w, b = _relu_normal((5, 64), 8), _normal((64, 16), 9), _normal((16,),
                                                                       10)
    got = tlin.mnf_linear(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), blk_m=4, blk_k=16)
    want = jlin.mnf_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           blk_m=4, blk_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    assert float(got.min()) >= 0.0 and float(got.max()) > 0.0

    xc, wc = _relu_normal((2, 8, 8, 4), 11), _normal((3, 3, 4, 8), 12)
    fc = TFireConfig(threshold=0.2)
    got = tconv.mnf_conv2d(torch.from_numpy(xc), torch.from_numpy(wc),
                           stride=2, padding=1, fire_cfg=fc)
    want = jconv.mnf_conv2d(jnp.asarray(xc), jnp.asarray(wc), stride=2,
                            padding=1,
                            fire_cfg=jfire.FireConfig(threshold=0.2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CONV_TOL)


# ---------------------------------------------------------------------------
# The engine under "scalar"
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    return (jengine.EngineConfig(backend="scalar", **kw),
            tengine.EngineConfig(backend="scalar", **kw))


def test_scalar_registers_the_ops_jax_registers():
    jops = {o for (o, n) in jregistry._REGISTRY if n == "scalar"}
    tops = {o for (o, n) in tregistry._REGISTRY if n == "scalar"}
    assert tops == jops == {"matmul", "linear", "conv2d", "maxpool2d",
                            "fire", "fire_conv"}
    assert "scalar" in tengine.BACKENDS


def test_engine_linear_and_matmul_scalar_match_jax():
    jc, tc = _cfgs()
    x, w, b = _relu_normal((3, 50), 13), _normal((50, 12), 14), \
        _normal((12,), 15)
    got = tengine.linear(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), tc)
    want = jengine.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LINEAR_TOL)
    got = tengine.matmul(torch.from_numpy(x), torch.from_numpy(w), tc)
    want = jengine.matmul(jnp.asarray(x), jnp.asarray(w), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LINEAR_TOL)


@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 0), (2, 1)])
def test_engine_conv2d_scalar_matches_jax(stride, padding):
    jc, tc = _cfgs()
    x, w, b = _relu_normal((2, 8, 8, 3), 16), _normal((3, 3, 3, 8), 17), \
        _normal((8,), 18)
    got = tengine.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), tc, stride=stride,
                         padding=padding)
    want = jengine.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jc,
                          stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CONV_TOL)


def test_engine_maxpool_and_fire_scalar_match_jax():
    jc, tc = _cfgs(blk_m=2, blk_k=4, threshold=0.3)
    x = _normal((2, 6, 6, 4), 19)
    got = tengine.maxpool2d(torch.from_numpy(x), 2, 2, tc)
    want = jengine.maxpool2d(jnp.asarray(x), 2, 2, jc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    acc = _normal((6, 8), 20)
    ts, js = tengine.fire(torch.from_numpy(acc), tc), \
        jengine.fire(jnp.asarray(acc), jc)
    np.testing.assert_array_equal(ts.dense().numpy(), np.asarray(js.dense()))
    np.testing.assert_array_equal(ts.events.counts.numpy(),
                                  np.asarray(js.events.counts))
    np.testing.assert_array_equal(ts.events.values.numpy(),
                                  np.asarray(js.events.values))

    ts = tengine.fire_conv(torch.from_numpy(x), tc)
    js = jengine.fire_conv(jnp.asarray(x), jc)
    assert ts.logical_shape == tuple(js.logical_shape)
    np.testing.assert_array_equal(ts.dense().numpy(), np.asarray(js.dense()))
    np.testing.assert_array_equal(ts.events.block_idx.numpy(),
                                  np.asarray(js.events.block_idx))


def test_scalar_backend_decodes_a_stream_visibly():
    """A block stream handed to the scalar backend decodes (it registers
    no ``linear_events`` op) and the trace says so; the result agrees
    with the block path and with JAX's scalar engine on the same
    stream."""
    acc = _normal((8, 16), 21)
    w = _normal((16, 6), 22)
    tb = tengine.EngineConfig(backend="block", blk_m=4, blk_k=8)
    jb = jengine.EngineConfig(backend="block", blk_m=4, blk_k=8)
    ts = tengine.fire(torch.from_numpy(acc), tb)
    with tengine.trace_dispatch() as recs:
        got = tengine.linear(ts, torch.from_numpy(w),
                             cfg=tb.replace(backend="scalar"))
    assert [(r["op"], r["backend"], r.get("fallback_decode")) for r in recs] \
        == [("linear", "scalar", True)]
    block = tengine.linear(ts, torch.from_numpy(w), cfg=tb)
    want = jengine.linear(jengine.fire(jnp.asarray(acc), jb), jnp.asarray(w),
                          cfg=jb.replace(backend="scalar"))
    np.testing.assert_allclose(got.numpy(), block.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_scalar_resolves_on_cpu_tensors_and_on_a_cuda_device():
    cfg = tengine.EngineConfig(backend="scalar")
    assert cfg.resolve_backend(torch.zeros(1)) == "scalar"
    assert cfg.resolve_backend(torch.device("cuda")) == "scalar"
    assert cfg.resolve_backend(torch.device("cuda"), torch.zeros(1)) \
        == "scalar"
    assert tregistry.dispatch("conv2d", cfg, torch.device("cuda")) \
        is tregistry.get_backend("conv2d", "scalar")
    auto = tengine.EngineConfig()
    assert {auto.resolve_backend(torch.zeros(1)),
            auto.resolve_backend(torch.device("cuda"))} == {"block", "cuda"}


@pytest.mark.parametrize("backend", ["auto", "scalar", "dense"])
def test_describe_matches_jax(backend):
    """JAX's keys less ``interpret`` and ``blk_n``, the same values on the
    CPU; the device is the one the caller passes (the card's by
    default)."""
    kw = dict(blk_m=4, blk_k=32, capacity=7, threshold=0.25, magnitude=True)
    want = jengine.describe(jengine.EngineConfig(backend=backend, **kw))
    got = tengine.describe(tengine.EngineConfig(backend=backend, **kw),
                           device="cpu")
    assert got == {k: v for k, v in want.items()
                   if k not in ("interpret", "blk_n")}
    cuda = tengine.describe(tengine.EngineConfig(backend=backend, **kw),
                            device="cuda")
    assert cuda["device"] == "cuda"
    assert cuda["backend"] == ("cuda" if backend == "auto" else backend)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tengine.describe()
